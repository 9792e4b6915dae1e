"""Exact top-k over the rows of a (B, P) f32 matrix (counterpart of
``orienmask_tpu/ops/pallas_topk.py::exact_topk``).

Contract: values descending, ties to the lower index (``lax.top_k``'s order,
and that of a stable descending sort).  Inputs hold no NaN: the detect stage
feeds sigmoid products and the -1.0 below-threshold sentinel.

* ``exact_topk_plain``: ``torch.sort(descending=True, stable=True)``, the
  spec.  ``torch.topk`` promises no order among ties and is not used.
* ``exact_topk``: the wrapper.  A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel of ``csrc/topk.cu`` or raises.
"""

import torch

from .. import kernels

# The kernel's limits, which omt_exact_topk also checks: k winners sort in
# one block, and the selection scan carries its two counts in 16 bits each.
# The row's keys must also fit in shared memory next to the winners (about
# 56000 keys at k = 1024); the launch reports it when they do not.
MAX_K = 1024
MAX_P = 65535


def exact_topk_plain(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def exact_topk(x, k):
    """x: (B, P) f32 -> (values (B, k) f32, indices (B, k) int64)."""
    if x.device.type == "cpu":
        return exact_topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"exact_topk: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("exact_topk: x must be a contiguous (B, P) float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, p = x.shape
    if not 1 <= k <= min(p, MAX_K):
        raise ValueError(f"exact_topk: need 1 <= k <= min(P, {MAX_K}); k={k}, P={p}")
    if p > MAX_P:
        raise ValueError(f"exact_topk: P={p} exceeds the kernel's row limit {MAX_P}")
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=x.device)
    if b:
        kernels.launch("topk", "omt_exact_topk", x.data_ptr(), vals.data_ptr(),
                       idx.data_ptr(), b, p, k)
        kernels.launches["exact_topk"] += 1
    return vals, idx
