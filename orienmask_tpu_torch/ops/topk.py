"""Exact top-k over the rows of a (B, P) f32 matrix (counterpart of
``orienmask_tpu/ops/pallas_topk.py::exact_topk``).

Contract: values descending, ties to the lower index (``lax.top_k``'s order,
and that of a stable descending sort).  Inputs hold no NaN: the detect stage
feeds sigmoid products and the -1.0 below-threshold sentinel.

* ``exact_topk_plain``: ``torch.sort(descending=True, stable=True)``, the
  spec.  ``torch.topk`` promises no order among ties and is not used.
* ``exact_topk``: the wrapper.  A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel of ``csrc/topk.cu`` or raises.  A row longer
  than one launch takes (``MAX_P``) goes through ``exact_topk_split``: the
  exact selection's rows (18207 x 80 = 1,456,560 pairs) take two launches.
"""

import torch
import torch.nn.functional as F

from .. import kernels

# The kernel's limits, which omt_exact_topk also checks: k winners sort in
# one block, and the selection scan carries its two counts in 16 bits each.
# The row's keys must also fit in shared memory next to the winners (about
# 56000 keys at k = 1024); the launch reports it when they do not.
MAX_K = 1024
MAX_P = 65535
# Level-1 chunk of a split row: its keys fit in shared memory beside any
# k <= MAX_K winners.
CHUNK = 32768


def exact_topk_plain(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def exact_topk_split(x, k, row_topk):
    """Exact top-k of (B, P) rows in two levels of ``row_topk`` (the
    argument of JAX ``_topk_split``, postprocess.py:173-192): the rows are
    cut into contiguous chunks of ``CHUNK`` keys, the last padded with -inf;
    one ``row_topk`` over the (B * chunks, chunk) matrix keeps each chunk's
    top k; one more over the (B, chunks * k) winners, in chunk order, picks
    the row's top k.  Every element of the row's top k is in its own chunk's
    top k, and among equal values the winners sit in global index order
    (chunk order, then each chunk's list, index-ascending among ties), so
    the result equals one top-k of the row, ties to the lower index.  A pad
    is never picked: it has the lowest value and a higher index than any of
    the P >= k real keys."""
    b, p = x.shape
    n = -(-p // CHUNK)
    kk = min(k, CHUNK)
    padded = F.pad(x, (0, n * CHUNK - p), value=float("-inf"))
    v1, i1 = row_topk(padded.view(b * n, CHUNK), kk)
    base = torch.arange(0, n * CHUNK, CHUNK, device=x.device)[:, None]
    idx = (i1.reshape(b, n, kk) + base).reshape(b, n * kk)
    v2, j = row_topk(v1.reshape(b, n * kk), k)
    return v2, torch.gather(idx, 1, j)


def _exact_topk_cuda(x, k):
    b, p = x.shape
    if p > MAX_P:
        return exact_topk_split(x, k, _exact_topk_cuda)
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=x.device)
    if b:
        kernels.launch("topk", "omt_exact_topk", x.data_ptr(), vals.data_ptr(),
                       idx.data_ptr(), b, p, k)
        kernels.launches["exact_topk"] += 1
    return vals, idx


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
    return _exact_topk_cuda(x, k)
