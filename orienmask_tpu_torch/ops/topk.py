"""Exact top-k over the rows of a (B, P) f32 matrix (counterpart of
``orienmask_tpu/ops/pallas_topk.py::exact_topk``).

Contract: values descending, ties to the lower index (``lax.top_k``'s order,
and that of a stable descending sort).  Inputs hold no NaN: the detect stage
feeds sigmoid products and the -1.0 below-threshold sentinel.

* ``exact_topk_plain``: ``torch.sort(descending=True, stable=True)``, the
  spec.  ``torch.topk`` promises no order among ties and is not used.
* ``exact_topk``: the wrapper, a call of the custom operator
  ``omt::exact_topk`` (``kernels/ops.py``).  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel of ``csrc/topk.cu``
  (``exact_topk_cuda``) or raises.  ``launch_plan`` says how: a row over a
  cluster of C CTAs, or, for a row longer than one launch takes
  (``MAX_P``), ``exact_topk_split``: the exact selection's rows (18207 x 80
  = 1,456,560 pairs) take two launches.
"""

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import ops as kernel_ops

# The kernel's limits, which omt_exact_topk also checks: k winners rank in
# one CTA's shared memory; a CTA holds KEYS_PER_CTA keys in registers (512
# threads, 16 each), and a cluster takes up to MAX_CLUSTER CTAs (8, the
# portable cluster size).
MAX_K = 1024
KEYS_PER_CTA = 8192
MAX_CLUSTER = 8
MAX_P = MAX_CLUSTER * KEYS_PER_CTA
# The longest level-1 chunk of a split row: one launch takes it at any
# k <= MAX_K.
CHUNK = 32768
# SMs of an H100 SXM: few rows spread over clusters until the grid fills them.
SMS = 132


def split_chunk(p):
    """The chunk length of a row of ``p`` keys: as even as the fewest chunks
    of at most ``CHUNK`` keys allow (the exact selection's 1,456,560 keys
    are 45 chunks of 32,368, with no padding)."""
    n = -(-p // CHUNK)
    return -(-p // n)


def launch_plan(b, p):
    """(C, chunk) for (b, p) rows, from the shape alone.

    A row longer than ``MAX_P`` is cut into chunks (``exact_topk_split``,
    ``split_chunk``), and each level then has a plan of its own: the result
    is (None, chunk).  Otherwise the result is (C, None), C the CTAs of the
    cluster that takes one row: at least enough to hold the row's keys, and,
    for few rows, up to ``MAX_CLUSTER`` while the grid of b * C CTAs stays
    within one CTA an SM.  So the main path's single rows and the exact
    selection's 16 level-2 rows take clusters of 8, and its 720 level-1 rows
    of 32,368 keys the 4 CTAs that hold them."""
    if p > MAX_P:
        return None, split_chunk(p)
    fit = -(-p // KEYS_PER_CTA)
    return max(fit, min(MAX_CLUSTER, SMS // max(b, 1))), None


def exact_topk_plain(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def exact_topk_split(x, k, row_topk):
    """Exact top-k of (B, P) rows in two levels of ``row_topk`` (the
    argument of JAX ``_topk_split``, postprocess.py:173-192): the rows are
    cut into n contiguous chunks of ``split_chunk(P)`` keys, the last padded
    with -inf (a copy, skipped when the chunks fill the row exactly);
    one ``row_topk`` over the (B * n, chunk) matrix keeps each chunk's
    top k; one more over the (B, chunks * k) winners, in chunk order, picks
    the row's top k.  Every element of the row's top k is in its own chunk's
    top k, and among equal values the winners sit in global index order
    (chunk order, then each chunk's list, index-ascending among ties), so
    the result equals one top-k of the row, ties to the lower index.  A pad
    is never picked: it has the lowest value and a higher index than any of
    the P >= k real keys."""
    b, p = x.shape
    chunk = split_chunk(p)
    n = -(-p // chunk)
    kk = min(k, chunk)
    padded = x if n * chunk == p else F.pad(x, (0, n * chunk - p), value=float("-inf"))
    v1, i1 = row_topk(padded.view(b * n, chunk), kk)
    base = torch.arange(0, n * chunk, chunk, device=x.device)[:, None]
    idx = (i1.reshape(b, n, kk) + base).reshape(b, n * kk)
    v2, j = row_topk(v1.reshape(b, n * kk), k)
    return v2, torch.gather(idx, 1, j)


def exact_topk_cuda(x, k):
    """Kernel 1 on the card (the CUDA implementation of ``omt::exact_topk``)."""
    b, p = x.shape
    c, chunk = launch_plan(b, p)
    if chunk:
        return exact_topk_split(x, k, exact_topk_cuda)
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int64, device=x.device)
    if b:
        kernels.launch("topk", "omt_exact_topk", x.data_ptr(), vals.data_ptr(),
                       idx.data_ptr(), b, p, k, c)
        kernels.launches["exact_topk"] += 1
    return vals, idx


def check_topk_args(x, k):
    """Raise unless kernel 1 takes ``x`` and ``k``."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("exact_topk: x must be a contiguous (B, P) float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, p = x.shape
    if not 1 <= k <= min(p, MAX_K):
        raise ValueError(f"exact_topk: need 1 <= k <= min(P, {MAX_K}); k={k}, P={p}")


def exact_topk(x, k):
    """x: (B, P) f32 -> (values (B, k) f32, indices (B, k) int64)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"exact_topk: unsupported device {x.device}")
    return kernel_ops.exact_topk(x, k)
