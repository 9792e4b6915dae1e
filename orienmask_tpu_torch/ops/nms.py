"""Greedy class NMS as a suppression-closure fixpoint (counterpart of
``orienmask_tpu/ops/nms.py``), with the batch dimension written out.

In descending-score order the greedy kept set satisfies
``kept[j] = not any(i < j, kept[i], IoU(i, j) >= t)``; iterating that
recurrence from ``kept = valid`` reaches the unique greedy solution.  JAX runs
it in a ``while_loop``; here a ``torch.while_loop`` runs chunks of
``ROUND_CHUNK`` rounds until a chunk's last round changes nothing.  Traced
(``torch.export``), the loop is the ``while_loop`` operator of the exported
graph; eager, the same body runs in a Python loop with one convergence
check (one host sync) after each chunk.  A round past the fixpoint changes
nothing, so the result is exactly the fixpoint.
"""

import torch

from .boxes import bbox_ious

NEG_INF = -1e30
ROUND_CHUNK = 8


def greedy_nms_fixpoint(boxes, scores, n_keep, iou_threshold=0.5):
    """boxes (B, n, 4) cxcywh, scores (B, n) ALREADY in descending order
    (JAX ``presorted=True``; invalid candidates carry ``NEG_INF``).
    Returns (keep_idx (B, n_keep) int64, keep_valid (B, n_keep) bool): the
    top ``n_keep`` survivors in descending score order."""
    n = scores.shape[-1]
    svalid = scores > NEG_INF / 2
    iou = bbox_ious(boxes, boxes)
    row = torch.arange(n, device=scores.device)
    # suppress[b, i, j]: higher-ranked valid i can suppress j
    suppress = (iou >= iou_threshold) & (row[:, None] < row[None, :]) \
        & svalid[:, :, None] & svalid[:, None, :]
    suppress_f = suppress.float()

    kept = _fixpoint(svalid, suppress_f)

    ranked = torch.where(kept, -row, -(n + row))  # kept first, by ascending rank
    top = torch.sort(ranked, dim=-1, descending=True, stable=True)[1][:, :n_keep]
    return top, torch.gather(kept, 1, top)


def _fixpoint(svalid, suppress_f):
    """The kept set: chunks of ``ROUND_CHUNK`` rounds of the recurrence from
    ``kept = svalid`` until a chunk's last round changes nothing."""
    def cond(kept, changed):
        return changed.clone()  # a loop's condition may not alias what it carries

    def body(kept, changed):
        for _ in range(ROUND_CHUNK):
            prev = kept
            dominated = torch.bmm(kept.float()[:, None, :], suppress_f)[:, 0] > 0
            kept = svalid & ~dominated
        return kept, (kept != prev).any()

    if torch.compiler.is_compiling():
        changed = torch.ones((), dtype=torch.bool, device=svalid.device)
        return torch.while_loop(cond, body, (svalid.clone(), changed))[0]
    kept, changed = svalid, True
    while changed:
        kept, changed = body(kept, changed)
    return kept


def batched_class_nms(boxes, scores, classes, n_keep, iou_threshold=0.5):
    """Class-wise greedy NMS on normalized boxes: each class is shifted by
    ``cls * 2.0`` (max coordinate 1.5 + 0.5) so one class-agnostic pass
    suppresses only within-class overlaps.  ``scores`` must be descending."""
    offsets = classes.to(boxes.dtype)[..., None] * 2.0
    shifted = torch.cat([boxes[..., :2] + offsets, boxes[..., 2:4]], dim=-1)
    return greedy_nms_fixpoint(shifted, scores, n_keep, iou_threshold)
