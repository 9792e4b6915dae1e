"""Box IoUs (counterpart of ``orienmask_tpu/ops/boxes.py``)."""

import torch


def bbox_ious(bbox1, bbox2):
    """Pairwise IoU of (..., n1, 4) vs (..., n2, 4) cxcywh boxes -> (..., n1, n2),
    with JAX ``bbox_ious``'s operations in its order."""
    b1xy, b1wh = bbox1[..., 0:2], bbox1[..., 2:4]
    b2xy, b2wh = bbox2[..., 0:2], bbox2[..., 2:4]
    b1lo = (b1xy - b1wh / 2)[..., :, None, :]
    b1hi = (b1xy + b1wh / 2)[..., :, None, :]
    b2lo = (b2xy - b2wh / 2)[..., None, :, :]
    b2hi = (b2xy + b2wh / 2)[..., None, :, :]
    d = (torch.minimum(b1hi, b2hi) - torch.maximum(b1lo, b2lo)).clamp(min=0)
    inter = d[..., 0] * d[..., 1]
    area1 = (b1wh[..., 0] * b1wh[..., 1])[..., :, None]
    area2 = (b2wh[..., 0] * b2wh[..., 1])[..., None, :]
    return inter / (area1 + area2 - inter)


def anchor_ious(wh1, wh2):
    """IoU of width/height-only boxes anchored at a shared corner:
    (..., n1, 2) x (n2, 2) -> (..., n1, n2), JAX ``anchor_ious``'s order."""
    inter = torch.minimum(wh1[..., :, None, 0], wh2[:, 0]) * torch.minimum(
        wh1[..., :, None, 1], wh2[:, 1])
    area1 = (wh1[..., 0] * wh1[..., 1])[..., :, None]
    area2 = wh2[:, 0] * wh2[:, 1]
    return inter / (area1 + area2 - inter)
