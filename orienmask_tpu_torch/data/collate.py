"""Static-shape batch collation (counterpart of
``orienmask_tpu/data/collate.py::collate`` and ``collate_plus``).

Every sample is padded to ``max_instances`` with a validity mask, so one
train step serves every batch.  A sample with more instances keeps its
``max_instances`` largest by box area, in their original order (the
painter's last-wins overlaps are unchanged for the kept set), and the drop
is logged.  Masks can be bit-packed, 8 pixels a byte, MSB first.
"""

import logging
import math

import numpy as np

_logger = logging.getLogger(__name__)


def collate(batch, max_instances=100, pack_masks=False, image_transport="float32"):
    """List of transformed samples -> dict of stacked numpy arrays:
    ``{'image': (B,H,W,3) f32, 'bbox': (B,N,4) f32, 'cls': (B,N) i32,
    'mask': (B,N,H,W) bool | (B,N,H,ceil(W/8)) u8, 'valid': (B,N) bool}``
    plus ``'info'``, the list of per-sample info dicts, when present.

    ``image_transport='uint8'`` sends ``round(x*255)`` as uint8 (the train
    step divides by 255 on the card); valid for a Normalize of mean 0 and
    std 255."""
    bsz = len(batch)
    image = np.stack([s["image"] for s in batch])
    if image_transport == "uint8":
        image = np.clip(np.round(image * 255.0), 0, 255).astype(np.uint8)
    h, w = image.shape[1:3]
    n = max_instances

    bbox = np.zeros((bsz, n, 4), np.float32)
    cls = np.zeros((bsz, n), np.int32)
    valid = np.zeros((bsz, n), bool)
    with_mask = "mask" in batch[0]
    if with_mask:
        masks = np.zeros((bsz, n, h, w), bool)
    for i, s in enumerate(batch):
        k = s["bbox"].shape[0]
        keep = slice(0, k)
        if k > n:
            area = s["bbox"][:, 2] * s["bbox"][:, 3]
            keep = np.sort(np.argsort(-area, kind="stable")[:n])
            _logger.warning("collate: truncated a sample from %d to %d GT instances "
                            "(kept the %d largest by area)", k, n, n)
            k = n
        bbox[i, :k] = s["bbox"][keep]
        cls[i, :k] = s["cls"][keep]
        valid[i, :k] = True
        if with_mask and k:
            masks[i, :k] = s["mask"][keep]

    out = {"image": image, "bbox": bbox, "cls": cls, "valid": valid}
    if with_mask:
        out["mask"] = np.packbits(masks, axis=-1) if pack_masks else masks
    if "info" in batch[0]:
        out["info"] = [s["info"] for s in batch]
    return out


def collate_plus(batch, max_instances=100, pack_masks=False, size_divisor=32, pad_value=0.0):
    """Pads every image of the batch to one shape, each side a multiple of
    ``size_divisor``, centred, moving the normalized boxes with it and
    recording ``info['collate_pad']`` = (left, right, top, down, H, W); then
    ``collate``.  The samples are padded in place."""
    max_h = int(math.ceil(max(s["image"].shape[0] for s in batch) / size_divisor) * size_divisor)
    max_w = int(math.ceil(max(s["image"].shape[1] for s in batch) / size_divisor) * size_divisor)
    for s in batch:
        h, w = s["image"].shape[:2]
        left, top = (max_w - w) // 2, (max_h - h) // 2
        right, down = max_w - w - left, max_h - h - top
        s["image"] = np.pad(s["image"], ((top, down), (left, right), (0, 0)),
                            constant_values=pad_value)
        bb = s["bbox"]
        if bb.shape[0]:
            bb[:, 0] = (bb[:, 0] * w + left) / max_w
            bb[:, 1] = (bb[:, 1] * h + top) / max_h
            bb[:, 2] = bb[:, 2] * w / max_w
            bb[:, 3] = bb[:, 3] * h / max_h
        if "mask" in s and len(s["mask"]):
            s["mask"] = np.pad(s["mask"], ((0, 0), (top, down), (left, right)))
        if "info" in s:
            s["info"]["collate_pad"] = (left, right, top, down, max_h, max_w)
    return collate(batch, max_instances, pack_masks)
