"""Orientation-mask assembly with bit packing (counterpart of
``orienmask_tpu/ops/pallas_masks.py::assemble_masks_anchor_resident``).

For detection k on anchor a, bit (k, y, x) is set when
``|fx[a,y,x] * (aw_a * 0.5) + x * (1/W) - cx| < t * w`` and
``|fy[a,y,x] * (ah_a * 0.5) + (y + row0) * (1/coord_h) - cy| < t * h``,
packed 8 columns per byte, MSB first.  ``1/W`` and ``1/coord_h`` are rounded
to f32 first and multiplied in, as the TPU kernel does (not ``x / W``: at
W=544 the two differ by one ulp in 31 columns).

* ``assemble_masks_packed_plain``: the same expressions, op by op, in torch.
* ``assemble_masks_packed``: the wrapper.  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel of ``csrc/masks.cu`` or raises.

Zero-sized (padded) detections give empty masks; masking by validity stays
with the caller.
"""

import numpy as np
import torch

from .. import kernels
from .maskops import pack_bits

MAX_DETS = 2048
MAX_ANCHORS = 64  # per-anchor detection lists in shared memory (csrc/masks.cu)


def _f32(v):
    """A Python float holding the f32 rounding of ``v`` (exact in f32)."""
    return float(np.float32(v))


def assemble_masks_packed_plain(field, boxes, anchor_idx, anchor_table,
                                orien_thresh=0.3, coord_h=None, row0=0):
    b, a, _, h, w = field.shape
    dev = field.device
    cols = torch.arange(w, device=dev).float() * _f32(1.0 / w)
    rows = (torch.arange(h, device=dev) + row0).float() * _f32(1.0 / (coord_h or h))
    half = anchor_table * 0.5
    gx = field[:, :, 0] * half[:, 0].view(1, a, 1, 1) + cols
    gy = field[:, :, 1] * half[:, 1].view(1, a, 1, 1) + rows[:, None]
    on_table = (anchor_idx >= 0) & (anchor_idx < a)
    sel = anchor_idx.long().clamp(0, a - 1)
    batch = torch.arange(b, device=dev)[:, None]
    gxk, gyk = gx[batch, sel], gy[batch, sel]  # (B, K, H, W)
    t = _f32(orien_thresh)
    cx, cy = boxes[..., 0, None, None], boxes[..., 1, None, None]
    tx, ty = (boxes[..., 2] * t)[..., None, None], (boxes[..., 3] * t)[..., None, None]
    m = ((gxk - cx).abs() < tx) & ((gyk - cy).abs() < ty) & on_table[..., None, None]
    return pack_bits(m)


def assemble_masks_packed(field, boxes, anchor_idx, anchor_table,
                          orien_thresh=0.3, coord_h=None, row0=0):
    """field (B, A, 2, H, W) f32, boxes (B, K, 4) normalized cxcywh,
    anchor_idx (B, K) int32, anchor_table (A, 2) normalized anchor sizes
    -> (B, K, H, W/8) uint8.  ``coord_h``/``row0``: the global image height
    and the field's first global row, for a row block of a taller image."""
    if field.device.type == "cpu":
        return assemble_masks_packed_plain(field, boxes, anchor_idx, anchor_table,
                                           orien_thresh, coord_h, row0)
    if field.device.type != "cuda":
        raise ValueError(f"assemble_masks_packed: unsupported device {field.device}")
    b, a, two, h, w = field.shape
    k = boxes.shape[1]
    checks = [
        (field, torch.float32, (b, a, 2, h, w)),
        (boxes, torch.float32, (b, k, 4)),
        (anchor_idx, torch.int32, (b, k)),
        (anchor_table, torch.float32, (a, 2)),
    ]
    for t, dtype, shape in checks:
        if t.device != field.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"assemble_masks_packed: expected a contiguous {dtype} "
                             f"{shape} on {field.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if w % 8 or field.data_ptr() % 16:
        raise ValueError("assemble_masks_packed: the kernel needs W % 8 == 0 and a "
                         f"16-byte aligned field (W={w})")
    if k > MAX_DETS or a > MAX_ANCHORS:
        raise ValueError(f"assemble_masks_packed: the kernel takes K <= {MAX_DETS} and "
                         f"A <= {MAX_ANCHORS}; K={k}, A={a}")
    out = torch.empty((b, k, h, w // 8), dtype=torch.uint8, device=field.device)
    if b and k and h:
        kernels.launch("masks", "omt_assemble_masks_packed", field.data_ptr(),
                       boxes.data_ptr(), anchor_idx.data_ptr(), anchor_table.data_ptr(),
                       out.data_ptr(), b, a, h, w, k, orien_thresh,
                       _f32(1.0 / w), _f32(1.0 / (coord_h or h)), int(row0))
        kernels.launches["assemble_masks_packed"] += 1
    return out
