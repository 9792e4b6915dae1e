"""Orientation-mask assembly (counterparts of the three kernels of
``orienmask_tpu/ops/pallas_masks.py``).

For detection k on anchor a, pixel (k, y, x) is set when
``|fx[a,y,x] * (aw * 0.5) + x * (1/W) - cx| < t * w`` and
``|fy[a,y,x] * (ah * 0.5) + (y + row0) * (1/coord_h) - cy| < t * h``.
``1/W`` and ``1/coord_h`` are rounded to f32 first and multiplied in, as the
TPU kernels do (not ``x / W``: at W=544 the two differ by one ulp in 31
columns).

* ``assemble_masks_packed`` (``assemble_masks_anchor_resident``, kernel 2):
  (aw, ah) is row a of a per-anchor table; packed 8 columns per byte, MSB
  first.  The main path's mask assembly.
* ``assemble_masks`` (``assemble_masks``, kernel 3): (aw, ah) is each
  detection's own anchor size; unpacked (B, K, H, W) uint8 in {0, 1}.
* ``assemble_masks_bitpacked`` (``assemble_masks_bitpacked``, kernel 4):
  kernel 3's inputs, packed as kernel 2 packs.

Each ``*_plain`` function is the same expressions, op by op, in torch.  The
wrappers take the plain version for a CPU tensor; for a CUDA tensor they
launch the kernel of ``csrc/masks.cu`` or raise.  All three need W % 8 == 0,
as the TPU kernels assert.  Zero-sized (padded) detections and detections
whose anchor index is off the table give empty masks; masking by validity
stays with the caller.
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


def assemble_masks_plain(field, boxes, anchor_wh, anchor_idx, orien_thresh=0.3,
                         coord_h=None):
    b, a, _, h, w = field.shape
    _check_width("assemble_masks", w)
    dev = field.device
    cols = torch.arange(w, device=dev).float() * _f32(1.0 / w)
    rows = torch.arange(h, device=dev).float() * _f32(1.0 / (coord_h or h))
    on_table = (anchor_idx >= 0) & (anchor_idx < a)
    sel = anchor_idx.long().clamp(0, a - 1)
    f = field[torch.arange(b, device=dev)[:, None], sel]  # (B, K, 2, H, W)
    half = anchor_wh * 0.5
    gx = f[:, :, 0] * half[..., 0, None, None] + cols
    gy = f[:, :, 1] * half[..., 1, None, None] + rows[:, None]
    t = _f32(orien_thresh)
    cx, cy = boxes[..., 0, None, None], boxes[..., 1, None, None]
    tx, ty = (boxes[..., 2] * t)[..., None, None], (boxes[..., 3] * t)[..., None, None]
    m = ((gx - cx).abs() < tx) & ((gy - cy).abs() < ty) & on_table[..., None, None]
    return m.to(torch.uint8)


def assemble_masks_bitpacked_plain(field, boxes, anchor_wh, anchor_idx, orien_thresh=0.3,
                                   coord_h=None):
    return pack_bits(assemble_masks_plain(field, boxes, anchor_wh, anchor_idx,
                                          orien_thresh, coord_h).bool())


def _check_width(name, w):
    if w % 8:
        raise ValueError(f"{name}: W must be a multiple of 8, as the TPU kernel "
                         f"asserts (W={w})")


def _check_kernel_args(name, field, checks):
    """Raise unless ``field`` lies on the card and every (tensor, dtype,
    shape) of ``checks`` is contiguous there, W % 8 == 0 and the field is
    16-byte aligned (its rows are read as float4)."""
    if field.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {field.device}")
    for t, dtype, shape in checks:
        if t.device != field.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} {shape} on "
                             f"{field.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    _check_width(name, field.shape[-1])
    if field.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned field")


def _per_detection(name, fn, field, boxes, anchor_wh, anchor_idx, orien_thresh, coord_h,
                   out_w):
    """Launch per-detection kernel ``fn`` (kernel 3 or 4) -> (B, K, H, out_w)."""
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    _check_kernel_args(name, field, [
        (field, torch.float32, (b, a, 2, h, w)),
        (boxes, torch.float32, (b, k, 4)),
        (anchor_wh, torch.float32, (b, k, 2)),
        (anchor_idx, torch.int32, (b, k)),
    ])
    out = torch.empty((b, k, h, out_w), dtype=torch.uint8, device=field.device)
    if b and k and h:
        kernels.launch("masks", fn, field.data_ptr(), boxes.data_ptr(), anchor_wh.data_ptr(),
                       anchor_idx.data_ptr(), out.data_ptr(), b, a, h, w, k, orien_thresh,
                       _f32(1.0 / w), _f32(1.0 / (coord_h or h)))
        kernels.launches[name] += 1
    return out


def assemble_masks(field, boxes, anchor_wh, anchor_idx, orien_thresh=0.3, coord_h=None):
    """field (B, A, 2, H, W) f32, boxes (B, K, 4) normalized cxcywh,
    anchor_wh (B, K, 2) each detection's normalized anchor size, anchor_idx
    (B, K) int32 -> (B, K, H, W) uint8 masks in {0, 1}.  ``coord_h``: the
    height that normalizes the row coordinate (default H)."""
    if field.device.type == "cpu":
        return assemble_masks_plain(field, boxes, anchor_wh, anchor_idx, orien_thresh,
                                    coord_h)
    return _per_detection("assemble_masks", "omt_assemble_masks", field, boxes, anchor_wh,
                          anchor_idx, orien_thresh, coord_h, field.shape[-1])


def assemble_masks_bitpacked(field, boxes, anchor_wh, anchor_idx, orien_thresh=0.3,
                             coord_h=None):
    """``assemble_masks``'s inputs -> (B, K, H, W/8) uint8, packed MSB first."""
    if field.device.type == "cpu":
        return assemble_masks_bitpacked_plain(field, boxes, anchor_wh, anchor_idx,
                                              orien_thresh, coord_h)
    return _per_detection("assemble_masks_bitpacked", "omt_assemble_masks_bitpacked", field,
                          boxes, anchor_wh, anchor_idx, orien_thresh, coord_h,
                          field.shape[-1] // 8)


def assemble_masks_packed(field, boxes, anchor_idx, anchor_table,
                          orien_thresh=0.3, coord_h=None, row0=0):
    """field (B, A, 2, H, W) f32, boxes (B, K, 4) normalized cxcywh,
    anchor_idx (B, K) int32, anchor_table (A, 2) normalized anchor sizes
    -> (B, K, H, W/8) uint8.  ``coord_h``/``row0``: the global image height
    and the field's first global row, for a row block of a taller image."""
    if field.device.type == "cpu":
        return assemble_masks_packed_plain(field, boxes, anchor_idx, anchor_table,
                                           orien_thresh, coord_h, row0)
    b, a, two, h, w = field.shape
    k = boxes.shape[1]
    _check_kernel_args("assemble_masks_packed", field, [
        (field, torch.float32, (b, a, 2, h, w)),
        (boxes, torch.float32, (b, k, 4)),
        (anchor_idx, torch.int32, (b, k)),
        (anchor_table, torch.float32, (a, 2)),
    ])
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
