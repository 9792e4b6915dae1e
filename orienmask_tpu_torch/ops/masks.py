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
launch the kernel of ``csrc/masks.cu`` or raise.  Kernel 2's wrapper does
so as the custom operator ``omt::assemble_masks_packed``
(``kernels/ops.py``), which ``torch.export`` traces.  All three need W % 8 == 0,
as the TPU kernels assert.  Zero-sized (padded) detections and detections
whose anchor index is off the table give empty masks; kernel 2 also takes
the detections' validity and gives an invalid detection an empty mask.
"""

import numpy as np
import torch

from .. import kernels
from ..kernels import ops as kernel_ops
from .maskops import pack_bits

# kernel 2's limits (csrc/masks.cu); kernels 3 and 4 take any K and A
MAX_DETS = 2048  # detections an image in shared memory
MAX_ANCHORS = 64  # the used anchors are one 64-bit mask


def _f32(v):
    """A Python float holding the f32 rounding of ``v`` (exact in f32)."""
    return float(np.float32(v))


def _sample_positions(field, anchor_table, coord_h=None, row0=0):
    """Per anchor, each pixel's sample positions (gx, gy), each (B, A, H, W)."""
    b, a, _, h, w = field.shape
    dev = field.device
    cols = torch.arange(w, device=dev).float() * _f32(1.0 / w)
    rows = (torch.arange(h, device=dev) + row0).float() * _f32(1.0 / (coord_h or h))
    half = anchor_table * 0.5
    gx = field[:, :, 0] * half[:, 0].view(1, a, 1, 1) + cols
    gy = field[:, :, 1] * half[:, 1].view(1, a, 1, 1) + rows[:, None]
    return gx, gy


def _per_detection_boxes(boxes, orien_thresh):
    """(centre (B, K, 2), t * sides (B, K, 2)) as the kernel rounds them."""
    return boxes[..., :2], boxes[..., 2:4] * _f32(orien_thresh)


def _on_table(anchor_idx, a, valid):
    """(B, K) bool: the detections the kernel evaluates (valid, anchor on
    the table), and their anchors clamped onto the table."""
    keep = (anchor_idx >= 0) & (anchor_idx < a)
    if valid is not None:
        keep = keep & valid
    return keep, anchor_idx.long().clamp(0, a - 1)


def assemble_masks_packed_plain(field, boxes, anchor_idx, anchor_table,
                                orien_thresh=0.3, coord_h=None, row0=0, valid=None):
    b, a = field.shape[:2]
    gx, gy = _sample_positions(field, anchor_table, coord_h, row0)
    keep, sel = _on_table(anchor_idx, a, valid)
    batch = torch.arange(b, device=field.device)[:, None]
    gxk, gyk = gx[batch, sel], gy[batch, sel]  # (B, K, H, W)
    c, tb = _per_detection_boxes(boxes, orien_thresh)
    m = ((gxk - c[..., 0, None, None]).abs() < tb[..., 0, None, None]) \
        & ((gyk - c[..., 1, None, None]).abs() < tb[..., 1, None, None]) & keep[..., None, None]
    return pack_bits(m)


# The tile culling of kernels 2, 3 and 4 (csrc/masks.cu), op by op, for the
# tests and for counting a call's tile classes: a tile is one row by TILE_W
# columns, two bytes of the packed output.
TILE_W = 16
ALL_OUT, ALL_IN, MIXED, EMPTY = 0, 1, 2, -1


def field_bounds(fx, fy):
    """Bounds of tiles of values (..., n): ((x min, x max, y min, y max),
    (any x NaN, any y NaN)), each (...).  A min or max ignores NaN (NaN
    only when every value is)."""
    def reduce(g, fn, neutral):
        nan = torch.isnan(g)
        out = fn(torch.where(nan, neutral, g), dim=-1)
        return torch.where(nan.all(-1), torch.nan, out)

    return ((reduce(fx, torch.amin, torch.inf), reduce(fx, torch.amax, -torch.inf),
             reduce(fy, torch.amin, torch.inf), reduce(fy, torch.amax, -torch.inf)),
            (torch.isnan(fx).any(-1), torch.isnan(fy).any(-1)))


def tile_bounds(gx, gy):
    """Kernel 2's bounds of tiles of sample positions (..., n): (gx min,
    gx max, gy min, gy max), each (...), NaN ignored; gx max is NaN where
    any pixel's gx or gy is NaN, which refuses all in."""
    (xlo, xhi, ylo, yhi), (nan_x, nan_y) = field_bounds(gx, gy)
    return xlo, torch.where(nan_x | nan_y, torch.nan, xhi), ylo, yhi


def position_bounds(lims, nan, s, col0, col1, row):
    """Kernels 3 and 4's bounds of a tile's sample positions for half
    anchor sizes ``s`` = (sx, sy), from the bounds ``lims`` and NaN flags
    ``nan`` of its field values (``field_bounds``) and its first and last
    column coordinates and its row coordinate: (gx min, gx max, gy min,
    gy max) with gx min = fl(fl(fx min * sx) + col0) and gx max =
    fl(fl(fx max * sx) + col1), min and max swapped for s < 0 (round-to-
    nearest multiply and add are monotone in each argument).  An axis's max
    is NaN where its plane holds a NaN, which refuses that axis all in."""
    fxlo, fxhi, fylo, fyhi = lims
    nx, ny = s[0] < 0, s[1] < 0
    xhi = torch.where(nx, fxlo, fxhi) * s[0] + col1
    yhi = torch.where(ny, fylo, fyhi) * s[1] + row
    return (torch.where(nx, fxhi, fxlo) * s[0] + col0, torch.where(nan[0], torch.nan, xhi),
            torch.where(ny, fyhi, fylo) * s[1] + row, torch.where(nan[1], torch.nan, yhi))


def classify_tiles(bounds, c, tb):
    """The kernel's class of (tile, detection) pairs, int8: ALL_OUT, ALL_IN
    or MIXED.  ``bounds`` from ``tile_bounds``; ``c`` = (cx, cy) and ``tb``
    = (t*w, t*h), each a pair of tensors broadcasting against the bounds.
    Per axis, dlo = fl(gmin - c) and dhi = fl(gmax - c); all out if, in
    either axis, dhi <= -tb or dlo >= tb; all in if, in both, -tb < dlo and
    dhi < tb."""
    xlo, xhi, ylo, yhi = bounds
    dlx, dhx, dly, dhy = xlo - c[0], xhi - c[0], ylo - c[1], yhi - c[1]
    out = (dhx <= -tb[0]) | (dlx >= tb[0]) | (dhy <= -tb[1]) | (dly >= tb[1])
    inside = (-tb[0] < dlx) & (dhx < tb[0]) & (-tb[1] < dly) & (dhy < tb[1])
    return torch.where(out, ALL_OUT, torch.where(inside, ALL_IN, MIXED)).to(torch.int8)


def tile_classes(field, boxes, anchor_idx, anchor_table, orien_thresh=0.3, coord_h=None,
                 row0=0, valid=None):
    """Each (detection, tile)'s class in kernel 2 for these inputs: (B, K,
    H, ceil(W/TILE_W)) int8, EMPTY for a detection written as zeros without
    a predicate (invalid, or its anchor off the table)."""
    b, a, _, h, w = field.shape
    gx, gy = _sample_positions(field, anchor_table, coord_h, row0)
    pad = -w % TILE_W  # the last tile of a row: past W is no pixel, as the edge
    gx, gy = (torch.nn.functional.pad(g.reshape(b * a, h, w), (0, pad), mode="replicate")
              .reshape(b, a, h, -1, TILE_W) for g in (gx, gy))
    keep, sel = _on_table(anchor_idx, a, valid)
    batch = torch.arange(b, device=field.device)[:, None]
    bounds = [t[batch, sel] for t in tile_bounds(gx, gy)]  # (B, K, H, nw)
    c, tb = _per_detection_boxes(boxes, orien_thresh)
    cls = classify_tiles(bounds, (c[..., 0, None, None], c[..., 1, None, None]),
                         (tb[..., 0, None, None], tb[..., 1, None, None]))
    return torch.where(keep[..., None, None], cls, EMPTY).to(torch.int8)


def tile_classes_per_detection(field, boxes, anchor_wh, anchor_idx, orien_thresh=0.3,
                               coord_h=None):
    """Each (detection, tile)'s class in kernels 3 and 4 for these inputs:
    (B, K, H, ceil(W/TILE_W)) int8, EMPTY for a detection whose anchor is
    off the table.  The tile's field bounds come from its anchor's field,
    the position bounds from the detection's own anchor size
    (``position_bounds``), the class from ``classify_tiles``."""
    b, a, _, h, w = field.shape
    nw = -(-w // TILE_W)
    # the last tile of a row: past W is no pixel, as the edge
    f = torch.nn.functional.pad(field.reshape(b * a * 2, h, w), (0, nw * TILE_W - w),
                                mode="replicate").reshape(b, a, 2, h, nw, TILE_W)
    lims, nan = field_bounds(f[:, :, 0], f[:, :, 1])  # (B, A, H, nw)
    keep, sel = _on_table(anchor_idx, a, None)
    batch = torch.arange(b, device=field.device)[:, None]
    lims, nan = [t[batch, sel] for t in lims], [t[batch, sel] for t in nan]  # (B, K, H, nw)
    dev = field.device
    cols = torch.arange(w, device=dev).float() * _f32(1.0 / w)
    last = (torch.arange(nw, device=dev) * TILE_W + TILE_W - 1).clamp(max=w - 1)
    row = (torch.arange(h, device=dev).float() * _f32(1.0 / (coord_h or h)))[:, None]
    half = anchor_wh * 0.5
    bounds = position_bounds(lims, nan, (half[..., 0, None, None], half[..., 1, None, None]),
                             cols[::TILE_W], cols[last], row)
    c, tb = _per_detection_boxes(boxes, orien_thresh)
    cls = classify_tiles(bounds, (c[..., 0, None, None], c[..., 1, None, None]),
                         (tb[..., 0, None, None], tb[..., 1, None, None]))
    return torch.where(keep[..., None, None], cls, EMPTY).to(torch.int8)


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


def assemble_masks_packed_cuda(field, boxes, anchor_idx, anchor_table, orien_thresh=0.3,
                               coord_h=None, row0=0, valid=None):
    """Kernel 2 on the card (the CUDA implementation of
    ``omt::assemble_masks_packed``)."""
    b, a, two, h, w = field.shape
    k = boxes.shape[1]
    checks = [
        (field, torch.float32, (b, a, 2, h, w)),
        (boxes, torch.float32, (b, k, 4)),
        (anchor_idx, torch.int32, (b, k)),
        (anchor_table, torch.float32, (a, 2)),
    ]
    if valid is not None:
        checks.append((valid, torch.bool, (b, k)))
    _check_kernel_args("assemble_masks_packed", field, checks)
    if k > MAX_DETS or a > MAX_ANCHORS:
        raise ValueError(f"assemble_masks_packed: the kernel takes K <= {MAX_DETS} and "
                         f"A <= {MAX_ANCHORS}; K={k}, A={a}")
    out = torch.empty((b, k, h, w // 8), dtype=torch.uint8, device=field.device)
    if b and k and h:
        kernels.launch("masks", "omt_assemble_masks_packed", field.data_ptr(),
                       boxes.data_ptr(), anchor_idx.data_ptr(), anchor_table.data_ptr(),
                       None if valid is None else valid.data_ptr(), out.data_ptr(),
                       b, a, h, w, k, orien_thresh,
                       _f32(1.0 / w), _f32(1.0 / (coord_h or h)), int(row0))
        kernels.launches["assemble_masks_packed"] += 1
    return out


def assemble_masks_packed(field, boxes, anchor_idx, anchor_table,
                          orien_thresh=0.3, coord_h=None, row0=0, valid=None):
    """field (B, A, 2, H, W) f32, boxes (B, K, 4) normalized cxcywh,
    anchor_idx (B, K) int32, anchor_table (A, 2) normalized anchor sizes
    -> (B, K, H, W/8) uint8.  ``coord_h``/``row0``: the global image height
    and the field's first global row, for a row block of a taller image.
    ``valid`` (B, K) bool, or None for all valid: an invalid detection gets
    an empty mask.  A call of the custom operator
    ``omt::assemble_masks_packed`` (``kernels/ops.py``)."""
    if field.device.type not in ("cpu", "cuda"):
        raise ValueError(f"assemble_masks_packed: unsupported device {field.device}")
    return kernel_ops.assemble_masks_packed(field, boxes, anchor_idx, anchor_table,
                                            float(orien_thresh), coord_h, int(row0), valid)
