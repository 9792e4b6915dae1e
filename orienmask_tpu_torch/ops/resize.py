"""OpenCV's ``INTER_LINEAR`` resize arithmetic, bit for bit, without cv2.

``cv2.resize(src, (w, h), interpolation=INTER_LINEAR)`` of a float32 array
takes, along each axis, the source position ``(d + 0.5) * (1 / (dst / src))
- 0.5`` in double, its floor as the first source index (clamped at the
edges, where the fraction is 0) and the fraction rounded to float32; each
pass is a fused ``(b - a) * f + a``, rounded once to float32 (columns first,
then rows).

* ``resize_linear``: the numpy version of a float32 array, one channel or
  several (the visualizer's masks, the train transform's images).
* ``resize_masks_linear``: ``np.round`` of it on 0/1 masks, (n, H, W) at a
  time, with the arithmetic only where the four source pixels differ (the
  host route of ``COCOMetrics._recover_shape_segm``).
* ``resize_linear_torch``: the same arithmetic in torch on (n, H, W) float32
  with the coefficient tables given, so that it runs on the CPU and on the
  card alike; it is the plain version of kernel 6 (``ops/recover.py``).

A single-rounded float32 ``a * b + c`` is formed in float64, where the
product is exact; where the float64 sum lies exactly halfway between two
float32 values, its rounding error (TwoSum) breaks the tie a second
rounding would break to even.
"""

import numpy as np
import torch

# a float64 that lies halfway between two (normal) float32 values: its 29
# mantissa bits below float32's precision are 1 followed by zeros
_BELOW_FLOAT32 = (1 << 29) - 1
_HALFWAY = 1 << 28


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (as a fused multiply-add), numpy."""
    p = a.astype(np.float64) * b
    s = p + c
    r = s.astype(np.float32)
    tie = (s.view(np.uint64) & np.uint64(_BELOW_FLOAT32)) == np.uint64(_HALFWAY)
    if tie.any():
        pt, st = p[tie], s[tie]
        ct = np.broadcast_to(c, s.shape)[tie].astype(np.float64)
        bv = st - pt
        err = (pt - (st - bv)) + (ct - bv)
        rt = r[tie]
        lo = np.where(rt > st, np.nextafter(rt, np.float32(-np.inf)), rt)
        hi = np.where(rt > st, rt, np.nextafter(rt, np.float32(np.inf)))
        r[tie] = np.where(err > 0, hi, np.where(err < 0, lo, rt))
    return r


def fma32(a, b, c):
    """``_fma32`` in torch: float32 tensors ``a * b + c`` (broadcasting),
    rounded once to float32."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    r = s.float()
    tie = (s.view(torch.int64) & _BELOW_FLOAT32) == _HALFWAY
    if bool(tie.any()):
        pt, st, ct = p[tie], s[tie], c[tie]
        bv = st - pt
        err = (pt - (st - bv)) + (ct - bv)
        rt = r[tie]
        above = rt.double() > st
        lo = torch.where(above, torch.nextafter(rt, torch.full_like(rt, -torch.inf)), rt)
        hi = torch.where(above, rt, torch.nextafter(rt, torch.full_like(rt, torch.inf)))
        r[tie] = torch.where(err > 0, hi, torch.where(err < 0, lo, rt))
    return r


def linear_coefficients(dst, src):
    """OpenCV's INTER_LINEAR coefficients along one axis: (first source
    index, second, fraction) for each of ``dst`` outputs; int64, int64,
    float32."""
    scale = 1.0 / (dst / src)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first).astype(np.float32)
    edge = (first < 0) | (first >= src - 1)
    frac[edge] = 0
    first = np.clip(first, 0, src - 1)
    return first, np.minimum(first + 1, src - 1), frac


def resize_linear(image, width, height):
    """``cv2.resize(image, (width, height), interpolation=INTER_LINEAR)`` of a
    float32 array, (H, W) or (H, W, C) with every channel alike, bit for bit."""
    x0, x1, fx = linear_coefficients(width, image.shape[1])
    y0, y1, fy = linear_coefficients(height, image.shape[0])
    channels = (1,) * (image.ndim - 2)
    left = image[:, x0]
    rows = _fma32(image[:, x1] - left, fx.reshape(-1, *channels), left)
    top = rows[y0]
    return _fma32(rows[y1] - top, fy.reshape(-1, 1, *channels), top)


def resize_masks_linear(masks, width, height):
    """``np.round(resize_linear(m.astype(np.float32), width, height))`` of
    each of (n, H, W) 0/1 ``masks``, as uint8.  At the masks' own size cv2
    copies (so does this).  Where a pixel's four source pixels are equal
    both passes give that value exactly (``(b - a) * f + a`` with b = a), so
    only the others are computed."""
    masks = np.asarray(masks, np.uint8)
    if masks.shape[1:] == (height, width):
        return masks.copy()
    x0, x1, fx = linear_coefficients(width, masks.shape[2])
    y0, y1, fy = linear_coefficients(height, masks.shape[1])
    pair = (np.take(masks, x0, axis=2) << 1) | np.take(masks, x1, axis=2)  # (n, H, width)
    code = (np.take(pair, y0, axis=1) << 2) | np.take(pair, y1, axis=1)  # bits a b c d
    out = code >> 3
    k, i, j = np.nonzero((code != 0) & (code != 15))
    a, b, c, d = ((code[k, i, j] >> s) & 1 for s in (3, 2, 1, 0))
    a, b, c, d = (v.astype(np.float32) for v in (a, b, c, d))
    r0 = _fma32(b - a, fx[j], a)
    r1 = _fma32(d - c, fx[j], c)
    out[k, i, j] = np.round(_fma32(r1 - r0, fy[i], r0))
    return out


def resize_linear_torch(images, x, y):
    """``resize_linear`` of each of (n, H, W) float32 ``images`` in torch,
    given its tables: ``x`` = (first column, second column, fraction) of
    each output column and ``y`` the same of each output row, as
    ``linear_coefficients`` makes them (the indices may be mapped onto a
    window of the images first).  Returns (n, len(y[0]), len(x[0]))."""
    x0, x1, fx = x
    y0, y1, fy = y
    top, bottom = images[:, y0], images[:, y1]  # only the rows the output reads
    rows0 = fma32(top[:, :, x1] - top[:, :, x0], fx, top[:, :, x0])
    rows1 = fma32(bottom[:, :, x1] - bottom[:, :, x0], fx, bottom[:, :, x0])
    return fma32(rows1 - rows0, fy[:, None], rows0)
