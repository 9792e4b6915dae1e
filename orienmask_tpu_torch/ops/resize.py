"""OpenCV's resize arithmetic without cv2: ``INTER_LINEAR`` bit for bit,
and the train transform's ``INTER_AREA``, ``INTER_CUBIC`` and
``INTER_LANCZOS4`` of float32 images (``resize_area``, ``resize_cubic``,
``resize_lanczos4``; see each for how close it comes).

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

import math

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


# -------------------------------------------------- area, cubic, lanczos4


def _channels(image):
    return (1,) * (image.ndim - 2)


def _position(dst, src):
    """OpenCV's source position of each output index as cv::resize forms it
    for cubic and lanczos4: ``(float)((d + 0.5) * scale - 0.5)``, its floor,
    and the float32 fraction."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    first = np.floor(pos)
    return first.astype(np.int64), (pos - first).astype(np.float32)


def _taps(first, n, src):
    """Indices ``first - n // 2 + 1 .. first + n // 2`` of each output,
    clamped to the source (OpenCV's replicated border)."""
    return np.clip(first[:, None] + np.arange(1 - n // 2, n // 2 + 1), 0, src - 1)


def _sum_sequential(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _sum_nested(terms):
    """``t0 + (t1 + (... + t7))``: the order of OpenCV's vector loops."""
    acc = terms[-1]
    for t in terms[-2::-1]:
        acc = t + acc
    return acc


def _cubic_weights(dst, src, exact_position):
    """The four A = -0.75 weights of each output and their clamped source
    indices.  ``exact_position``: the fraction in float64 and the weights
    evaluated in float64, then rounded (as near as numpy comes to the IPP
    cubic cv2 runs on float32 images of 1, 3 or 4 channels); else
    OpenCV's own ``interpolateCubic`` in float32 on its float32 fraction."""
    if exact_position:
        pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
        first = np.floor(pos)
        x = pos - first
        first = first.astype(np.int64)
        a, one = -0.75, 1.0
    else:
        first, x = _position(dst, src)
        a, one = np.float32(-0.75), np.float32(1)
    w0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + one
    w2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    weights = np.stack([w0, w1, w2, one - w0 - w1 - w2], axis=1).astype(np.float32)
    return _taps(first, 4, src), weights


def resize_cubic(image, width, height):
    """``cv2.resize(image, (width, height), interpolation=INTER_CUBIC)`` of a
    float32 array, (H, W) or (H, W, C).  cv2 hands float32 images of 1, 3
    or 4 channels to IPP, whose arithmetic numpy does not reproduce: for
    them this evaluates the same kernel (A = -0.75, replicated border) with
    float64 weights and float32 sums, columns first, and
    ``tests/test_torch_transform.py`` states the measured difference.
    Other channel counts take OpenCV's own loops, bit for bit: float32
    weights, each row's taps summed in order, the rows' in the nested order
    of its four-lane vector loop over all but the last ``W * C % 4`` values
    of a row."""
    if image.shape[:2] == (height, width):
        return image.copy()
    ch = _channels(image)
    ipp = image.ndim == 2 or image.shape[2] in (1, 3, 4)
    xi, xw = _cubic_weights(width, image.shape[1], ipp)
    yi, yw = _cubic_weights(height, image.shape[0], ipp)
    rows = _sum_sequential([image[:, xi[:, j]] * xw[:, j].reshape(-1, *ch) for j in range(4)])
    terms = [rows[yi[:, j]] * yw[:, j].reshape(-1, 1, *ch) for j in range(4)]
    out = _sum_sequential(terms)
    if not ipp:
        flat = out.reshape(height, -1)
        body = flat.shape[1] // 4 * 4
        flat[:, :body] = _sum_nested([t.reshape(height, -1)[:, :body] for t in terms])
    return out


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1),
               (-_S45, _S45))


def _lanczos4_weights(fraction):
    """OpenCV's ``interpolateLanczos4`` of one float32 fraction: sines and
    cosines in double (libm's, through ``math``), the weights float32,
    normalised by their float32 sum."""
    one = np.float32(1)
    x3 = np.float32(fraction + np.float32(3))
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    weights, total = [], np.float32(0)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        d = float(np.float32(x3 - np.float32(i)))
        if abs(d) >= float(np.float32(1e-6)):
            y = -d * math.pi * 0.25
            weights.append(np.float32((cs * s0 + cc * c0) / (y * y)))
        else:
            weights.append(np.float32(1e30))
        total = np.float32(total + weights[-1])
    scale = np.float32(one / total)
    return [np.float32(w * scale) for w in weights]


def resize_lanczos4(image, width, height):
    """``cv2.resize(image, (width, height), interpolation=INTER_LANCZOS4)``
    of a float32 array, (H, W) or (H, W, C), bit for bit: eight taps with
    OpenCV's weights, each row's taps summed in order, the rows' in the
    nested order of OpenCV's four-lane vector loop over all but the last
    ``W * C % 4`` values of a row, which its scalar loop sums in order."""
    if image.shape[:2] == (height, width):
        return image.copy()
    ch = _channels(image)
    xf, xfrac = _position(width, image.shape[1])
    yf, yfrac = _position(height, image.shape[0])
    xi, yi = _taps(xf, 8, image.shape[1]), _taps(yf, 8, image.shape[0])
    xw = np.array([_lanczos4_weights(f) for f in xfrac], np.float32)
    yw = np.array([_lanczos4_weights(f) for f in yfrac], np.float32)
    rows = _sum_sequential([image[:, xi[:, j]] * xw[:, j].reshape(-1, *ch) for j in range(8)])
    terms = [(rows[yi[:, j]] * yw[:, j].reshape(-1, 1, *ch)).reshape(height, -1)
             for j in range(8)]
    out = _sum_sequential(terms)
    body = out.shape[1] // 4 * 4
    out[:, :body] = _sum_nested([t[:, :body] for t in terms])
    return out.reshape((height, width) + image.shape[2:])


def _area_table(src, dst):
    """OpenCV's ``computeResizeAreaTab``: (output index, source index,
    float32 weight) of every source cell an output covers, in its order."""
    scale = 1.0 / (dst / src)
    table = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            table.append((d, s1 - 1, (s1 - f1) / cell))
        table.extend((d, s, 1.0 / cell) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            table.append((d, s2, min(min(f2 - s2, 1.0), cell) / cell))
    return table


def _area_accumulate(image, table, axis, n_out):
    """Sum ``image``'s cells along ``axis`` into ``n_out`` outputs with the
    weights of ``table``: each output's terms added in the table's order
    (``out = w * s`` for the first, ``out + w * s`` after), float32."""
    rank = {}
    rounds = []
    for d, s, w in table:
        r = rank.get(d, 0)
        rank[d] = r + 1
        if r == len(rounds):
            rounds.append([])
        rounds[r].append((d, s, w))
    x = np.moveaxis(image, axis, 0)
    out = np.zeros((n_out,) + x.shape[1:], np.float32)
    bshape = (-1,) + (1,) * (x.ndim - 1)
    for entries in rounds:
        d, s, w = (np.array(v) for v in zip(*entries))
        out[d] = out[d] + x[s] * w.astype(np.float32).reshape(bshape)
    return np.moveaxis(out, 0, axis)


def _area_fast(image, sx, sy):
    """OpenCV's ``resizeAreaFast`` at whole-number factors: each output the
    float32 sum of its ``sx * sy`` cells (row by row, in groups of four
    summed first), times ``1.f / area``.  At 2x2 with one or four channels
    OpenCV's vector loop sums each row's pair first, over all but the last
    ``W % 4`` outputs of a row (one channel) or all of them (four)."""
    height, width = image.shape[0] // sy, image.shape[1] // sx
    cells = image.reshape(height, sy, width, sx, *image.shape[2:])
    terms = [cells[:, a, :, b] for a in range(sy) for b in range(sx)]
    total = None
    for k in range(0, len(terms) - len(terms) % 4, 4):
        group = _sum_sequential(terms[k:k + 4])
        total = group if total is None else total + group
    for t in terms[len(terms) - len(terms) % 4:]:
        total = t if total is None else total + t
    channels = 1 if image.ndim == 2 else image.shape[2]
    if sx == sy == 2 and channels in (1, 4):
        body = width // 4 * 4 if channels == 1 else width
        total[:, :body] = ((terms[0] + terms[1]) + (terms[2] + terms[3]))[:, :body]
    return total * (np.float32(1) / np.float32(sx * sy))


def _area_linear_coefficients(dst, src):
    """INTER_AREA's bilinear tables when up-scaling: for each output the
    first and second source index and their float32 weights."""
    first = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
    frac = ((np.arange(dst) + 1) - (first + 1) * (dst / src)).astype(np.float32)
    frac = np.where(frac <= 0, np.float32(0), frac - np.floor(frac)).astype(np.float32)
    edge = first >= src - 1
    frac[edge] = 0
    first = np.minimum(first, src - 1)
    return first, np.minimum(first + 1, src - 1), np.float32(1) - frac, frac, edge


def resize_area(image, width, height):
    """``cv2.resize(image, (width, height), interpolation=INTER_AREA)`` of a
    float32 array, (H, W) or (H, W, C), bit for bit: ``resizeAreaFast`` at
    whole-number down-scales, ``resizeArea``'s weight tables at other
    down-scales, and area's own bilinear coefficients where either axis
    grows (``S0 * a0 + S1 * a1``, columns then rows)."""
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (height, width):
        return image.copy()
    scale_x, scale_y = 1.0 / (width / src_w), 1.0 / (height / src_h)
    if scale_x >= 1 and scale_y >= 1:
        if abs(scale_x - round(scale_x)) < np.finfo(np.float64).eps and \
                abs(scale_y - round(scale_y)) < np.finfo(np.float64).eps:
            return _area_fast(image, round(scale_x), round(scale_y))
        rows = _area_accumulate(image, _area_table(src_w, width), 1, width)
        return _area_accumulate(rows, _area_table(src_h, height), 0, height)
    ch = _channels(image)
    x0, x1, a0, a1, edge = _area_linear_coefficients(width, src_w)
    rows = image[:, x0] * a0.reshape(-1, *ch) + image[:, x1] * a1.reshape(-1, *ch)
    rows[:, edge] = image[:, x0[edge]]
    y0, y1, b0, b1, _ = _area_linear_coefficients(height, src_h)
    return rows[y0] * b0.reshape(-1, 1, *ch) + rows[y1] * b1.reshape(-1, 1, *ch)
