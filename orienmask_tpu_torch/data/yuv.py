"""YUV 4:2:0 <-> RGB as cv2's FFmpeg backend converts video frames
(libswscale, ``SWS_BICUBIC`` at the same size, BT.601 limited range), then
the RGB<->BGR swap the JAX CLI makes with ``cvtColor``; and the full-range
``yuvj420p`` and ``yuvj422p`` of MJPEG to RGB.

``yuv420_to_rgb``: what ``cv2.VideoCapture`` hands back for a decoded frame,
bit for bit: each chroma sample serves its 2x2 luma pixels, and the
arithmetic is libswscale's x86 ``yuv2rgb`` (16-bit fixed point: the inputs
times 8 less their offsets, ``pmulhw`` by the coefficients in 1/8192ths of
``ff_yuv2rgb_coeffs``' BT.601 row, saturated to 8 bits).

``rgb_to_yuv420``: what cv2's ``VideoWriter`` hands the encoder: the luma
is libswscale's (``(8414 R + 16519 G + 3208 B + 16 << 15) >> 15``, equal on
every RGB triple); the chroma is the mean of each 2x2 block's BT.601
chroma, rounded, where libswscale's two-stage rounding differs by at most 1
on about one sample in eight (a stated difference, ROADMAP Queue 3).

``yuvj_to_rgb``: the same x86 ``yuv2rgb`` with the full-range table
libswscale builds for a ``yuvj`` source (no luma offset or gain; the
chroma coefficients scaled by 224/255: ``FULL_*``), each chroma sample
serving 2x2 luma pixels (4:2:0) or 2x1 (4:2:2, by the chroma's height).

``yuv_to_rgb``: the same arithmetic for any colour matrix and range, as
cv2 converts an H.264 frame after ``sws_setColorspaceDetails`` with the
frame's matrix (``matrix_coefficients``) and range (``coefficients``
builds the five coefficients and the luma offset as libswscale's
``ff_yuv2rgb_c_init_tables`` does from ``ff_yuv2rgb_coeffs``).

The ``_py`` functions are the plain versions; the ones the reader and
writer run are the C++ loops of ``csrc/mpeg4_host.cc`` and
``csrc/h264_host.cc`` (``_native``).
"""

import numpy as np

# BT.601 (ff_yuv2rgb_coeffs[SWS_CS_DEFAULT]) in 1/8192ths, as x86 yuv2rgb
# holds them: Y, V->R, U->B, V->G, U->G, and the luma offset times 8
Y_COEFF, VR_COEFF, UB_COEFF, VG_COEFF, UG_COEFF, Y_OFFSET = 9539, 13075, 16525, -6660, -3209, 128
# the same for full range (ff_yuv2rgb_c_init_tables with fullRange 1)
FULL_Y_COEFF, FULL_VR, FULL_UB, FULL_VG, FULL_UG = 8192, 11485, 14516, -5850, -2819
# rgb2yuv in 1/32768ths (libswscale's input table for BT.601 limited range)
RY, GY, BY = 8414, 16519, 3208
RU, GU, BU = -4857, -9535, 14392
RV, GV, BV = 14392, -12052, -2341


def yuv420_to_rgb_py(y, u, v):
    """(H, W) Y and (ceil(H/2), ceil(W/2)) U, V -> (H, W, 3) uint8 RGB."""
    h, w = y.shape
    up = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(np.int64)
    vp = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(np.int64)
    yv = ((y.astype(np.int64) * 8 - Y_OFFSET) * Y_COEFF) >> 16
    u8, v8 = up * 8 - 1024, vp * 8 - 1024
    r = yv + ((v8 * VR_COEFF) >> 16)
    g = yv + ((u8 * UG_COEFF) >> 16) + ((v8 * VG_COEFF) >> 16)
    b = yv + ((u8 * UB_COEFF) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# libswscale's ff_yuv2rgb_coeffs in 16.16 by AVColorSpace (matrix_coefficients):
# crv, cbu, cgu, cgv
YUV2RGB_COEFFS = ((117489, 138438, 13975, 34925), (117489, 138438, 13975, 34925),
                  (104597, 132201, 25675, 53279), (104597, 132201, 25675, 53279),
                  (104448, 132798, 24759, 53109), (104597, 132201, 25675, 53279),
                  (104597, 132201, 25675, 53279), (117579, 136230, 16907, 35559),
                  None, (110013, 140363, 12277, 42626), (110013, 140363, 12277, 42626))
DEFAULT_COLOURSPACE = 5  # SWS_CS_DEFAULT: BT.601


def _div(a, b):
    """C's integer division (toward zero)."""
    return a // b if a >= 0 else -((-a) // b)


def coefficients(colourspace=2, full_range=False):
    """(Y, its offset, V->R, U->B, V->G, U->G) in 1/8192ths (the offset in
    eighths) for frames of AVColorSpace ``colourspace`` and range."""
    if not 0 <= colourspace <= 10 or YUV2RGB_COEFFS[colourspace] is None:
        colourspace = DEFAULT_COLOURSPACE
    crv, cbu, cgu, cgv = YUV2RGB_COEFFS[colourspace]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = (_div(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = cy * 255 // 219, 16 << 16

    def round16(f):
        return (f + (1 << 15)) >> 16

    return (round16(cy << 13), round16(oy << 3), round16(crv << 13), round16(cbu << 13),
            round16(cgv << 13), round16(cgu << 13))


def yuv_to_rgb_py(y, u, v, coeffs):
    """(H, W) Y and (ceil(H/2), ceil(W/2)) U, V -> (H, W, 3) uint8 RGB with
    ``coefficients``' (Y, offset, V->R, U->B, V->G, U->G)."""
    cy, oy, vr, ub, vg, ug = coeffs
    h, w = y.shape
    up = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(np.int64)
    vp = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(np.int64)
    yv = ((y.astype(np.int64) * 8 - oy) * cy) >> 16
    u8, v8 = up * 8 - 1024, vp * 8 - 1024
    r = yv + ((v8 * vr) >> 16)
    g = yv + ((u8 * ug) >> 16) + ((v8 * vg) >> 16)
    b = yv + ((u8 * ub) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def yuvj_to_rgb_py(y, u, v):
    """Full-range (H, W) Y and (ceil(H/2) or H, ceil(W/2)) U, V -> (H, W, 3)
    uint8 RGB."""
    h, w = y.shape
    rows = 2 if u.shape[0] < h else 1
    up = np.repeat(np.repeat(u, rows, 0), 2, 1)[:h, :w].astype(np.int64)
    vp = np.repeat(np.repeat(v, rows, 0), 2, 1)[:h, :w].astype(np.int64)
    yv = (y.astype(np.int64) * 8 * FULL_Y_COEFF) >> 16
    u8, v8 = up * 8 - 1024, vp * 8 - 1024
    r = yv + ((v8 * FULL_VR) >> 16)
    g = yv + ((u8 * FULL_UG) >> 16) + ((v8 * FULL_VG) >> 16)
    b = yv + ((u8 * FULL_UB) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_yuv420_py(rgb):
    """(H, W, 3) uint8 RGB, H and W even -> Y (H, W), U and V (H/2, W/2)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = (RY * r + GY * g + BY * b + (16 << 15)) >> 15

    def quad(x):
        return x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]

    r4, g4, b4 = quad(r), quad(g), quad(b)
    u = (RU * r4 + GU * g4 + BU * b4 + (128 << 17)) >> 17
    v = (RV * r4 + GV * g4 + BV * b4 + (128 << 17)) >> 17
    return (np.clip(y, 0, 255).astype(np.uint8), np.clip(u, 0, 255).astype(np.uint8),
            np.clip(v, 0, 255).astype(np.uint8))


def yuv420_to_rgb_native(y, u, v):
    """``yuv420_to_rgb_py`` in C++ (``omv_yuv_to_rgb``)."""
    from .. import kernels

    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    y, u, v = (p if p.strides[1] == 1 else np.ascontiguousarray(p) for p in (y, u, v))
    if u.strides[0] != v.strides[0]:
        u, v = np.ascontiguousarray(u), np.ascontiguousarray(v)
    kernels.host_library("mpeg4_host").omv_yuv_to_rgb(
        y.ctypes.data, y.strides[0], u.ctypes.data, v.ctypes.data, u.strides[0], w, h,
        out.ctypes.data)
    return out


def yuvj_to_rgb_native(y, u, v):
    """``yuvj_to_rgb_py`` in C++ (``omv_yuvj_to_rgb``)."""
    from .. import kernels

    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
    kernels.host_library("mpeg4_host").omv_yuvj_to_rgb(
        y.ctypes.data, u.ctypes.data, v.ctypes.data, u.shape[1], 2 if u.shape[0] < h else 1, w,
        h, out.ctypes.data)
    return out


def rgb_to_yuv420_native(rgb):
    """``rgb_to_yuv420_py`` in C++ (``omv_rgb_to_yuv``)."""
    from .. import kernels

    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    y = np.empty((h, w), np.uint8)
    u = np.empty((h // 2, w // 2), np.uint8)
    v = np.empty((h // 2, w // 2), np.uint8)
    kernels.host_library("mpeg4_host").omv_rgb_to_yuv(rgb.ctypes.data, w, h, y.ctypes.data,
                                                     u.ctypes.data, v.ctypes.data)
    return y, u, v


def yuv_to_rgb_native(y, u, v, coeffs):
    """``yuv_to_rgb_py`` in C++ (``omh_yuv_to_rgb``)."""
    from .. import kernels

    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
    c = np.asarray(coeffs, np.int32)
    kernels.host_library("h264_host").omh_yuv_to_rgb(
        y.ctypes.data, u.ctypes.data, v.ctypes.data, u.shape[1], w, h, c.ctypes.data,
        out.ctypes.data)
    return out


yuv420_to_rgb = yuv420_to_rgb_native
yuv_to_rgb = yuv_to_rgb_native
yuvj_to_rgb = yuvj_to_rgb_native
rgb_to_yuv420 = rgb_to_yuv420_native
