"""ctypes bindings of the port's native host library ``csrc/omtpu.cc``
(counterpart of ``orienmask_tpu/native``, with the same function names and
contracts).

The library is built by ``g++`` at first use into
``csrc/build/libomtpu.so`` (``kernels.host_library``).  Where the JAX
package returns ``None`` and lets numpy carry on, these raise: a failed
build raises ``RuntimeError`` from the first call, and so does an output
buffer the library finds too small.  One function is the port's own:
``rle_encode_colpacked``, the RLE strings of masks that arrive as
column-major bits from the card (``ops/recover.py``).
"""

import numpy as np

from .. import kernels


def get_lib():
    """The loaded library; builds it first (raises if it cannot)."""
    return kernels.host_library("omtpu")


def _ptr(a):
    return a.ctypes.data


def nms(dets, threshold=0.5):
    """Greedy NMS on (n, 5) cxcywh+score float32; returns keep indices
    (ascending input order, matching the reference CPU extension)."""
    lib = get_lib()
    dets = np.ascontiguousarray(dets, np.float32)
    n = dets.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    keep = np.empty(n, np.int64)
    m = lib.om_nms(_ptr(dets), n, threshold, _ptr(keep))
    return keep[:m]


def _strings(buf, total, lens):
    if total < 0:
        raise RuntimeError("omtpu: the RLE output buffer is too small")
    raw = buf[:total].tobytes()
    out, p = [], 0
    for ln in lens:
        out.append(raw[p:p + int(ln)].decode())
        p += int(ln)
    return out


def rle_encode(mask):
    """HxW uint8 -> compressed counts string."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap = 2 * h * w + 64
    # np.empty: zero-filling the worst-case capacity costs a memset per call
    buf = np.empty(cap, np.uint8)
    ln = lib.om_rle_encode(_ptr(mask), h, w, _ptr(buf), cap)
    return _strings(buf, ln, [ln])[0]


def rle_decode_counts(s):
    """Compressed counts string -> raw int64 counts.

    Inverse of rle_encode's varint writer; each count is at least one char so
    len(s) bounds the output."""
    lib = get_lib()
    raw = np.frombuffer(s.encode() if isinstance(s, str) else bytes(s), np.uint8)
    out = np.empty(max(1, raw.size), np.int64)
    m = lib.om_rle_decode(_ptr(raw) if raw.size else None, raw.size, _ptr(out), out.size)
    if m < 0:
        raise ValueError(f"omtpu: a truncated RLE string {s!r}")
    return out[:m].copy()


def rle_encode_batch(masks):
    """(n, h, w) uint8 -> list of counts strings."""
    lib = get_lib()
    masks = np.ascontiguousarray(masks, np.uint8)
    n, h, w = masks.shape
    if n == 0:
        return []
    cap = n * (2 * h * w + 64)
    buf = np.empty(cap, np.uint8)
    lens = np.empty(n, np.int32)
    total = lib.om_rle_encode_batch(_ptr(masks), n, h, w, _ptr(buf), cap, _ptr(lens))
    return _strings(buf, total, lens)


def rle_encode_colpacked(words, n, oh, ow):
    """n masks of (oh, ow) as column-major bits -> list of counts strings,
    the strings ``rle_encode`` gives for the unpacked masks.

    ``words`` holds (n, ow, ceil(oh / 32)) 32-bit words (uint32 or int32
    of the same bits): bit i of word w of column c is pixel (32 w + i, c);
    bits past ``oh`` are ignored."""
    lib = get_lib()
    wpc = -(-oh // 32)
    words = np.ascontiguousarray(words)
    if words.dtype.itemsize != 4:
        raise ValueError(f"rle_encode_colpacked: 32-bit words, got {words.dtype}")
    words = words.view(np.uint32)
    if words.size != n * ow * wpc:
        raise ValueError(f"rle_encode_colpacked: {words.size} words for {n} masks of "
                         f"({oh}, {ow}), expected {n * ow * wpc}")
    if n == 0:
        return []
    cap = n * (2 * oh * ow + 64)
    buf = np.empty(cap, np.uint8)
    lens = np.empty(n, np.int32)
    total = lib.om_rle_encode_colpacked(_ptr(words), n, oh, ow, _ptr(buf), cap, _ptr(lens))
    return _strings(buf, total, lens)


def poly_merge_counts(polygons, h, w):
    """COCO polygon list -> merged raw RLE counts (int64 array), pycocotools
    frPoly+merge semantics."""
    lib = get_lib()
    polys = [np.ascontiguousarray(np.asarray(p, np.float64).ravel()) for p in polygons]
    flat = np.ascontiguousarray(np.concatenate(polys) if polys else np.zeros(0, np.float64))
    n_verts = np.array([p.size // 2 for p in polys], np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_verts)]).astype(np.int64)
    cap = h * w + 2
    out = np.empty(cap, np.int64)
    m = lib.om_poly_merge(_ptr(flat) if flat.size else None, _ptr(offsets), len(polys), h, w,
                          _ptr(out), cap)
    if m < 0:
        raise RuntimeError("omtpu: the polygon counts buffer is too small")
    return out[:m].copy()


def coco_match(ious, g_order, gi, iscrowd, thrs):
    """COCOeval greedy matching for one (image, category, area) cell.

    Returns (dt_m, dt_ig) with shapes (nt, nd): dt_m holds sorted-gt indices
    or -1."""
    lib = get_lib()
    ious = np.ascontiguousarray(ious, np.float64)
    nd, ng = ious.shape
    thrs = np.ascontiguousarray(thrs, np.float64)
    nt = len(thrs)
    g_order = np.ascontiguousarray(g_order, np.int64)
    gi = np.ascontiguousarray(gi, np.uint8)
    crowd = np.ascontiguousarray(iscrowd, np.uint8)
    dt_m = np.empty((nt, nd), np.int64)
    dt_ig = np.zeros((nt, nd), np.uint8)
    lib.om_coco_match(_ptr(ious), nd, ng, _ptr(g_order), _ptr(gi), _ptr(crowd), _ptr(thrs),
                      nt, _ptr(dt_m), _ptr(dt_ig))
    return dt_m, dt_ig.astype(bool)


def rle_iou(rles_a, rles_b, iscrowd=None):
    """Pairwise RLE IoU on lists of RLE dicts (compressed or raw counts)
    without decoding. Returns (len_a, len_b) float64."""
    from ..eval.rle import _raw_counts

    lib = get_lib()
    n_a, n_b = len(rles_a), len(rles_b)
    out = np.zeros((n_a, n_b), np.float64)
    if n_a == 0 or n_b == 0:
        return out
    if not isinstance(rles_a[0], dict):
        raise TypeError("rle_iou takes RLE dicts with a 'size'")
    ca = [_raw_counts(r) for r in rles_a]
    cb = [_raw_counts(r) for r in rles_b]
    h = int(rles_a[0]["size"][0])
    flat_a = np.ascontiguousarray(np.concatenate(ca), np.int64)
    flat_b = np.ascontiguousarray(np.concatenate(cb), np.int64)
    off_a = np.concatenate([[0], np.cumsum([len(c) for c in ca])]).astype(np.int64)
    off_b = np.concatenate([[0], np.cumsum([len(c) for c in cb])]).astype(np.int64)
    crowd = np.zeros(n_b, np.uint8)
    if iscrowd is not None:
        crowd = np.ascontiguousarray(iscrowd, np.uint8)
    lib.om_rle_iou(_ptr(flat_a), _ptr(off_a), n_a, _ptr(flat_b), _ptr(off_b), n_b, h,
                   _ptr(crowd), _ptr(out))
    return out


def resize_bilinear(src, dh, dw, align_corners=False):
    """float32 HWC (or HW) resize.  Not OpenCV's INTER_LINEAR arithmetic:
    its 0.5 ties round otherwise, so masks go through ``ops/resize.py``."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.om_resize_bilinear(_ptr(src), sh, sw, c, _ptr(dst), dh, dw, int(align_corners))
    return dst[..., 0] if squeeze else dst
