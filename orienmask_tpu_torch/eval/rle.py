"""COCO run-length-encoding codec (the port's own copy of
``orienmask_tpu/eval/rle.py``): the hot paths (encode, decode of the
compressed strings, polygons, IoU) go through the port's native host
library (``orienmask_tpu_torch.native``), as the JAX module's do; the numpy
bodies stay as ``*_plain`` functions, the spec the tests hold the library
to.  Nothing falls back to them.

Implements the exact pycocotools ``maskApi`` semantics so our segmentation
results json interoperates with the official toolchain (and their annotation
files decode identically):

  * masks are scanned in column-major (Fortran) order;
  * ``counts`` alternates runs of 0s and 1s, starting with zeros;
  * the compressed string stores each count as a base-32 varint (5 bits/char,
    offset by 48, bit 0x20 = continuation) with delta coding against
    ``counts[i-2]`` from the third element on;
  * polygon rasterization (``poly_to_rle``) reproduces pycocotools'
    ``rleFrPoly`` crossing-based algorithm (5x upsampled boundary walk ->
    column-crossing extraction -> sorted toggle positions), NOT a generic
    scanline fill — boundary pixels differ between the two, and the reference
    trains/evaluates on pycocotools GT masks (reference data/dataset.py:87-100,
    eval/coco_eval.py:108-127);
  * ``merge``/``iou``/``area``/``to_bbox`` operate in RLE space without
    decoding full masks.
"""

import numpy as np

from .. import native


def _mask_to_counts(mask):
    """HxW {0,1} -> run lengths in Fortran order, starting with a zero-run."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [n]]))
    if flat[0] == 1:  # counts must start with the zero-run
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def _counts_to_mask(counts, h, w):
    n = h * w
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < n:  # rleFrPoly can emit counts summing below h*w (trailing 0s)
        flat = np.concatenate([flat, np.zeros(n - flat.size, np.uint8)])
    return flat[:n].reshape(w, h).T  # Fortran order


def _counts_to_string(counts):
    out = []
    m = len(counts)
    for i in range(m):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        while True:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
            if not more:
                break
    return "".join(out)


def _string_to_counts(s):
    return native.rle_decode_counts(s)


def _string_to_counts_plain(s):
    counts = []
    p = 0
    ln = len(s)
    while p < ln:
        x = 0
        k = 0
        while True:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            p += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode(mask):
    """HxW {0,1} uint8/bool -> {'size': [h, w], 'counts': str} (compressed RLE)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": native.rle_encode(np.asarray(mask, np.uint8))}


def encode_plain(mask):
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _counts_to_string(_mask_to_counts(mask))}


def encode_batch(masks):
    """(n, h, w) masks -> list of RLE dicts."""
    _, h, w = masks.shape
    return [{"size": [int(h), int(w)], "counts": c}
            for c in native.rle_encode_batch(np.asarray(masks, np.uint8))]


def decode(rle):
    """{'size': [h, w], 'counts': str|list} -> HxW uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _string_to_counts(counts)
    elif isinstance(counts, bytes):
        counts = _string_to_counts(counts.decode())
    return _counts_to_mask(np.asarray(counts, np.int64), h, w)


def area(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _string_to_counts(counts if isinstance(counts, str) else counts.decode())
    return int(np.asarray(counts[1::2], np.int64).sum())


def _raw_counts(rle_or_counts):
    """RLE dict / counts str / counts array -> int64 counts array."""
    if isinstance(rle_or_counts, dict):
        rle_or_counts = rle_or_counts["counts"]
    if isinstance(rle_or_counts, bytes):
        rle_or_counts = rle_or_counts.decode()
    if isinstance(rle_or_counts, str):
        return _string_to_counts(rle_or_counts)
    return np.asarray(rle_or_counts, np.int64)


def to_bbox(rle):
    """RLE -> xywh bbox (pixels), computed in RLE space (pycocotools
    rleToBbox semantics: a 1-run spanning >1 column forces ys=0, ye=h-1)."""
    h = int(rle["size"][0])
    counts = _raw_counts(rle)
    ends = np.cumsum(counts)
    starts = ends[0::2][: len(ends[1::2])]  # 1-run starts (flat, col-major)
    stops = ends[1::2] - 1                  # 1-run last indices
    if starts.size == 0 or h == 0:
        return np.zeros(4, np.float64)
    xs_col, ys_in = starts // h, starts % h
    xe_col, ye_in = stops // h, stops % h
    if (xe_col > xs_col).any():  # a run wraps a column boundary
        y0, y1 = 0, h - 1
    else:
        y0, y1 = int(ys_in.min()), int(ye_in.max())
    x0, x1 = int(xs_col.min()), int(xe_col.max())
    return np.array([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float64)


# ----------------------------------------------------------------- polygons

_POLY_SCALE = 5.0  # pycocotools rleFrPoly upsampling factor


def _trunc_int(x):
    """C ``(int)`` cast: truncation toward zero."""
    return np.trunc(x).astype(np.int64)


def poly_to_rle_counts(xy, h, w):
    """One polygon [x0, y0, x1, y1, ...] -> raw RLE counts (int64).

    Exact reimplementation of pycocotools' crossing-based ``rleFrPoly``:
    vertices are scaled 5x and rounded; the boundary is walked densely with
    the same axis-major stepping; column crossings at original-resolution
    pixel boundaries become sorted toggle positions (column-major flat
    index); toggles with even multiplicity cancel.
    """
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    k = xy.shape[0]
    if k == 0:
        return np.array([h * w], np.int64)
    x = _trunc_int(_POLY_SCALE * xy[:, 0] + 0.5)
    y = _trunc_int(_POLY_SCALE * xy[:, 1] + 0.5)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    xs_, xe_, ys_, ye_ = x[:-1], x[1:], y[:-1], y[1:]
    dx = np.abs(xe_ - xs_)
    dy = np.abs(ys_ - ye_)
    flip = ((dx >= dy) & (xs_ > xe_)) | ((dx < dy) & (ys_ > ye_))
    xs = np.where(flip, xe_, xs_)
    xe = np.where(flip, xs_, xe_)
    ys = np.where(flip, ye_, ys_)
    ye = np.where(flip, ys_, ye_)
    xmajor = dx >= dy
    denom = np.where(xmajor, dx, dy).astype(np.float64)
    num = np.where(xmajor, ye - ys, xe - xs).astype(np.float64)
    s = np.where(denom > 0, num / np.where(denom > 0, denom, 1.0), 0.0)

    n_per = (np.where(xmajor, dx, dy) + 1).astype(np.int64)
    total = int(n_per.sum())
    start = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    d = np.arange(total, dtype=np.int64) - np.repeat(start, n_per)
    eflip = np.repeat(flip, n_per)
    espan = np.repeat(np.where(xmajor, dx, dy), n_per)
    t = np.where(eflip, espan - d, d)
    exs = np.repeat(xs, n_per)
    eys = np.repeat(ys, n_per)
    es = np.repeat(s, n_per)
    exmaj = np.repeat(xmajor, n_per)
    u = np.where(exmaj, t + exs, _trunc_int(exs + es * t + 0.5))
    v = np.where(exmaj, _trunc_int(eys + es * t + 0.5), t + eys)

    # column crossings -> downsampled (x, y) boundary points
    if total > 1:
        j = np.flatnonzero(u[1:] != u[:-1]) + 1
    else:
        j = np.zeros(0, np.int64)
    xd = np.where(u[j] < u[j - 1], u[j], u[j] - 1).astype(np.float64)
    xd = (xd + 0.5) / _POLY_SCALE - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    xd = xd[keep]
    yd = np.minimum(v[j], v[j - 1])[keep].astype(np.float64)
    yd = (yd + 0.5) / _POLY_SCALE - 0.5
    yd = np.ceil(np.clip(yd, 0, h))

    pos = (xd.astype(np.int64) * h + yd.astype(np.int64))
    # toggles with even multiplicity cancel (the C delta-merge loop's effect);
    # counts always extend to h*w (the C sentinel), so a toggle landing
    # exactly at h*w is a no-op
    uniq, cnt = np.unique(pos, return_counts=True)
    toggles = uniq[(cnt % 2 == 1) & (uniq < h * w)]
    return np.diff(np.concatenate([[0], toggles, [h * w]]))


def merge_counts(counts_list, h, w, intersect=False):
    """Union/intersection of raw-counts RLEs (pycocotools ``rleMerge``)."""
    if not counts_list:
        return np.array([h * w], np.int64)
    acc = np.asarray(counts_list[0], np.int64)
    for other in counts_list[1:]:
        acc = _merge_two(acc, np.asarray(other, np.int64), h * w, intersect)
    return acc


def _merge_two(ca, cb, n, intersect):
    # toggle positions (prefix sums, excluding the end-of-mask)
    pa = np.cumsum(ca)[:-1] if len(ca) > 1 else np.zeros(0, np.int64)
    pb = np.cumsum(cb)[:-1] if len(cb) > 1 else np.zeros(0, np.int64)
    bp = np.union1d(pa, pb)
    bp = bp[(bp > 0) & (bp < n)]  # drop zero-length boundary segments
    starts = np.concatenate([[0], bp])
    va = (np.searchsorted(pa, starts, side="right") % 2).astype(bool)
    vb = (np.searchsorted(pb, starts, side="right") % 2).astype(bool)
    v = (va & vb) if intersect else (va | vb)
    # compress equal-adjacent segments back into alternating counts
    seg_ends = np.concatenate([bp, [n]])
    changes = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
    run_vals = v[changes]
    run_ends = np.concatenate([seg_ends[changes[1:] - 1], [n]])
    counts = np.diff(np.concatenate([[0], run_ends]))
    if run_vals.size and run_vals[0]:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def polygons_to_counts(polygons, height, width):
    """COCO polygon list -> merged raw counts (pycocotools frPoly+merge)."""
    return native.poly_merge_counts(polygons, height, width)


def polygons_to_counts_plain(polygons, height, width):
    return merge_counts([poly_to_rle_counts(p, height, width) for p in polygons],
                        height, width)


def polygons_to_rle(polygons, height, width):
    """COCO polygon list -> compressed RLE dict (pycocotools frPoly+merge)."""
    return {"size": [int(height), int(width)],
            "counts": _counts_to_string(polygons_to_counts(polygons, height, width))}


def polygons_to_mask(polygons, height, width):
    """COCO polygon list [[x0, y0, x1, y1, ...], ...] -> HxW uint8 mask.

    pycocotools-exact rasterization (crossing-based), NOT a generic polygon
    fill: the reference's GT masks come from pycocotools both in training
    (reference data/dataset.py:87-100) and eval."""
    return _counts_to_mask(polygons_to_counts(polygons, height, width), height, width)


def polygons_to_mask_plain(polygons, height, width):
    return _counts_to_mask(polygons_to_counts_plain(polygons, height, width), height, width)


def _runs_of(counts):
    """counts -> (starts, ends) of 1-runs in the flat column-major index."""
    ends = np.cumsum(counts)
    starts = ends - counts
    return starts[1::2], ends[1::2]


def _intersection_area(sa, ea, sb, eb):
    """Total overlap length of two sorted disjoint interval sets."""
    if sa.size == 0 or sb.size == 0:
        return 0
    # coverage function of B evaluated at A's endpoints
    lens = eb - sb
    prefix = np.concatenate([[0], np.cumsum(lens)])

    def cov(x):
        j = np.searchsorted(eb, x, side="right")
        inside = np.clip(x - sb[np.minimum(j, len(sb) - 1)], 0,
                         lens[np.minimum(j, len(lens) - 1)])
        inside = np.where(j < len(sb), inside, 0)
        return prefix[j] + inside

    return int(np.sum(cov(ea) - cov(sa)))


def _check_sizes(rles_a, rles_b):
    sizes = {tuple(int(v) for v in r["size"]) for r in rles_a} | \
            {tuple(int(v) for v in r["size"]) for r in rles_b}
    if len(sizes) > 1:
        # Flat col-major runs from different (h, w) are incommensurable; the
        # RLE-space sweep would return plausible-looking garbage.
        raise ValueError(f"rle.iou: mixed mask sizes {sorted(sizes)}")


def iou(rles_a, rles_b, iscrowd=None):
    """Pairwise mask IoU of two RLE lists -> (len_a, len_b) float64, computed
    in RLE space without decoding (pycocotools ``rleIou`` semantics).

    ``iscrowd[j]`` true makes the union just area(a) (COCO crowd semantics).
    """
    _check_sizes(rles_a, rles_b)
    return native.rle_iou(rles_a, rles_b, iscrowd)


def iou_plain(rles_a, rles_b, iscrowd=None):
    _check_sizes(rles_a, rles_b)
    counts_a = [_raw_counts(r) for r in rles_a]
    counts_b = [_raw_counts(r) for r in rles_b]
    runs_a = [_runs_of(c) for c in counts_a]
    runs_b = [_runs_of(c) for c in counts_b]
    area_a = [int((e - s).sum()) for s, e in runs_a]
    area_b = [int((e - s).sum()) for s, e in runs_b]
    out = np.zeros((len(rles_a), len(rles_b)))
    for i, (sa, ea) in enumerate(runs_a):
        for j, (sb, eb) in enumerate(runs_b):
            inter = _intersection_area(sa, ea, sb, eb)
            if iscrowd is not None and iscrowd[j]:
                union = area_a[i]
            else:
                union = area_a[i] + area_b[j] - inter
            out[i, j] = inter / union if union else 0.0
    return out
