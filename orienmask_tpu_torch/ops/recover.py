"""Kernel 6: the COCO conversion's mask recovery on the card.

``COCOMetrics._recover_shape_segm`` (``eval/coco_eval.py``; in the JAX
package ``orienmask_tpu/eval/coco_eval.py::_recover_shape_segm``, cv2 on the
host) takes each image's masks at network resolution back to the original
image: it crops the collate padding, undoes the flips, crops the letterbox
padding, resizes with OpenCV's ``INTER_LINEAR`` and rounds.  Here that runs
on the postprocess's packed masks where they lie, and only column-major bits
of the original size cross to the host, where ``native.rle_encode_colpacked``
turns them into the COCO strings.

* ``source_window``: the crop, flip, crop of an image's info composed into
  the source row and column of each pixel of the window they leave.
* ``recover_geometry``: a batch's windows and output sizes as the tables the
  kernel reads (the resize's coefficients from double on the host, as
  ``ops/resize.py::linear_coefficients`` makes them, with the window's
  source indices put in), each image's identity flag and the source words
  each band of the kernel stages.
* ``recover_masks``: the kernel (``csrc/recover.cu``) on a CUDA tensor, its
  plain version ``recover_masks_plain`` on a CPU tensor.  Out: every image's
  ``(n, ow, ceil(oh / 32))`` words, concatenated, as int32 holding uint32
  bits: bit i of word w of column c is pixel (32 w + i, c).
* ``recover_mirror``: the kernel's word logic in numpy (staged words, the
  windows, the column tables, the tile check, the identity transpose), held
  to the plain version by the CPU tests; ``tile_classes`` counts its tiles
  by the path they take.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .resize import _fma32, linear_coefficients, resize_linear_torch

# ints per image: n, oh, ow, words a column, column, row and word offsets,
# flags, first band, first staged row, staged rows, columns a sub-band
_GEOM = 12
IDENTITY = 1  # flags: every fraction 0 and every first index i -> i (a transpose)
BAND = 64  # output columns a block of the kernel owns (csrc/recover.cu's kBand)


def source_window(info, h, w):
    """(rows, cols): the source row of each row, and the source column of
    each column, of what the crop of ``collate_pad``, the flips and the crop
    of ``pad`` leave of an (h, w) mask, in the order (and with the slicing)
    of the JAX ``_recover_shape_segm``."""
    rows, cols = np.arange(h), np.arange(w)
    if info.get("collate_pad") is not None:
        left, right, top, down = info["collate_pad"][:4]
        rows, cols = rows[top:len(rows) - down or None], cols[left:len(cols) - right or None]
    # flips invert before the pad (reverse forward order)
    if info.get("hflip", False):
        cols = cols[::-1]
    if info.get("vflip", False):
        rows = rows[::-1]
    if info.get("pad") is not None:
        top, down, left, right = info["pad"][:4]
        rows, cols = rows[top:len(rows) - down or None], cols[left:len(cols) - right or None]
    return rows, cols


def window_coefficients(index, dst):
    """``linear_coefficients`` of ``dst`` outputs over a window whose
    source indices are ``index``: (first source index, second, fraction)."""
    first, second, frac = linear_coefficients(dst, len(index))
    return index[first], index[second], frac


@dataclass
class RecoverGeometry:
    """A batch's recovery: per image its detections ``counts`` and output
    ``sizes`` (oh, ow) and its words' ``offsets`` (B + 1) in the output;
    the kernel's tables on the device and its launch sizes."""
    counts: list
    sizes: list
    offsets: list
    geom: torch.Tensor  # (B, 12) int32
    bands: torch.Tensor  # (bands, 2) int32: first staged word, staged words a row
    xtab: torch.Tensor  # (columns, 2) int32 source columns
    xfrac: torch.Tensor  # (columns,) float32
    ytab: torch.Tensor  # (rows, 2) int32 source rows
    yfrac: torch.Tensor  # (rows,) float32
    max_tasks: int  # the kernel's most blocks an image: n, or n * ceil(ow / band)
    band: int  # output columns a block (images that are not identities)
    kw_max: int  # most staged words a row (the same)
    rows_max: int  # most staged rows (the same)
    wpc_max: int  # most words a column (the same)
    identity_rows: int  # most rows of an identity image


def sub_band_columns(p):
    """The columns of a sub-band: the largest power of two up to 32 whose
    sub-bands (aligned runs of the output columns) read source pixels p (the
    first of each column's two) at most 31 apart, so that a 64-bit window
    holds every bit a sub-band's column reads."""
    for cps in (32, 16, 8, 4, 2):
        starts = np.arange(0, len(p), cps)
        if (np.maximum.reduceat(p, starts) - np.minimum.reduceat(p, starts)).max() <= 31:
            return cps
    return 1


def band_windows(p, band, cps):
    """(g0, kw) of each band of ``band`` output columns (``cps`` a
    sub-band): the band stages words g0..g0 + kw - 1 of each source row (in
    words of 32 pixels; words outside the row read 0), so that pixel p of a
    column lies at bit u = p - 32 g0 >= 3 of the staged row, and a
    sub-band's window (bits umin - 3 .. umin + 60) lies in the three words
    from (umin - 3) // 32."""
    g0 = (np.minimum.reduceat(p, np.arange(0, len(p), band)) - 3) // 32
    starts = np.arange(0, len(p), cps)
    first = (np.minimum.reduceat(p, starts) - 32 * g0[starts // band] - 3) // 32
    return g0, np.maximum.reduceat(first + 3, np.arange(0, len(starts), band // cps))


def recover_geometry(infos, counts, image_hw, device, band=BAND):
    """The tables of ``recover_masks`` for a batch: ``infos`` each image's
    info (``height``, ``width`` and the optional ``collate_pad``, ``pad``,
    ``hflip``, ``vflip``), ``counts`` its valid detections (host ints; an
    image of 0 is skipped), ``image_hw`` the masks' (H, W); ``band`` the
    output columns a block of the kernel owns."""
    h, w = image_hw
    geom = np.zeros((len(counts), _GEOM), np.int64)
    xs, ys, bands, sizes, offsets = [], [], [], [], [0]
    n_cols = n_rows = n_bands = kw_max = rows_max = wpc_max = identity_rows = max_tasks = 0
    for b, (info, n) in enumerate(zip(infos, counts)):
        oh, ow = (int(info["height"]), int(info["width"])) if n else (0, 0)
        wpc = -(-oh // 32)
        flags = ylo = staged = cps = 0
        if n:
            rows, cols = source_window(info, h, w)
            if not len(rows) or not len(cols) or oh <= 0 or ow <= 0:
                raise ValueError(f"recover_geometry: image {b} leaves a {len(rows)}x{len(cols)} "
                                 f"window for a {oh}x{ow} output")
            x0, x1, fx = window_coefficients(cols, ow)
            y0, y1, fy = window_coefficients(rows, oh)
            xs.append((np.stack([x0, x1], 1), fx))
            ys.append((np.stack([y0, y1], 1), fy))
            flags = IDENTITY * bool(not fx.any() and not fy.any()
                                    and np.array_equal(x0, np.arange(ow))
                                    and np.array_equal(y0, np.arange(oh)))
            p = np.minimum(x0, x1)
            cps = sub_band_columns(p)
            g0, kw = band_windows(p, band, cps)
            bands.append(np.stack([g0, kw], 1))
            if flags:
                identity_rows, max_tasks = max(identity_rows, oh), max(max_tasks, n)
            else:
                ylo = int(min(y0.min(), y1.min()))
                staged = int(max(y0.max(), y1.max())) - ylo + 1
                kw_max, rows_max = max(kw_max, int(kw.max())), max(rows_max, staged)
                wpc_max, max_tasks = max(wpc_max, wpc), max(max_tasks, n * len(kw))
        geom[b] = (n, oh, ow, wpc, n_cols, n_rows, offsets[-1], flags, n_bands, ylo, staged, cps)
        n_cols, n_rows = n_cols + ow, n_rows + oh
        n_bands += len(bands[-1]) if n else 0
        sizes.append((oh, ow))
        offsets.append(offsets[-1] + n * ow * wpc)
    if offsets[-1] >= 2 ** 31:
        raise ValueError(f"recover_geometry: {offsets[-1]} words do not fit int32 offsets")

    def table(parts):
        idx = np.concatenate([p[0] for p in parts]) if parts else np.zeros((0, 2), np.int64)
        frac = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.float32)
        return (torch.from_numpy(idx.astype(np.int32)).to(device),
                torch.from_numpy(frac.astype(np.float32)).to(device))

    xtab, xfrac = table(xs)
    ytab, yfrac = table(ys)
    bands = np.concatenate(bands) if bands else np.zeros((0, 2), np.int64)
    if max_tasks >= 2 ** 31:
        raise ValueError(f"recover_geometry: {max_tasks} blocks an image do not fit the grid")
    return RecoverGeometry(list(counts), sizes, offsets,
                           *(torch.from_numpy(t.astype(np.int32)).to(device)
                             for t in (geom, bands)),
                           xtab, xfrac, ytab, yfrac, max_tasks, band, kw_max, rows_max, wpc_max,
                           identity_rows)


def _unpack(packed, w):
    """(..., W/8) uint8 MSB first -> (..., w) float32 0/1."""
    shift = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shift) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :w].float()


def _pack_columns(bits):
    """(n, oh, ow) bool -> (n * ow * ceil(oh/32),) int32 words of
    column-major bits, LSB first."""
    n, oh, ow = bits.shape
    wpc = -(-oh // 32)
    cols = torch.nn.functional.pad(bits.transpose(1, 2).to(torch.int64), (0, 32 * wpc - oh))
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = (cols.reshape(n, ow, wpc, 32) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32).reshape(-1)


def recover_masks_plain(packed, geom):
    b, _, _, wb = packed.shape
    dev = packed.device
    out = []
    xo = yo = 0
    for i in range(b):
        n, (oh, ow) = geom.counts[i], geom.sizes[i]
        if n:
            masks = _unpack(packed[i, :n], 8 * wb)
            x = geom.xtab[xo:xo + ow].long(), geom.xfrac[xo:xo + ow]
            y = geom.ytab[yo:yo + oh].long(), geom.yfrac[yo:yo + oh]
            v = resize_linear_torch(masks, (x[0][:, 0], x[0][:, 1], x[1]),
                                    (y[0][:, 0], y[0][:, 1], y[1]))
            out.append(_pack_columns(torch.round(v) != 0))
        xo, yo = xo + ow, yo + oh
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return torch.cat(out)


def recover_masks(packed, geom):
    """Recover a batch's masks: ``packed`` the postprocess's (B, K, H, W/8)
    uint8 masks (MSB first), ``geom`` from ``recover_geometry``; returns the
    (``geom.offsets[-1]``,) int32 words.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/recover.cu`` or raises."""
    if packed.device.type == "cpu":
        return recover_masks_plain(packed, geom)
    if packed.device.type != "cuda":
        raise ValueError(f"recover_masks: unsupported device {packed.device}")
    b, k, h, wb = packed.shape
    if packed.dtype != torch.uint8 or not packed.is_contiguous():
        raise ValueError(f"recover_masks: expected contiguous uint8 masks, got {packed.dtype}")
    if wb % 4 or h * wb % 16 or packed.data_ptr() % 16:
        raise ValueError(f"recover_masks: the kernel stages 16-byte chunks of whole 32-pixel "
                         f"words; (H, W/8) = {(h, wb)} at address {packed.data_ptr():#x} leave "
                         "a row or a mask unaligned")
    if geom.band != BAND:
        raise ValueError(f"recover_masks: the kernel's blocks own {BAND} columns, not {geom.band}")
    if len(geom.counts) != b or max(geom.counts, default=0) > k:
        raise ValueError(f"recover_masks: counts {geom.counts} for {b} images of {k} masks")
    for t, dtype in ((geom.geom, torch.int32), (geom.bands, torch.int32),
                     (geom.xtab, torch.int32), (geom.xfrac, torch.float32),
                     (geom.ytab, torch.int32), (geom.yfrac, torch.float32)):
        if t.device != packed.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"recover_masks: a table is {t.dtype} on {t.device}, expected "
                             f"contiguous {dtype} on {packed.device}")
    out = torch.empty(geom.offsets[-1], dtype=torch.int32, device=packed.device)
    if geom.max_tasks:
        kernels.launch("recover", "omt_recover_masks", packed.data_ptr(), geom.geom.data_ptr(),
                       geom.bands.data_ptr(), geom.xtab.data_ptr(), geom.xfrac.data_ptr(),
                       geom.ytab.data_ptr(), geom.yfrac.data_ptr(), out.data_ptr(), b, k, h, wb,
                       geom.max_tasks, geom.kw_max, geom.rows_max, geom.wpc_max,
                       geom.identity_rows)
        kernels.launches["recover_masks"] += 1
    return out


def recover_occupancy(geom, wb, lib=None):
    """(dynamic shared memory bytes, blocks an SM holds) of the kernel's
    launch for ``geom`` and masks W/8 = ``wb`` bytes wide, from the card."""
    lib = lib or kernels.library("recover")
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = lib.omt_recover_occupancy(geom.kw_max, geom.rows_max, geom.wpc_max,
                                    geom.identity_rows, wb, ctypes.byref(smem),
                                    ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"omt_recover_occupancy: CUDA error {err}")
    return smem.value, blocks.value


# ------------------------------------------------------- the kernel's mirror

_M32 = np.uint64(0xFFFFFFFF)


def _staged_words(mask, y_first, rows, g0, words):
    """(rows, words) uint32: words g0.. of rows y_first.. of an (H, W) 0/1
    mask, LSB first (bit i of word k = pixel 32 (g0 + k) + i), 0 outside the
    row, as the kernel reads its staged chunks."""
    cols = 32 * g0 + np.arange(32 * words)
    inside = (cols >= 0) & (cols < mask.shape[1])
    bits = np.zeros((rows, 32 * words), np.uint64)
    bits[:, inside] = mask[y_first:y_first + rows][:, cols[inside]]
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(rows, words, 32) * weights).sum(-1).astype(np.uint32)


def _funnel(lo, hi, shift):
    """``__funnelshift_r``: the low word of (hi:lo) >> shift (shift < 32)."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.asarray(shift, np.uint64)) & _M32).astype(np.uint32)


def _transpose32(x):
    """The kernel's ``transpose32``: five ``__shfl_xor_sync`` rounds on the
    32 lanes' words (lane i's bit j -> lane j's bit i)."""
    lane = np.arange(32)
    x = x.astype(np.uint32)
    for m, low in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                   (1, 0x55555555)):
        y, low = x[lane ^ m], np.uint32(low)
        up = (x & ~low) | ((y >> np.uint32(m)) & low)
        down = (x & low) | ((y & low) << np.uint32(m))
        x = np.where(lane & m, up, down).astype(np.uint32)
    return x


def _column_tables(x0, x1, fx):
    """(columns, 16, 2) float32: each column's (r0, r1 - r0) for the 16
    index values (bits p, p + 1 of the top row, then of the bottom row, p =
    min(x0, x1)), with the kernel's arithmetic."""
    idx = np.arange(16)
    tl, th, bl, bh = idx & 1, (idx >> 1) & 1, (idx >> 2) & 1, idx >> 3
    a_low, b_low = (x0 <= x1)[:, None], (x1 <= x0)[:, None]  # a (b) is bit p

    def column_pass(a, b):
        a, b = a.astype(np.float32), b.astype(np.float32)
        return _fma32(b - a, fx[:, None], a)

    r0 = column_pass(np.where(a_low, tl, th), np.where(b_low, tl, th))
    r1 = column_pass(np.where(a_low, bl, bh), np.where(b_low, bl, bh))
    return np.stack([r0, r1 - r0], -1)


def _sub_bands(ow, band, cps):
    """(first column, columns) of each sub-band, band by band."""
    for c0 in range(0, ow, band):
        for s0 in range(c0, min(c0 + band, ow), cps):
            yield s0, min(cps, ow - s0)


def recover_mirror(packed, geom):
    """The kernel's word logic in numpy on (B, K, H, W/8) uint8 ``packed``
    (numpy, MSB first) with ``geom`` from ``recover_geometry``: (the
    (``geom.offsets[-1]``,) int32 words, {path: tiles}), each tile of a
    sub-band counted as "identity" (32x32), "zero", "one" or "mixed"."""
    g_all = geom.geom.cpu().numpy().astype(np.int64)
    bands = geom.bands.cpu().numpy().astype(np.int64)
    xtab, xfrac = geom.xtab.cpu().numpy().astype(np.int64), geom.xfrac.cpu().numpy()
    ytab, yfrac = geom.ytab.cpu().numpy().astype(np.int64), geom.yfrac.cpu().numpy()
    out = np.zeros(geom.offsets[-1], np.uint32)
    classes = {"identity": 0, "zero": 0, "one": 0, "mixed": 0}
    lane = np.arange(32)
    for b, (n, oh, ow, wpc, xo, yo, wo, flags, bo, ylo, rows, cps) in enumerate(g_all):
        if not n:
            continue
        x0, x1, fx = xtab[xo:xo + ow, 0], xtab[xo:xo + ow, 1], xfrac[xo:xo + ow]
        y0, y1, fy = ytab[yo:yo + oh, 0] - ylo, ytab[yo:yo + oh, 1] - ylo, yfrac[yo:yo + oh]
        tables, p = _column_tables(x0, x1, fx), np.minimum(x0, x1)
        # each row's record: top and bottom staged rows, fy (rows past oh: 0)
        rec_top, rec_bottom = np.zeros(32 * wpc, np.int64), np.zeros(32 * wpc, np.int64)
        rec_fy = np.zeros(32 * wpc, np.float32)
        rec_top[:oh], rec_bottom[:oh], rec_fy[:oh] = y0, y1, fy
        for det in range(n):
            mask = np.unpackbits(packed[b, det], axis=-1)
            words = out[wo + det * ow * wpc:wo + (det + 1) * ow * wpc].reshape(ow, wpc)
            if flags & IDENTITY:
                staged = _staged_words(mask, 0, oh, 0, -(-ow // 32))
                staged = np.concatenate([staged, np.zeros((32 * wpc - oh, staged.shape[1]),
                                                          np.uint32)])
                for k in range(staged.shape[1]):
                    cols = 32 * k + lane
                    for t in range(wpc):
                        col = _transpose32(staged[32 * t:32 * t + 32, k])
                        words[cols[cols < ow], t] = col[cols < ow]
                        classes["identity"] += 1
                continue
            for s0, nc in _sub_bands(ow, geom.band, cps):
                g0, kw = bands[bo + s0 // geom.band]
                staged = _staged_words(mask, ylo, rows, g0, kw)
                u = p[s0:s0 + nc] - 32 * g0
                base, amt = u.min() - 3, u - u.min()
                k, m = base >> 5, base & 31
                used = 0
                for a in amt:
                    used |= 3 << (int(a) + 3)
                top_lo, top_hi = np.uint32(used & 0xFFFFFFFF), np.uint32(used >> 32)
                bottom_lo = np.uint32((used << 2) & 0xFFFFFFFF)
                bottom_hi = np.uint32((used << 2) >> 32 & 0xFFFFFFFF)
                for t in range(wpc):
                    i = 32 * t + lane
                    row = i < oh
                    top, bottom = staged[rec_top[i]], staged[rec_bottom[i]]
                    t0, t1 = _funnel(top[:, k], top[:, k + 1], m), _funnel(top[:, k + 1],
                                                                            top[:, k + 2], m)
                    u0 = _funnel(bottom[:, k], bottom[:, k + 1], m)
                    u1 = _funnel(bottom[:, k + 1], bottom[:, k + 2], m)
                    b0 = u0 << np.uint32(2)
                    b1 = (u1 << np.uint32(2)) | (u0 >> np.uint32(30))
                    hit = (t0 & top_lo, t1 & top_hi, b0 & bottom_lo, b1 & bottom_hi)
                    zero = (~row | ((hit[0] | hit[1] | hit[2] | hit[3]) == 0)).all()
                    one = (~row | ((hit[0] == top_lo) & (hit[1] == top_hi) & (hit[2] == bottom_lo)
                                   & (hit[3] == bottom_hi))).all()
                    nr = min(32, oh - 32 * t)
                    rowmask = np.uint32((1 << nr) - 1)
                    if zero or one:
                        classes["zero" if zero else "one"] += 1
                        col = np.full(32, rowmask if not zero else 0, np.uint32)
                    else:
                        classes["mixed"] += 1
                        tw = _funnel(t0[:, None], t1[:, None], amt[None, :])  # (rows, columns)
                        bw = _funnel(b0[:, None], b1[:, None], amt[None, :])
                        idx = ((tw >> 3) & 3) | (((bw >> 5) & 3) << 2)
                        e = tables[s0 + np.arange(nc)[None, :], idx]
                        v = _fma32(e[..., 1], rec_fy[i][:, None], e[..., 0])
                        bits = ((v > 0.5) & row[:, None]).astype(np.uint64)
                        rowwords = (bits << np.arange(nc, dtype=np.uint64)).sum(1)
                        col = _transpose32(rowwords.astype(np.uint32))
                    words[s0:s0 + nc, t] = col[:nc]
    return out.view(np.int32), classes


def tile_classes(packed, geom):
    """{path: tiles} of ``recover_mirror`` without the words: a tile is
    uniform where every bit its rows read in its columns (rows y0, y1 of its
    output rows; pixels p, p + 1 of its columns, past the row's end 0) is 0,
    or every one is 1; vectorized over the detections."""
    g_all = geom.geom.cpu().numpy().astype(np.int64)
    xtab, ytab = geom.xtab.cpu().numpy().astype(np.int64), geom.ytab.cpu().numpy().astype(np.int64)
    classes = {"identity": 0, "zero": 0, "one": 0, "mixed": 0}
    for b, (n, oh, ow, wpc, xo, yo, _, flags, _, _, _, cps) in enumerate(g_all):
        if not n:
            continue
        if flags & IDENTITY:
            classes["identity"] += int(n * -(-ow // 32) * wpc)
            continue
        bits = np.unpackbits(np.asarray(packed[b, :n]), axis=-1).astype(bool)
        bits = np.pad(bits, ((0, 0), (0, 0), (0, 1)))  # pixel W reads 0
        p = np.minimum(xtab[xo:xo + ow, 0], xtab[xo:xo + ow, 1])
        y = ytab[yo:yo + oh]
        for s0, nc in _sub_bands(ow, geom.band, cps):
            cols = np.unique(np.concatenate([p[s0:s0 + nc], p[s0:s0 + nc] + 1]))
            sub = bits[:, :, cols]
            row_zero, row_one = ~sub.any(-1), sub.all(-1)  # (n, H)
            for t in range(wpc):
                rows = np.unique(y[32 * t:32 * t + 32])
                zero, one = row_zero[:, rows].all(1), row_one[:, rows].all(1)
                classes["zero"] += int(zero.sum())
                classes["one"] += int((one & ~zero).sum())
                classes["mixed"] += int((~zero & ~one).sum())
    return classes
