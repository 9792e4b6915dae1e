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
  source indices put in).
* ``recover_masks``: the kernel (``csrc/recover.cu``) on a CUDA tensor, its
  plain version ``recover_masks_plain`` on a CPU tensor.  Out: every image's
  ``(n, ow, ceil(oh / 32))`` words, concatenated, as int32 holding uint32
  bits: bit i of word w of column c is pixel (32 w + i, c).
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .resize import linear_coefficients, resize_linear_torch

_GEOM = 8  # ints per image: n, oh, ow, words a column, column, row and word offsets, 0


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
    the kernel's tables on the device."""
    counts: list
    sizes: list
    offsets: list
    geom: torch.Tensor  # (B, 8) int32
    xtab: torch.Tensor  # (columns, 2) int32 source columns
    xfrac: torch.Tensor  # (columns,) float32
    ytab: torch.Tensor  # (rows, 2) int32 source rows
    yfrac: torch.Tensor  # (rows,) float32
    max_tasks: int  # the kernel's most warps an image: n * ceil(ow/32) * ceil(oh/32)


def recover_geometry(infos, counts, image_hw, device):
    """The tables of ``recover_masks`` for a batch: ``infos`` each image's
    info (``height``, ``width`` and the optional ``collate_pad``, ``pad``,
    ``hflip``, ``vflip``), ``counts`` its valid detections (host ints; an
    image of 0 is skipped), ``image_hw`` the masks' (H, W)."""
    h, w = image_hw
    geom = np.zeros((len(counts), _GEOM), np.int64)
    xs, ys, sizes, offsets = [], [], [], [0]
    n_cols = n_rows = 0
    for b, (info, n) in enumerate(zip(infos, counts)):
        oh, ow = (int(info["height"]), int(info["width"])) if n else (0, 0)
        wpc = -(-oh // 32)
        if n:
            rows, cols = source_window(info, h, w)
            if not len(rows) or not len(cols) or oh <= 0 or ow <= 0:
                raise ValueError(f"recover_geometry: image {b} leaves a {len(rows)}x{len(cols)} "
                                 f"window for a {oh}x{ow} output")
            x0, x1, fx = window_coefficients(cols, ow)
            y0, y1, fy = window_coefficients(rows, oh)
            xs.append((np.stack([x0, x1], 1), fx))
            ys.append((np.stack([y0, y1], 1), fy))
        geom[b] = (n, oh, ow, wpc, n_cols, n_rows, offsets[-1], 0)
        n_cols, n_rows = n_cols + ow, n_rows + oh
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
    max_tasks = max([n * -(-ow // 32) * -(-oh // 32) for n, (oh, ow) in zip(counts, sizes)],
                    default=0)
    if max_tasks >= 2 ** 31:
        raise ValueError(f"recover_geometry: {max_tasks} warps an image do not fit the grid")
    return RecoverGeometry(list(counts), sizes, offsets,
                           torch.from_numpy(geom.astype(np.int32)).to(device),
                           xtab, xfrac, ytab, yfrac, max_tasks)


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
    if len(geom.counts) != b or max(geom.counts, default=0) > k:
        raise ValueError(f"recover_masks: counts {geom.counts} for {b} images of {k} masks")
    for t, dtype in ((geom.geom, torch.int32), (geom.xtab, torch.int32),
                     (geom.xfrac, torch.float32), (geom.ytab, torch.int32),
                     (geom.yfrac, torch.float32)):
        if t.device != packed.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"recover_masks: a table is {t.dtype} on {t.device}, expected "
                             f"contiguous {dtype} on {packed.device}")
    out = torch.empty(geom.offsets[-1], dtype=torch.int32, device=packed.device)
    if geom.max_tasks:
        kernels.launch("recover", "omt_recover_masks", packed.data_ptr(), geom.geom.data_ptr(),
                       geom.xtab.data_ptr(), geom.xfrac.data_ptr(), geom.ytab.data_ptr(),
                       geom.yfrac.data_ptr(), out.data_ptr(), b, k, h, wb, geom.max_tasks)
        kernels.launches["recover_masks"] += 1
    return out
