"""Orientation-target painting (counterpart of
``orienmask_tpu/ops/pallas_paint.py::paint_orientation``).

Per sample, instances n < ``n_last`` with ``active`` are painted in order on
the canvas of their anchor.  Instance n covers the ROI [x1, x2) x [y1, y2):

* ROI pixels in its mask take rank n + 1 and its center (the last wins);
* ROI pixels outside its mask add 1 to a count and the push-to-border
  offset ``sneg * sign(off) * max(|off|, 1e-8)`` to a sum, where
  ``off = pixel - center`` and
  ``sneg = min(max(cwx * (1/olx), 1), max(cwy * (1/oly), 1)) - 1``;
* then pos = rank > 0, neg = count > 0 and not pos, and
  ``torien = raw * f32(1/(anchor/2)) * (1/den)``, with raw the offset to the
  winner's center (pos), the sum (neg) or 0, and den -1, the count or 1000.

Every reciprocal is a correctly rounded 1/x followed by a multiply, and
``1/(anchor/2)`` is taken in double and rounded to f32 once, as the TPU
kernel does; the two versions below give the same bits.

* ``paint_orientation_plain``: the sequential instance loop in torch, all
  samples of the batch at once.
* ``paint_orientation``: the wrapper.  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel of ``csrc/paint.cu`` or raises.

The painting is a constant for the gradient: no backward.
"""

import numpy as np
import torch

from .. import kernels
from .maskops import pack_bits

N_GEOM = 10  # cx, cy, cwx, cwy, x1, x2, y1, y2, anchor, active
MAX_INSTANCES = 1024  # geometry in shared memory (csrc/paint.cu)
MAX_ANCHORS = 16


def inv_half_anchors(pixel_anchors):
    """(A, 2) f32: ``1 / (anchor / 2)`` in double, rounded to f32 once."""
    pa = np.asarray(pixel_anchors, np.float32).astype(np.float64)
    return (1.0 / (pa / 2.0)).astype(np.float32)


def _unpack(gt_mask, w):
    """(B, N, H, W) bool from packed (MSB first) or unpacked masks."""
    if gt_mask.shape[-1] == w:
        return gt_mask.bool()
    shift = torch.arange(7, -1, -1, dtype=torch.uint8, device=gt_mask.device)
    bits = (gt_mask[..., None] >> shift) & 1
    return bits.reshape(*gt_mask.shape[:-1], -1)[..., :w].bool()


@torch.no_grad()
def paint_orientation_plain(geom, n_last, gt_mask, pixel_anchors, image_size):
    h, w = image_size
    b = geom.shape[0]
    n_anchors = len(pixel_anchors)
    dev = geom.device
    mask = _unpack(gt_mask, w)
    xf = torch.arange(w, dtype=torch.float32, device=dev)
    yf = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # per-anchor canvases: winner rank and center, background count and sums
    rank, cen_x, cen_y, count, sum_x, sum_y = (
        torch.zeros(b, n_anchors, h, w, device=dev) for _ in range(6))
    batch = torch.arange(b, device=dev)
    eps = float(np.float32(1e-8))
    for i in range(int(n_last.max()) if b else 0):
        g = geom[:, i, :, None, None]  # (B, 10, 1, 1)
        cx, cy, cwx, cwy, x1, x2, y1, y2 = g[:, :8].unbind(1)
        act = ((g[:, 9] > 0) & (i < n_last.view(b, 1, 1)))
        anc = g[:, 8, 0, 0].long()
        act = act & ((anc >= 0) & (anc < n_anchors)).view(b, 1, 1)
        sel = (batch, anc.clamp(0, n_anchors - 1))
        roi = (xf >= x1) & (xf < x2) & (yf >= y1) & (yf < y2) & act
        m = mask[:, i]
        inst = roi & m
        bgf = (roi & ~m).float()
        offx, offy = xf - cx, yf - cy
        olx = offx.abs().clamp_min(eps)
        oly = offy.abs().clamp_min(eps)
        sneg = torch.minimum((cwx * torch.reciprocal(olx)).clamp_min(1.0),
                             (cwy * torch.reciprocal(oly)).clamp_min(1.0)) - 1.0
        # an inactive sample adds nothing (its geometry may be anything)
        nox = torch.where(act, sneg * torch.sign(offx) * olx * bgf, 0.0)
        noy = torch.where(act, sneg * torch.sign(offy) * oly * bgf, 0.0)
        rank[sel] = torch.where(inst, float(i + 1), rank[sel])
        cen_x[sel] = torch.where(inst, cx, cen_x[sel])
        cen_y[sel] = torch.where(inst, cy, cen_y[sel])
        count[sel] = count[sel] + bgf
        sum_x[sel] = sum_x[sel] + nox
        sum_y[sel] = sum_y[sel] + noy

    pos = rank > 0
    has_bg = (count > 0) & ~pos
    den = torch.where(pos, -1.0, torch.where(has_bg, count, 1000.0))
    rden = torch.reciprocal(den)
    inv = torch.from_numpy(inv_half_anchors(pixel_anchors)).to(dev)
    raw_x = torch.where(pos, xf - cen_x, torch.where(has_bg, sum_x, 0.0))
    raw_y = torch.where(pos, yf - cen_y, torch.where(has_bg, sum_y, 0.0))
    tx = raw_x * inv[:, 0].view(1, -1, 1, 1) * rden
    ty = raw_y * inv[:, 1].view(1, -1, 1, 1) * rden
    return pos.float(), has_bg.float(), torch.stack([tx, ty], dim=-1)


def paint_orientation(geom, n_last, gt_mask, pixel_anchors, image_size):
    """Paint the orientation targets of a batch.

    geom (B, N, 10) f32 rows ``[cx, cy, cwx, cwy, x1, x2, y1, y2, anchor,
    active]`` in pixels (``OrientationPainter.kernel_inputs``); n_last (B,)
    int32, 1 + the index of each sample's last active instance; gt_mask
    (B, N, H, W/8) uint8 packed MSB first, or (B, N, H, W) bool/uint8;
    pixel_anchors (A, 2) anchor sizes in pixels; image_size (H, W).
    Returns pos, neg (B, A, H, W) f32 and torien (B, A, H, W, 2) f32."""
    if geom.device.type == "cpu":
        return paint_orientation_plain(geom, n_last, gt_mask, pixel_anchors, image_size)
    if geom.device.type != "cuda":
        raise ValueError(f"paint_orientation: unsupported device {geom.device}")
    h, w = image_size
    b, n = geom.shape[:2]
    a = len(pixel_anchors)
    if w % 8:
        raise ValueError(f"paint_orientation: the kernel needs W % 8 == 0 (W={w})")
    if gt_mask.shape[-1] == w:
        gt_mask = pack_bits(gt_mask.bool())
    checks = [
        (geom, torch.float32, (b, n, N_GEOM)),
        (n_last, torch.int32, (b,)),
        (gt_mask, torch.uint8, (b, n, h, w // 8)),
    ]
    for t, dtype, shape in checks:
        if t.device != geom.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"paint_orientation: expected a contiguous {dtype} {shape} "
                             f"on {geom.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n > MAX_INSTANCES or a > MAX_ANCHORS:
        raise ValueError(f"paint_orientation: the kernel takes N <= {MAX_INSTANCES} and "
                         f"A <= {MAX_ANCHORS}; N={n}, A={a}")
    pos = torch.empty((b, a, h, w), device=geom.device)
    neg = torch.empty_like(pos)
    torien = torch.empty((b, a, h, w, 2), device=geom.device)
    inv = inv_half_anchors(pixel_anchors)  # read by the C entry point before it returns
    if b and h:
        kernels.launch("paint", "omt_paint_orientation", geom.data_ptr(), n_last.data_ptr(),
                       gt_mask.data_ptr(), inv.ctypes.data, pos.data_ptr(), neg.data_ptr(),
                       torien.data_ptr(), b, n, a, h, w)
        kernels.launches["paint_orientation"] += 1
    return pos, neg, torien
