"""Target assignment (counterpart of ``orienmask_tpu/ops/targets.py``), with
the batch dimension written out where JAX ``vmap``s.

* ``TargetBuilder``: per scale, the anchor match (argmax wh-IoU over all
  nine anchors, kept where it lands on this scale), the ignore mask, and the
  bbox targets.  Grid-cell writes keep the reference's "last instance wins"
  through a scatter-max of the instance index; ``tcls`` keeps its multi-hot
  quirk (every matched instance sets its class bit at its cell).
* ``OrientationPainter``: the per-instance painter geometry for all scales
  at once (each instance's anchor lands on exactly one scale), painted on a
  nine-anchor canvas by ``ops/paint.py`` (kernel 5).

Constants live on the builder's device, made once at construction.
"""

import numpy as np
import torch

from ..device import resolve_device
from .boxes import anchor_ious, bbox_ious
from .paint import paint_orientation


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


def _bounds(centers, vwh, image_h, image_w):
    """ROI pixel bounds (..., 4) = [x1, x2, y1, y2), the reference's rounding."""
    x1 = torch.round(torch.clamp(centers[..., 0] - vwh[..., 0], 0, image_w - 1))
    x2 = torch.round(torch.clamp(centers[..., 0] + vwh[..., 0], 0, image_w - 1)) + 1
    y1 = torch.round(torch.clamp(centers[..., 1] - vwh[..., 1], 0, image_h - 1))
    y2 = torch.round(torch.clamp(centers[..., 1] + vwh[..., 1], 0, image_h - 1)) + 1
    return torch.stack([x1, x2, y1, y2], dim=-1)


def kernel_geometry(centers, cwh, bounds, anchor, active):
    """Painter inputs: geom (B, N, 10) rows ``[cx, cy, cwx, cwy, x1, x2, y1,
    y2, anchor, active]`` and n_last (B,) int32, 1 + the index of each
    sample's last active instance."""
    geom = torch.cat([centers, cwh, bounds, anchor.float()[..., None],
                      active.float()[..., None]], dim=-1)
    n = active.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=active.device)
    n_last = torch.where(active, idx, 0).amax(dim=-1).to(torch.int32)
    return geom.contiguous(), n_last


class TargetBuilder:
    """Per-scale target builder over a batch."""

    def __init__(self, grid_size, image_size, anchors, anchor_mask, num_classes,
                 center_region=0.6, valid_region=0.6, label_smooth=False,
                 obj_ignore_threshold=0.5, device=None):
        self.device = resolve_device(device)
        self.grid_h, self.grid_w = _pair(grid_size)
        self.image_h, self.image_w = _pair(image_size)
        self.anchor_mask = list(anchor_mask)
        self.num_anchors = len(self.anchor_mask)
        self.num_classes = num_classes
        self.center_region = center_region
        self.valid_region = valid_region
        self.label_smooth = 1.0 / max(num_classes, 40) if label_smooth else 0.0
        self.obj_ignore_threshold = obj_ignore_threshold

        image_wh = np.array([self.image_w, self.image_h], np.float32)
        grid_wh = np.array([self.grid_w, self.grid_h], np.float32)
        scale_wh = image_wh / grid_wh  # pixels per grid cell
        all_anchors = np.asarray(anchors, np.float32)
        grid_all_anchors = all_anchors / scale_wh
        self.pixel_anchors = all_anchors[self.anchor_mask]  # (A, 2) pixels
        lookup = np.full(len(all_anchors), -1, np.int64)  # global -> local, or -1
        for i, a in enumerate(self.anchor_mask):
            lookup[a] = i

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

        self.grid4 = dev([self.grid_w, self.grid_h, self.grid_w, self.grid_h])
        self.scale_wh = dev([float(scale_wh[0]), float(scale_wh[1])])
        self.grid_all_anchors = dev(grid_all_anchors)
        self.grid_anchors = dev(grid_all_anchors[self.anchor_mask])
        self.local_anchor = dev(lookup, torch.int64)
        self.anchor_ids = dev(self.anchor_mask, torch.int64)

    def match(self, gt_bbox, gt_valid):
        """Anchor assignment: (local index (B, N), matched (B, N)) on this scale."""
        gwh = (gt_bbox * self.grid4)[..., 2:4]
        gwh_safe = torch.where(gt_valid[..., None], gwh, 1.0)
        match_index = anchor_ious(gwh_safe, self.grid_all_anchors).argmax(dim=-1)
        local = self.local_anchor[match_index]
        return local, gt_valid & (local >= 0)

    @torch.no_grad()
    def __call__(self, gt_bbox, gt_cls, gt_mask, gt_valid, pred_boxes):
        """gt_bbox (B, N, 4) normalized cxcywh, gt_cls (B, N), gt_mask
        (B, N, H, W) or packed (B, N, H, W/8), gt_valid (B, N), pred_boxes
        (B, A*nH*nW, 4) in grid units -> the 7 bbox targets and this scale's
        own orientation targets (pos, neg, torien) on its A anchors."""
        bbox_t, (gxy, gwh, ma, matched) = self._bbox_targets(
            gt_bbox, gt_cls, gt_valid, pred_boxes)
        centers = gxy * self.scale_wh
        vwh = (gwh * self.valid_region + 0.5) * self.scale_wh
        cwh = vwh / self.valid_region * self.center_region
        bounds = _bounds(centers, vwh, self.image_h, self.image_w)
        geom, n_last = kernel_geometry(centers, cwh, bounds, ma, matched)
        orien = paint_orientation(geom, n_last, gt_mask, self.pixel_anchors,
                                  (self.image_h, self.image_w))
        return (*bbox_t, *orien)

    @torch.no_grad()
    def bbox_targets(self, gt_bbox, gt_cls, gt_valid, pred_boxes):
        """The 7 bbox-side targets only (the orientation is painted for all
        scales by ``OrientationPainter``)."""
        return self._bbox_targets(gt_bbox, gt_cls, gt_valid, pred_boxes)[0]

    def _bbox_targets(self, gt_bbox, gt_cls, gt_valid, pred_boxes):
        na, nh, nw = self.num_anchors, self.grid_h, self.grid_w
        ncell = na * nh * nw
        b, n = gt_bbox.shape[:2]
        c = self.num_classes
        dev = gt_bbox.device

        g = gt_bbox * self.grid4
        gxy, gwh = g[..., 0:2], g[..., 2:4]
        gwh_safe = torch.where(gt_valid[..., None], gwh, 1.0)

        # ignore mask: any GT overlapping a prediction strongly enough
        iou_pg = torch.where(gt_valid[:, None, :], bbox_ious(pred_boxes, g), 0.0)  # (B, P, N)
        ignore = (iou_pg > self.obj_ignore_threshold).any(dim=-1)

        local, matched = self.match(gt_bbox, gt_valid)
        ma = local.clamp_min(0)
        gx = torch.clamp(torch.floor(gxy[..., 0]), 0, nw - 1).long()
        gy = torch.clamp(torch.floor(gxy[..., 1]), 0, nh - 1).long()
        cell = (ma * nh + gy) * nw + gx
        cell_s = torch.where(matched, cell, ncell)  # a dummy slot for the unmatched

        # last instance wins: scatter-max of the instance index per cell
        karange = torch.arange(n, device=dev).expand(b, n)
        winner = torch.full((b, ncell + 1), -1, dtype=torch.int64, device=dev).scatter_reduce(
            1, cell_s, karange, "amax", include_self=True)[:, :ncell]
        has_pos = winner >= 0
        wi = winner.clamp_min(0)

        pos_f = has_pos.float()
        bbox_pos_mask = pos_f.view(b, na, nh, nw)
        bbox_neg_mask = ((~ignore) & (~has_pos)).float().view(b, na, nh, nw)

        pos_scale_k = 2.0 - gwh[..., 0] * gwh[..., 1] / (nw * nh)
        txy_k = gxy - torch.floor(gxy)
        twh_k = torch.log(gwh_safe / self.grid_anchors[ma])
        table = torch.cat([pos_scale_k[..., None], txy_k, twh_k], dim=-1)  # (B, N, 5)
        picked = torch.gather(table, 1, wi[..., None].expand(b, ncell, 5)) * pos_f[..., None]
        bbox_pos_scale = picked[..., 0].view(b, na, nh, nw)
        txy = picked[..., 1:3].reshape(b, na, nh, nw, 2)
        twh = picked[..., 3:5].reshape(b, na, nh, nw, 2)
        tiou = torch.where(has_pos, torch.gather(iou_pg, 2, wi[..., None])[..., 0], 0.0)
        tiou = tiou.view(b, na, nh, nw)

        # multi-hot tcls (reference quirk: every matched instance sets its bit)
        cls_idx = torch.where(matched, cell * c + gt_cls.long(), ncell * c)
        hot = torch.zeros((b, ncell * c + 1), device=dev).scatter_(1, cls_idx, 1.0)[:, :ncell * c]
        ls = self.label_smooth
        tcls = (ls + hot * (1.0 - 2.0 * ls)).view(b, na, nh, nw, c)

        bbox_t = (bbox_pos_mask, bbox_neg_mask, bbox_pos_scale, txy, twh, tiou, tcls)
        return bbox_t, (gxy, gwh, ma, matched)


class OrientationPainter:
    """Orientation targets of all scales in one pass on a nine-anchor canvas.

    Each instance's geometry uses the grid of the scale that owns its anchor,
    with TargetBuilder's sequence of operations."""

    def __init__(self, image_size, anchors, anchor_mask, grid_size,
                 center_region=0.6, valid_region=0.6, device=None):
        self.device = resolve_device(device)
        self.image_h, self.image_w = _pair(image_size)
        self.center_region = center_region
        self.valid_region = valid_region
        self.pixel_anchors = np.asarray(anchors, np.float32)  # (A_all, 2)
        n_all = len(self.pixel_anchors)
        self.num_anchors = n_all
        image_wh = np.array([self.image_w, self.image_h], np.float32)
        anchor_grid_wh = np.ones((n_all, 2), np.float32)
        anchor_scale_wh = np.ones((n_all, 2), np.float32)
        for s, mask in enumerate(anchor_mask):
            gh, gw = _pair(grid_size[s])
            grid_wh = np.array([gw, gh], np.float32)
            for a in mask:
                anchor_grid_wh[a] = grid_wh
                anchor_scale_wh[a] = image_wh / grid_wh
        self.anchor_grid_wh = torch.from_numpy(anchor_grid_wh).to(self.device)
        self.anchor_scale_wh = torch.from_numpy(anchor_scale_wh).to(self.device)

    def _geometry(self, gt_bbox, global_anchor):
        ga = global_anchor.clamp_min(0)
        grid_wh = self.anchor_grid_wh[ga]  # (B, N, 2) [nW, nH]
        swh = self.anchor_scale_wh[ga]  # (B, N, 2) [sw, sh]
        g = gt_bbox * torch.cat([grid_wh, grid_wh], dim=-1)
        gxy, gwh = g[..., 0:2], g[..., 2:4]
        centers = gxy * swh
        vwh = (gwh * self.valid_region + 0.5) * swh
        cwh = vwh / self.valid_region * self.center_region
        return centers, cwh, _bounds(centers, vwh, self.image_h, self.image_w)

    @torch.no_grad()
    def kernel_inputs(self, gt_bbox, global_anchor, matched):
        """(B, N, 10) geometry rows and (B,) int32 trip counts for ``ops/paint.py``."""
        centers, cwh, bounds = self._geometry(gt_bbox, global_anchor)
        return kernel_geometry(centers, cwh, bounds, global_anchor.clamp_min(0), matched)

    @torch.no_grad()
    def __call__(self, gt_bbox, global_anchor, matched, gt_mask):
        """gt_bbox (B, N, 4), global_anchor (B, N) in [0, A_all) where
        matched, gt_mask (B, N, H, W) or packed -> pos, neg (B, A_all, H, W)
        and torien (B, A_all, H, W, 2)."""
        geom, n_last = self.kernel_inputs(gt_bbox, global_anchor, matched)
        return paint_orientation(geom, n_last, gt_mask, self.pixel_anchors,
                                 (self.image_h, self.image_w))
