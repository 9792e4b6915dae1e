"""OrienMask multi-scale loss (counterpart of ``orienmask_tpu/ops/loss.py``).

Predictions arrive in the JAX layout, (B, nH, nW, A*(5+C)) and
(B, H/4, W/4, 2A) per scale.  Targets are built under ``no_grad`` and the
decoded boxes of the ignore test are detached, so the gradient flows through
the predictions alone; the x4 orientation upsample is two matmuls
(``models/layers.py::resize_nhwc``) and carries it.  BCE terms are computed
from logits.  Log values stay device scalars: nothing here waits for the
card.  The shared painter path paints all scales once with kernel 5
(``OrientationPainter``); the tensor's device picks the kernel or its plain
version (``ops/paint.py``).

Under a process group the divisors are the global batch's (JAX
``ops/loss.py:128-166`` on a sharded batch): each scale's counts (the
samples or their weights' sum, the orientation positives and negatives, the
box positives) are summed over the ranks, all three scales' in one
``all_reduce`` a call (``utils/envs.py::all_reduce_sum``, the identity
without a group).  A rank's loss and log terms are its own numerators over
those divisors, so the ranks' terms add up to the global batch's.  The
metric pairs stay this rank's sums; the eval step adds them over the ranks.
``reduce`` (default ``all_reduce_sum``) is that sum: under a space group
the loss is whole on every space rank, and its counts sum over the data
group (``parallel/spatial.py::all_reduce_data``).
"""

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import resize_matrices, resize_nhwc
from ..utils.envs import all_reduce_sum
from .targets import OrientationPainter, TargetBuilder, _pair


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy from logits."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


class OrienMaskYOLOLoss:
    """Single-scale loss."""

    def __init__(self, grid_size, image_size, anchors, anchor_mask, num_classes,
                 loss_id, loss_sum_id, metric_id, center_region=0.6, valid_region=0.6,
                 label_smooth=False, obj_ignore_threshold=0.5, weight=None, device=None):
        self.device = resolve_device(device)
        self.grid_h, self.grid_w = _pair(grid_size)
        self.image_h, self.image_w = _pair(image_size)
        self.anchor_mask = list(anchor_mask)
        self.num_anchors = len(self.anchor_mask)
        self.num_classes = num_classes
        self.loss_id = loss_id
        self.loss_sum_id = loss_sum_id
        self.metric_id = metric_id or tuple()
        weight = np.asarray(weight if weight is not None else np.ones(len(loss_id)), np.float32)
        self.weight = torch.from_numpy(weight).to(self.device)
        self.target_builder = TargetBuilder(
            grid_size, image_size, anchors, anchor_mask, num_classes, center_region,
            valid_region, label_smooth, obj_ignore_threshold, device=self.device)
        self.mesh_x = torch.arange(self.grid_w, dtype=torch.float32, device=self.device)
        self.mesh_y = torch.arange(self.grid_h, dtype=torch.float32, device=self.device)[:, None]
        self._resize = {}  # orientation map (h, w) -> x4 upsample matrices

    def __call__(self, predict, target, training=True, orien=None, reduce=all_reduce_sum):
        terms = self._local_terms(predict, target, training, orien)
        return self._combine(terms, reduce(terms["counts"]))

    def _combine(self, terms, counts):
        """The loss of ``_local_terms``' numerators over the global
        ``counts``, its log and the metric pairs."""
        loss_cat = torch.stack(self._loss_items(terms, counts)) * self.weight
        loss_log = {k: v for k, v in zip(self.loss_id, loss_cat)}
        metric_log = {k: v for k, v in zip(self.metric_id, terms["metrics"])}
        loss_sum = loss_cat.sum()
        loss_log[self.loss_sum_id] = loss_sum
        return loss_sum, loss_log, metric_log

    def _upsample(self, pred_orien):
        hw = tuple(pred_orien.shape[1:3])
        if hw not in self._resize:
            self._resize[hw] = resize_matrices(hw, (self.image_h, self.image_w), False,
                                               self.device)
        return resize_nhwc(pred_orien, *self._resize[hw])

    def _local_terms(self, predict, target, training=True, orien=None):
        """This rank's numerators (``sums``), its counts (the divisor, the
        orientation positives and negatives, the box positives: ``counts``)
        and its metric pairs (``metrics``, empty in training)."""
        pred_bbox, pred_orien = predict
        nb = pred_bbox.shape[0]
        na, nh, nw = self.num_anchors, self.grid_h, self.grid_w
        h, w = self.image_h, self.image_w

        # (B, nH, nW, A*(5+C)) -> (B, A, nH, nW, 5+C)
        pb = pred_bbox.reshape(nb, nh, nw, na, 5 + self.num_classes).permute(0, 3, 1, 2, 4)
        # (B, h4, w4, A*2) -> upsample x4 -> (B, A, H, W, 2)
        po = self._upsample(pred_orien).reshape(nb, h, w, na, 2).permute(0, 3, 1, 2, 4)

        xy_logit = pb[..., 0:2]
        pred_xy = torch.sigmoid(xy_logit)
        pred_wh = pb[..., 2:4]
        obj_logit = pb[..., 4]
        cls_logit = pb[..., 5:]

        tb = self.target_builder
        with torch.no_grad():
            # decoded boxes for the ignore test (grid units, detached)
            ganch = tb.grid_anchors
            bx = pred_xy[..., 0] + self.mesh_x
            by = pred_xy[..., 1] + self.mesh_y
            bw = torch.exp(pred_wh[..., 0]) * ganch[:, 0].view(1, -1, 1, 1)
            bh = torch.exp(pred_wh[..., 1]) * ganch[:, 1].view(1, -1, 1, 1)
            pred_boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(nb, -1, 4)
            if orien is None:
                # standalone path: this scale paints its own orientation targets
                (bbox_pos_mask, bbox_neg_mask, bbox_pos_scale, txy, twh, tiou, tcls,
                 orien_pos_mask, orien_neg_mask, torien) = tb(
                    target["bbox"], target["cls"], target["mask"], target["valid"], pred_boxes)
            else:
                # shared path: painted once for all scales and sliced by the caller
                (bbox_pos_mask, bbox_neg_mask, bbox_pos_scale, txy, twh, tiou,
                 tcls) = tb.bbox_targets(target["bbox"], target["cls"], target["valid"],
                                         pred_boxes)
                orien_pos_mask, orien_neg_mask, torien = orien

        # Optional per-sample weights (0 for wrap-padded eval samples) scale
        # the selector masks only, never the BCE targets.
        sw = target.get("sample_weight")
        if sw is not None:
            wb = sw[:, None, None, None]
            n_samples = sw.sum()
            pos_sel = bbox_pos_mask * wb
            neg_sel = bbox_neg_mask * wb
            pos_scale_sel = bbox_pos_scale * wb
            orien_pos_sel = orien_pos_mask * wb
            orien_neg_sel = orien_neg_mask * wb
        else:
            n_samples = pred_bbox.new_full((), float(nb))  # a fill on the device, no copy
            pos_sel = bbox_pos_mask
            neg_sel = bbox_neg_mask
            pos_scale_sel = bbox_pos_scale
            orien_pos_sel = orien_pos_mask
            orien_neg_sel = orien_neg_mask

        loss_obj_all = bce_with_logits(obj_logit, bbox_pos_mask)
        loss_orien_all = smooth_l1(po, torien)
        sums = {
            "xy": (bce_with_logits(xy_logit, txy) * pos_scale_sel[..., None]).sum(),
            "wh": ((pred_wh - twh).square() * pos_scale_sel[..., None]).sum() / 2,
            "obj_pos": (loss_obj_all * pos_sel).sum(),
            "obj_neg": (loss_obj_all * neg_sel).sum(),
            "cls": (bce_with_logits(cls_logit, tcls) * pos_sel[..., None]).sum(),
            "orien_pos": (loss_orien_all * orien_pos_sel[..., None]).sum(),
            "orien_neg": (loss_orien_all * orien_neg_sel[..., None]).sum(),
        }
        num_orien_pos = orien_pos_sel.sum()
        num_orien_neg = orien_neg_sel.sum()
        bbox_pos_count = pos_sel.sum()
        counts = torch.stack([n_samples, num_orien_pos, num_orien_neg, bbox_pos_count])

        metric_items = ()
        if not training:
            with torch.no_grad():
                pred_obj = torch.sigmoid(obj_logit)
                pred_cls = torch.sigmoid(cls_logit)
                bbox_neg_count = neg_sel.sum()
                orien_delta = (po - torien).abs()
                metric_items = (
                    ((pred_cls * (tcls > 0.5) * pos_sel[..., None]).sum(),
                     bbox_pos_count),                                          # cls_conf
                    ((pred_obj * pos_sel).sum(), bbox_pos_count),              # obj_pos
                    ((pred_obj * neg_sel).sum(), bbox_neg_count),              # obj_neg
                    ((tiou * pos_sel).sum(), bbox_pos_count),                  # avg_iou
                    (((tiou > 0.5) * pos_sel).sum(), bbox_pos_count),          # recall50
                    (((tiou > 0.75) * pos_sel).sum(), bbox_pos_count),         # recall75
                    (((orien_delta < 0.5) * orien_pos_sel[..., None]).sum(),
                     num_orien_pos * 2),                                       # orien_pos_acc
                    (((orien_delta < 0.5) * orien_neg_sel[..., None]).sum(),
                     num_orien_neg * 2),                                       # orien_neg_acc
                )
        return {"sums": sums, "counts": counts, "metrics": metric_items}

    @staticmethod
    def _loss_items(terms, counts):
        """The seven loss terms: local numerators over the global counts
        (JAX ``ops/loss.py:128-166`` on the global batch), so that the
        ranks' terms add up to the global batch's."""
        sums = terms["sums"]
        div = counts[0].clamp_min(1.0)
        num_orien_pos, num_orien_neg, bbox_pos_count = counts[1], counts[2], counts[3]
        loss_orien_pos = torch.where(
            num_orien_pos > 0,
            sums["orien_pos"] / num_orien_pos.clamp_min(1) * bbox_pos_count / div, 0.0)
        loss_orien_neg = torch.where(
            num_orien_neg > 0,
            sums["orien_neg"] / num_orien_neg.clamp_min(1) * bbox_pos_count / div, 0.0)
        return (sums["xy"] / div, sums["wh"] / div, sums["obj_pos"] / div,
                sums["obj_neg"] / div, sums["cls"] / div, loss_orien_pos, loss_orien_neg)


class OrienMaskYOLOMultiScaleLoss:
    """One per-scale loss per grid size, aggregated with ``scales_weight``."""

    def __init__(self, grid_size, image_size, anchors, anchor_mask, num_classes,
                 loss_id=("loss_xy", "loss_wh", "loss_obj", "loss_noobj",
                          "loss_cls", "loss_orien_pos", "loss_orien_neg"),
                 loss_sum_id="loss_sum", scales_id=("S32", "S16", "S08"),
                 metric_id=("cls_conf", "obj_pos", "obj_neg", "avg_iou",
                            "recall50", "recall75", "orien_pos_acc", "orien_neg_acc"),
                 # NOTE: valid_region defaults to 0.7 here but 0.6 in the
                 # per-scale OrienMaskYOLOLoss, a reference quirk kept as it
                 # is; every shipped config passes 0.6.
                 center_region=0.6, valid_region=0.7, label_smooth=False,
                 obj_ignore_threshold=0.5, weight=None, scales_weight=None, device=None):
        assert len(grid_size) == len(anchor_mask) == len(scales_id)
        self.device = resolve_device(device)
        self.num_scales = len(scales_id)
        self.loss_suffix = list(loss_id) + [loss_sum_id]
        self.metric_suffix = list(metric_id)
        self.scales_prefix = list(scales_id)
        self.loss_sum_id = loss_sum_id
        scales_weight = np.asarray(
            scales_weight if scales_weight is not None else np.ones(self.num_scales), np.float32)
        self.scales_weight = torch.from_numpy(scales_weight).to(self.device)

        self.loss_id, self.metric_id = [], []
        self.scale_losses = []
        for i, sid in enumerate(scales_id):
            s_loss_id = [f"{sid}_{x}" for x in loss_id]
            s_sum_id = f"{sid}_{loss_sum_id}"
            s_metric_id = [f"{sid}_{x}" for x in metric_id]
            self.loss_id += s_loss_id + [s_sum_id]
            self.metric_id += s_metric_id
            # scales_weight is applied once, at the aggregation below
            self.scale_losses.append(OrienMaskYOLOLoss(
                grid_size[i], image_size, anchors, anchor_mask[i], num_classes,
                s_loss_id, s_sum_id, s_metric_id, center_region, valid_region,
                label_smooth, obj_ignore_threshold, weight, device=self.device))
        self.loss_id += [f"cross_scale_{x}" for x in self.loss_suffix]
        self.metric_id += [f"cross_scale_{x}" for x in self.metric_suffix]
        self.painter = OrientationPainter(image_size, anchors, anchor_mask, grid_size,
                                          center_region, valid_region, device=self.device)

    def _global_anchor(self, gt_bbox, gt_valid):
        """Global anchor per GT from the per-scale matchers (so the painted
        set agrees with each scale's bbox-side assignment); -1 unmatched."""
        ga = torch.full(gt_bbox.shape[:2], -1, dtype=torch.int64, device=gt_bbox.device)
        for sl in self.scale_losses:
            tb = sl.target_builder
            local, matched = tb.match(gt_bbox, gt_valid)
            ga = torch.where(matched & (ga < 0), tb.anchor_ids[local.clamp_min(0)], ga)
        return ga

    @torch.no_grad()
    def _paint_shared_batch(self, gt_bbox, gt_valid, gt_mask):
        ga = self._global_anchor(gt_bbox, gt_valid)
        return self.painter(gt_bbox, ga, ga >= 0, gt_mask)

    def __call__(self, predict, target, training=True, reduce=all_reduce_sum):
        pos9, neg9, tor9 = self._paint_shared_batch(target["bbox"], target["valid"],
                                                    target["mask"])
        terms = []
        for i, sl in enumerate(self.scale_losses):
            idx = sl.anchor_mask
            if idx == list(range(idx[0], idx[0] + len(idx))):
                lo, hi = idx[0], idx[0] + len(idx)
                orien_i = (pos9[:, lo:hi], neg9[:, lo:hi], tor9[:, lo:hi])
            else:
                ids = sl.target_builder.anchor_ids
                orien_i = (pos9[:, ids], neg9[:, ids], tor9[:, ids])
            terms.append(sl._local_terms(predict[i], target, training, orien=orien_i))
        # every scale's counts over the ranks in one collective
        counts = reduce(torch.stack([t["counts"] for t in terms]))
        loss_list, loss_log, metric_log = [], {}, {}
        for i, sl in enumerate(self.scale_losses):
            s_loss, s_loss_log, s_metric_log = sl._combine(terms[i], counts[i])
            loss_list.append(s_loss)
            loss_log.update(s_loss_log)
            metric_log.update(s_metric_log)

        sw = self.scales_weight
        loss_sum = (torch.stack(loss_list) * sw).sum()
        loss_log[self.loss_sum_id] = loss_sum
        for suffix in self.loss_suffix:
            total = 0.0
            for i in range(self.num_scales):
                total = total + loss_log[f"{self.scales_prefix[i]}_{suffix}"] * sw[i]
            loss_log[f"cross_scale_{suffix}"] = total
        if metric_log:
            for suffix in self.metric_suffix:
                num = den = 0.0
                for i in range(self.num_scales):
                    v = metric_log[f"{self.scales_prefix[i]}_{suffix}"]
                    num = num + v[0]
                    den = den + v[1]
                metric_log[f"cross_scale_{suffix}"] = (num, den)
        return loss_sum, loss_log, metric_log
