"""OrienMask postprocess with packed masks (counterpart of
``orienmask_tpu/ops/postprocess.py``), with the batch dimension written out
where JAX ``vmap``s.

Candidate selection, per image, in one of JAX's two modes:
* ``twostage`` (the infer configs): the per-detection max score over the
  three heads, the top ``nms_pre`` detections (kernel 1), their head rows,
  the top ``nms_pre`` (detection, class) pairs (kernel 1);
* ``exact`` (the test and val configs): the flat (P, 5+C) head buffer, the
  top ``nms_pre`` of all P x C (detection, class) pair scores (kernel 1 in
  two levels: 1,456,560 pairs at 544²).
Then box decode, class-offset greedy NMS, the x4-upsampled orientation
field and the packed masks of the kept detections (kernel 2).  Heads arrive
in the JAX layout, (B, H, W, A*(5+C)) and (B, H/4, W/4, 2A) per scale;
flatten order is scale-major then anchor-major, as in JAX.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import resize_matrices
from .masks import assemble_masks_packed
from .maskops import unpack_bits_np
from .nms import NEG_INF, batched_class_nms
from .topk import exact_topk


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


class OrienMaskYOLOPostProcess:
    def __init__(self, grid_size, image_size, anchors, anchor_mask, num_classes,
                 conf_thresh=0.05, nms=None, nms_pre=400, nms_post=100,
                 orien_thresh=0.3, topk_mode="twostage", pack_masks=True,
                 device=None):
        if topk_mode not in ("twostage", "exact") or not pack_masks:
            raise NotImplementedError(
                "only the twostage and exact selections with packed masks are ported")
        self.device = resolve_device(device)
        self.topk_mode = topk_mode
        self.grid_hw = [tuple(g) for g in grid_size]
        self.image_h, self.image_w = _pair(image_size)
        self.anchor_mask = [list(m) for m in anchor_mask]
        self.num_anchors_total = len(anchors)
        self.num_classes = num_classes
        # thresholds as f32 values, the precision JAX compares them in
        self.conf_thresh = float(np.float32(conf_thresh))
        self.nms_threshold = float((nms or {}).get("threshold", 0.5))
        self.nms_pre = int(nms_pre)
        self.nms_post = int(nms_post)
        self.orien_thresh = float(orien_thresh)

        anchors = np.asarray(anchors, np.float32)
        norm_anchors = anchors / np.array([self.image_w, self.image_h], np.float32)

        # Per-flat-prediction decode constants: anchor, grid cell, grid size.
        det_anchor, gx, gy, gnw, gnh = [], [], [], [], []
        for (nh, nw), mask in zip(self.grid_hw, self.anchor_mask):
            na = len(mask)
            det_anchor.append(np.repeat(np.asarray(mask, np.int32), nh * nw))
            gy_s, gx_s = np.mgrid[0:nh, 0:nw]
            gx.append(np.tile(gx_s.ravel(), na))
            gy.append(np.tile(gy_s.ravel(), na))
            gnw.append(np.full(na * nh * nw, nw, np.float32))
            gnh.append(np.full(na * nh * nw, nh, np.float32))

        # Orientation channel permutation, scale-major -> global anchor order.
        perm = np.zeros(self.num_anchors_total * 2, np.int64)
        c = 0
        for mask in self.anchor_mask:
            for a in mask:
                perm[2 * a], perm[2 * a + 1] = c, c + 1
                c += 2

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.norm_anchors = dev(norm_anchors)
        self.det_anchor_idx = dev(np.concatenate(det_anchor))
        self.det_grid_x = dev(np.concatenate(gx).astype(np.float32))
        self.det_grid_y = dev(np.concatenate(gy).astype(np.float32))
        self.det_grid_nw = dev(np.concatenate(gnw))
        self.det_grid_nh = dev(np.concatenate(gnh))
        self.orien_channel_perm = dev(perm)
        self._resize = {}  # (h4, w4) -> (mh, mw^T)

    # ------------------------------------------------------------- detect

    def _decode_rows(self, rows, det_idx):
        """Gathered head rows (B, n, 5+C) -> (B, n, 4) normalized cxcywh."""
        awh = self.norm_anchors[self.det_anchor_idx[det_idx].long()]
        x = (torch.sigmoid(rows[..., 0]) + self.det_grid_x[det_idx]) / self.det_grid_nw[det_idx]
        y = (torch.sigmoid(rows[..., 1]) + self.det_grid_y[det_idx]) / self.det_grid_nh[det_idx]
        w = torch.exp(rows[..., 2]) * awh[..., 0]
        h = torch.exp(rows[..., 3]) * awh[..., 1]
        return torch.stack([x, y, w, h], dim=-1)

    def _topk(self, x, k):
        """Selection top-k (kernel 1 on the card)."""
        return exact_topk(x, k)

    def _assemble_masks(self, field, boxes, anchor_idx, valid, coord_h=None, row0=0):
        """Packed masks of the kept detections, empty for the invalid ones
        (kernel 2 on the card); ``coord_h``/``row0`` for a row block."""
        return assemble_masks_packed(field, boxes, anchor_idx, self.norm_anchors,
                                     self.orien_thresh, coord_h=coord_h, row0=row0, valid=valid)

    def _flat_scores(self, pred_bboxes):
        """(B, P) per-detection max score, reduced in each head's native
        (B, H, W, A, 5+C) layout, flattened scale-major then anchor-major."""
        c = self.num_classes
        scores = []
        for i, bbox in enumerate(pred_bboxes):
            b, nh, nw, _ = bbox.shape
            x = bbox.reshape(b, nh, nw, len(self.anchor_mask[i]), 5 + c)
            s = torch.sigmoid(x[..., 5:].amax(dim=-1)) * torch.sigmoid(x[..., 4])
            scores.append(s.permute(0, 3, 1, 2).reshape(b, -1))
        return torch.cat(scores, dim=1)

    def _flat_head(self, pred_bboxes):
        """(B, P, 5+C) raw head rows, scale-major then anchor-major: the one
        buffer the exact selection and its decode read."""
        c = self.num_classes
        rows = []
        for i, bbox in enumerate(pred_bboxes):
            b, nh, nw, _ = bbox.shape
            na = len(self.anchor_mask[i])
            rows.append(bbox.reshape(b, nh, nw, na, 5 + c).permute(0, 3, 1, 2, 4)
                        .reshape(b, -1, 5 + c))
        return torch.cat(rows, dim=1)

    def _select_exact(self, pred_bboxes):
        """Exact selection: the top ``nms_pre`` of every (detection, class)
        pair score above the threshold -> (scores, det_idx, cls_idx,
        candidate head rows), each (B, nms_pre[, 5+C])."""
        c = self.num_classes
        flat = self._flat_head(pred_bboxes)
        conf = torch.sigmoid(flat[..., 5:]) * torch.sigmoid(flat[..., 4:5])
        conf = torch.where(conf > self.conf_thresh, conf, -1.0)
        scores, idx = self._topk(conf.reshape(flat.shape[0], -1), self.nms_pre)
        det_idx = idx // c
        rows = torch.gather(flat, 1, det_idx[..., None].expand(-1, -1, 5 + c))
        return scores, det_idx, idx % c, rows

    def _select_twostage(self, pred_bboxes):
        """Twostage selection: the top ``nms_pre`` detections by their max
        score, then the top ``nms_pre`` pairs among them; same outputs as
        ``_select_exact``."""
        c = self.num_classes
        thr = self.conf_thresh
        b = pred_bboxes[0].shape[0]
        det_max = self._flat_scores(pred_bboxes)
        det_max = torch.where(det_max > thr, det_max, -1.0)
        _, top_det = self._topk(det_max, self.nms_pre)
        sub_rows = self._gather_rows(pred_bboxes, top_det)
        sub = torch.sigmoid(sub_rows[..., 5:]) * torch.sigmoid(sub_rows[..., 4:5])
        sub = torch.where(sub > thr, sub, -1.0)
        scores, idx = self._topk(sub.reshape(b, -1), self.nms_pre)
        det_sel = idx // c
        rows = torch.gather(sub_rows, 1, det_sel[..., None].expand(-1, -1, 5 + c))
        return scores, torch.gather(top_det, 1, det_sel), idx % c, rows

    def _gather_rows(self, pred_bboxes, det_idx):
        """Head rows (B, n, 5+C) of flat indices ``det_idx`` (B, n), gathered
        from the native-layout heads by (a, y, x) -> (y, x, a) arithmetic."""
        c = self.num_classes
        out = None
        off = 0
        for i, bbox in enumerate(pred_bboxes):
            b, nh, nw, _ = bbox.shape
            na = len(self.anchor_mask[i])
            size = na * nh * nw
            local = det_idx - off
            inside = (local >= 0) & (local < size)
            lc = local.clamp(0, size - 1)
            a, cell = lc // (nh * nw), lc % (nh * nw)
            native = bbox.reshape(b, nh * nw * na, 5 + c)
            rows = torch.gather(native, 1, (cell * na + a)[..., None].expand(-1, -1, 5 + c))
            out = rows if out is None else torch.where(inside[..., None], rows, out)
            off += size
        return out

    def _detect(self, pred_bboxes):
        """Candidate selection, decode and NMS for a batch (JAX
        ``_detect_image`` under ``vmap``); no masks."""
        select = self._select_exact if self.topk_mode == "exact" else self._select_twostage
        scores, det_idx, cls_idx, cand_rows = select(pred_bboxes)
        valid = scores > self.conf_thresh
        cand_boxes = self._decode_rows(cand_rows, det_idx)
        cand_anchor = self.det_anchor_idx[det_idx]
        # scores come out of a top-k, so they are already descending
        nms_scores = torch.where(valid, scores, NEG_INF)
        keep_idx, keep_valid = batched_class_nms(
            cand_boxes, nms_scores, cls_idx, self.nms_post, self.nms_threshold)
        boxes = torch.gather(cand_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
        out_scores = torch.where(keep_valid, torch.gather(scores, 1, keep_idx), 0.0)
        return {
            "bbox": torch.cat([boxes, out_scores[..., None]], dim=-1),
            "cls": torch.gather(cls_idx, 1, keep_idx).to(torch.int32),
            "anchor": torch.gather(cand_anchor, 1, keep_idx),
            "valid": keep_valid,
        }

    # -------------------------------------------------------------- masks

    def _upsample_orientation(self, pred_oriens, rows=None):
        """3x (B, H/4, W/4, 2A_s) -> (B, A_total, 2, H, W) in global anchor
        order, the mask kernel's layout.  The channel permutation runs before
        the x4 bilinear upsample (two matmuls, along H then W).  ``rows``
        (first row, rows): that row block of the output alone, from the
        same rows of the upsample matrix."""
        x = torch.cat([o.permute(0, 3, 1, 2) for o in pred_oriens], dim=1)
        x = x.index_select(1, self.orien_channel_perm)
        h4, w4 = x.shape[-2:]
        if (h4, w4) not in self._resize:
            mh, mw = resize_matrices((h4, w4), (self.image_h, self.image_w), False,
                                     self.device)
            self._resize[(h4, w4)] = (mh, mw.t().contiguous())
        mh, mw_t = self._resize[(h4, w4)]
        if rows is not None:
            mh = mh[rows[0]:rows[0] + rows[1]]
        up = torch.matmul(torch.matmul(mh, x), mw_t)
        return up.reshape(x.shape[0], self.num_anchors_total, 2, mh.shape[0], self.image_w)

    def _run_batch(self, predict):
        """predict: 3x (bbox, orien) in the JAX layout -> device dict
        {'bbox' (B,K,5) f32, 'cls' (B,K) int32, 'mask' (B,K,H,W/8) uint8,
        'valid' (B,K) bool}."""
        field = self._upsample_orientation([p[1] for p in predict])
        det = self._detect([p[0] for p in predict])
        # invalid rows get empty masks inside the kernel (JAX multiplies
        # them by ``valid`` afterwards)
        masks = self._assemble_masks(field, det["bbox"][..., :4].contiguous(),
                                     det["anchor"], det["valid"])
        return {"bbox": det["bbox"], "cls": det["cls"], "mask": masks,
                "valid": det["valid"]}

    @torch.inference_mode()
    def apply_device(self, predict):
        """Batch postprocess; outputs stay on the device."""
        return self._run_batch(predict)

    def __call__(self, predict):
        """List (len B) of per-image dicts trimmed to the valid detections,
        as host numpy arrays with unpacked (n, H, W) bool masks."""
        return self.to_host_list(self.apply_device(predict))

    def to_host_list(self, device_out):
        out = {k: v.cpu().numpy() for k, v in device_out.items()}
        results = []
        for b in range(out["bbox"].shape[0]):
            n = int(out["valid"][b].sum())
            results.append({
                "bbox": out["bbox"][b, :n],
                # unpack after the trim: most of the padded rows are invalid
                "mask": unpack_bits_np(out["mask"][b, :n], self.image_w),
                "cls": out["cls"][b, :n],
            })
        return results
