"""COCO metrics accumulation + evaluation (counterpart of
``orienmask_tpu/eval/coco_eval.py``).

Detections (normalized cxcywh + score, bool masks at network resolution, label ids)
are mapped back through the recorded augmentation info (collate_pad / pad / flips) to
original image coordinates, converted to COCO-format dicts (masks RLE-encoded), and
scored with the built-in LiteCOCOeval (pycocotools is used instead when importable —
results are in the official json format either way).

The masks' resize to the original image size is OpenCV's ``INTER_LINEAR``
arithmetic, as the JAX package's cv2 call does it (``ops/resize.py``), then
``np.round``.  Two routes give the same results: ``to_coco_format`` on the
host lists of ``postprocess.to_host_list`` (numpy), and
``to_coco_format_device`` on the postprocess's device outputs, which
recovers the masks where they lie (kernel 6, ``ops/recover.py``) and sends
only column-major bits of the original size to the host, where the native
host library encodes them (``native.rle_encode_colpacked``).
``merge_ranks`` carries the other ranks' results to rank 0 through
``save_as_json`` and ``update_from_json`` (the trainer's and the tester's
shard merge).
"""

import json
import os

import numpy as np

from .. import native
from ..ops.recover import recover_geometry, recover_masks, source_window
from ..ops.resize import resize_masks_linear
from ..utils import timer
from ..utils.envs import barrier, get_device_rank, get_world_size
from . import rle as rle_codec
from .lite_cocoeval import COCOGroundTruth, LiteCOCOeval

METRIC_KEYS = [
    "AP", "AP50", "AP75", "APS", "APM", "APL",
    "AR1", "AR10", "AR100", "ARS", "ARM", "ARL",
]


def _try_pycocotools():
    try:
        from pycocotools.coco import COCO  # noqa: F401
        from pycocotools.cocoeval import COCOeval  # noqa: F401
        return True
    except Exception:
        return False


class COCOMetrics:
    metric_keys = METRIC_KEYS

    def __init__(self, gt_file, cat2label, with_mask, save_dir):
        self.gt_file = gt_file
        self.cat2label = list(cat2label)
        self.with_mask = with_mask
        self.save_dir = save_dir
        self.bbox_pred_file = os.path.join(save_dir, "bbox_prediction.json")
        self.segm_pred_file = os.path.join(save_dir, "segm_prediction.json")
        self.reset()

    def reset(self):
        self.bbox_results = []
        self.segm_results = []
        self.bbox_eval_stats = np.array([])
        self.segm_eval_stats = np.array([])
        self.bbox_eval_per_cats_stats = []
        self.segm_eval_per_cats_stats = []

    # -------------------------------------------------------------- formatting

    def to_coco_format(self, batch_info, detections):
        # skip wrap-padded eval samples (DataLoader pad_last)
        pairs = [(i, d) for i, d in zip(batch_info, detections)
                 if not i.get("_pad", False)]
        batch_info = [p[0] for p in pairs]
        detections = [p[1] for p in pairs]
        with timer.timer("COCO Boxes"):
            out = {"bbox": self._to_bbox_coco_format(batch_info, detections)}
        if self.with_mask:
            out["segm"] = self._to_segm_coco_format(batch_info, detections)
        return out

    def to_coco_format_device(self, batch_info, device_out, image_w):
        """``to_coco_format(batch_info, postprocess.to_host_list(device_out))``
        from the postprocess's device dict (``bbox`` (B, K, 5), ``cls`` (B, K),
        ``mask`` (B, K, H, W/8) packed, ``valid`` (B, K), valid rows first)
        for masks ``image_w`` wide: only the boxes, classes and validity are
        copied whole (one copy a batch); the masks are recovered on their
        device and reach the host as bits of the original size."""
        with timer.timer("To Host List"):
            host = {k: device_out[k].cpu().numpy() for k in ("bbox", "cls", "valid")}
        counts = [0 if info.get("_pad", False) else int(valid.sum())
                  for info, valid in zip(batch_info, host["valid"])]
        kept = [b for b, info in enumerate(batch_info) if not info.get("_pad", False)]
        detections = [{"bbox": host["bbox"][b, :counts[b]], "cls": host["cls"][b, :counts[b]]}
                      for b in kept]
        with timer.timer("COCO Boxes"):
            out = {"bbox": self._to_bbox_coco_format([batch_info[b] for b in kept], detections)}
        if not self.with_mask:
            return out
        packed = device_out["mask"]
        with timer.timer("Mask Resize"):
            geom = recover_geometry(batch_info, counts, (packed.shape[2], image_w),
                                    packed.device)
            words = recover_masks(packed, geom).cpu().numpy()
        results = []
        with timer.timer("RLE Encode"):
            for b, det in zip(kept, detections):
                n, (oh, ow) = counts[b], geom.sizes[b]
                if not n:
                    continue
                strings = native.rle_encode_colpacked(
                    words[geom.offsets[b]:geom.offsets[b + 1]], n, oh, ow)
                cats = [self.cat2label[int(c)] for c in det["cls"].flatten()]
                for counts_str, score, cat in zip(strings, det["bbox"][:, -1], cats):
                    results.append({
                        "image_id": batch_info[b]["id"], "category_id": cat,
                        "segmentation": {"size": [oh, ow], "counts": counts_str},
                        "score": float(score),
                    })
        out["segm"] = results
        return out

    def update_results(self, coco_format):
        self.bbox_results += coco_format["bbox"]
        if self.with_mask:
            self.segm_results += coco_format.get("segm", [])

    def save_as_json(self, filename):
        with open(filename, "w") as fh:
            json.dump({"bbox": self.bbox_results, "segm": self.segm_results}, fh)

    def update_from_json(self, filename):
        with open(filename) as fh:
            update = json.load(fh)
        self.bbox_results += update["bbox"]
        self.segm_results += update["segm"]

    def merge_ranks(self, directory):
        """Every rank's results on rank 0: the other ranks dump theirs into
        ``directory`` (shared by the ranks), and rank 0 reads them after a
        barrier, in rank order (JAX ``trainer/trainer.py:262-283``).
        Nothing without a group."""
        world, rank = get_world_size(), get_device_rank()
        if world < 2:
            return
        if rank != 0:
            self.save_as_json(os.path.join(directory, f"_coco_shard_{rank}.json"))
        barrier()
        if rank == 0:
            for r in range(1, world):
                path = os.path.join(directory, f"_coco_shard_{r}.json")
                self.update_from_json(path)
                os.remove(path)

    def _to_bbox_coco_format(self, batch_info, detections):
        results = []
        for info, det in zip(batch_info, detections):
            bbox = np.asarray(det["bbox"])
            if bbox.size == 0:
                continue
            xywh = self._recover_shape_bbox(bbox[:, :4], info)
            scores = bbox[:, -1]
            cats = [self.cat2label[int(c)] for c in np.asarray(det["cls"]).flatten()]
            for bb, score, cat in zip(xywh, scores, cats):
                results.append({
                    "image_id": info["id"], "category_id": cat,
                    "bbox": [float(v) for v in bb], "score": float(score),
                })
        return results

    def _to_segm_coco_format(self, batch_info, detections):
        results = []
        resize, encode = timer.timer("Mask Resize"), timer.timer("RLE Encode")
        for info, det in zip(batch_info, detections):
            bbox = np.asarray(det["bbox"])
            if bbox.size == 0:
                continue
            with resize:
                masks = self._recover_shape_segm(np.asarray(det["mask"]), info)
            with encode:
                rles = [rle_codec.encode(np.ascontiguousarray(m, np.uint8)) for m in masks]
            scores = bbox[:, -1]
            cats = [self.cat2label[int(c)] for c in np.asarray(det["cls"]).flatten()]
            for rle, score, cat in zip(rles, scores, cats):
                results.append({
                    "image_id": info["id"], "category_id": cat,
                    "segmentation": rle, "score": float(score),
                })
        return results

    @staticmethod
    def _recover_shape_bbox(bbox, info):
        """Normalized cxcywh at network input -> xywh pixels in the original image
        (undo collate_pad, pad, flips; reference coco_eval.py:146-188)."""
        bx, by, bw, bh = [bbox[:, i].astype(np.float64) for i in range(4)]
        if info.get("collate_pad") is not None:
            left, right, top, down, h, w = info["collate_pad"]
            nh, nw = h - top - down, w - left - right
            bx = (bx * w - left) / nw
            by = (by * h - top) / nh
            bw, bh = bw * w / nw, bh * h / nh
        # Undo in reverse forward order: the flips run AFTER Resize's padding
        # (config pipeline), so they must be inverted BEFORE the pad. The
        # reference (coco_eval.py:169-181) unpads first — wrong by
        # (right-left)/nw whenever the padding is asymmetric; unreachable in
        # shipped configs (eval transforms never flip), fixed here for TTA.
        if info.get("hflip", False):
            bx = 1 - bx
        if info.get("vflip", False):
            by = 1 - by
        if info.get("pad") is not None:
            top, down, left, right, h, w = info["pad"]
            nh, nw = h - top - down, w - left - right
            bx = (bx * w - left) / nw
            by = (by * h - top) / nh
            bw, bh = bw * w / nw, bh * h / nh
        oh, ow = info["height"], info["width"]
        return np.stack([
            (bx - bw / 2) * ow, (by - bh / 2) * oh, bw * ow, bh * oh
        ], axis=1)

    @staticmethod
    def _recover_shape_segm(masks, info):
        """(n, H, W) bool -> (n, oh, ow) uint8 in original image geometry:
        the crop of ``collate_pad``, the flips (inverted before the pad, in
        reverse forward order: see _recover_shape_bbox), the crop of
        ``pad`` (``ops/recover.py::source_window``), OpenCV's INTER_LINEAR
        resize and ``np.round``."""
        rows, cols = source_window(info, masks.shape[1], masks.shape[2])
        return resize_masks_linear(masks[:, rows[:, None], cols], info["width"], info["height"])

    # -------------------------------------------------------------- evaluation

    def coco_eval(self, per_cats=False):
        log = {}
        with open(self.bbox_pred_file, "w") as fh:
            json.dump(self.bbox_results, fh)
        if self.with_mask:
            with open(self.segm_pred_file, "w") as fh:
                json.dump(self.segm_results, fh)

        if _try_pycocotools():
            self._eval_pycocotools(per_cats)
        else:
            self._eval_lite(per_cats)

        for key, value in zip(METRIC_KEYS, self.bbox_eval_stats.tolist()):
            log[f"bbox_{key}"] = value
        if self.with_mask:
            for key, value in zip(METRIC_KEYS, self.segm_eval_stats.tolist()):
                log[f"segm_{key}"] = value
        return log

    def _eval_lite(self, per_cats):
        gt = COCOGroundTruth(self.gt_file)
        ev = LiteCOCOeval(gt, self.bbox_results, iou_type="bbox")
        self.bbox_eval_stats = ev.summarize()
        if per_cats:
            self.bbox_eval_per_cats_stats = ev.per_category_ap()
        if self.with_mask:
            evs = LiteCOCOeval(gt, self.segm_results, iou_type="segm")
            self.segm_eval_stats = evs.summarize()
            if per_cats:
                self.segm_eval_per_cats_stats = evs.per_category_ap()

    def _eval_pycocotools(self, per_cats):
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval

        gt_coco = COCO(self.gt_file)
        pd = gt_coco.loadRes(self.bbox_pred_file)
        ev = COCOeval(gt_coco, pd, iouType="bbox")
        ev.evaluate(); ev.accumulate(); ev.summarize()
        self.bbox_eval_stats = ev.stats
        if per_cats:
            self.bbox_eval_per_cats_stats = self._per_cats(ev)
        if self.with_mask:
            pds = gt_coco.loadRes(self.segm_pred_file)
            evs = COCOeval(gt_coco, pds, iouType="segm")
            evs.evaluate(); evs.accumulate(); evs.summarize()
            self.segm_eval_stats = evs.stats
            if per_cats:
                self.segm_eval_per_cats_stats = self._per_cats(evs)

    def _per_cats(self, coco_eval_obj):
        precisions = coco_eval_obj.eval["precision"]
        out = []
        for idx in range(len(self.cat2label)):
            p = precisions[:, :, idx, 0, -1]
            p = p[p > -1]
            out.append(float(p.mean() * 100) if p.size else float("nan"))
        return out
