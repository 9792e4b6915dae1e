"""Self-contained COCO-style detection/segmentation evaluator (the port's own
copy of ``orienmask_tpu/eval/lite_cocoeval.py``).  The greedy matching runs
in the port's native host library (``native.coco_match``), as the JAX
module's does; the Python loop stays as ``_match_plain``, the spec the tests
hold it to.

It re-implements the COCOeval protocol (bbox + segm) against the documented specification: greedy
score-ordered matching per (image, category) at IoU thresholds 0.50:0.05:0.95,
crowd/ignore semantics, 101-point interpolated precision, area ranges
(all/small/medium/large) and maxDets (1/10/100), summarized into the standard
12-stat vector [AP, AP50, AP75, APS, APM, APL, AR1, AR10, AR100, ARS, ARM, ARL].

Mask IoU works on RLE dicts through ``rle``.
"""

import json
from collections import defaultdict

import numpy as np

from .. import native
from . import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_KEYS = ["all", "small", "medium", "large"]
MAX_DETS = [1, 10, 100]


class COCOGroundTruth:
    """Minimal reader of an ``instances_*.json`` annotation file."""

    def __init__(self, gt_file_or_dict):
        if isinstance(gt_file_or_dict, str):
            with open(gt_file_or_dict) as fh:
                data = json.load(fh)
        else:
            data = gt_file_or_dict
        self.images = {im["id"]: im for im in data["images"]}
        self.cat_ids = sorted(c["id"] for c in data["categories"])
        self.anns = defaultdict(list)  # (image_id, cat_id) -> [ann]
        for ann in data.get("annotations", []):
            self.anns[(ann["image_id"], ann["category_id"])].append(ann)
        self.img_ids = sorted(self.images.keys())

    def ann_rle(self, ann):
        """Segmentation of a GT ann as an array-form RLE dict
        {'size', 'counts': int64 array} (cached in the ann, memory-only).

        Polygons go through the pycocotools-exact crossing rasterizer
        (rle.polygons_to_counts) entirely in RLE space — no bitmap decode,
        and no string round-trip (the counts feed IoU/area directly)."""
        cached = ann.get("_rle")
        if cached is not None:
            return cached
        seg = ann["segmentation"]
        im = self.images[ann["image_id"]]
        h, w = im["height"], im["width"]
        if isinstance(seg, list):
            counts = rle_codec.polygons_to_counts(seg, h, w)
            out = {"size": [int(h), int(w)], "counts": counts}
        elif isinstance(seg.get("counts"), list):
            out = {"size": seg["size"],
                   "counts": np.asarray(seg["counts"], np.int64)}
        else:
            out = {"size": seg["size"],
                   "counts": rle_codec._raw_counts(seg["counts"])}
        ann["_rle"] = out
        return out


def _bbox_iou_xywh(dt, gt, iscrowd):
    """(n_dt, 4) x (n_gt, 4) xywh -> IoU matrix with crowd semantics."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    iw = (np.minimum(dt[:, None, 0] + dt[:, None, 2], gt[None, :, 0] + gt[None, :, 2])
          - np.maximum(dt[:, None, 0], gt[None, :, 0]))
    ih = (np.minimum(dt[:, None, 1] + dt[:, None, 3], gt[None, :, 1] + gt[None, :, 3])
          - np.maximum(dt[:, None, 1], gt[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, d_area, d_area + g_area - inter)
    out = np.where((inter > 0) & (union > 0), inter / np.maximum(union, 1e-300), 0.0)
    return out


def _native_match(ious, g_order, gi, iscrowd):
    """C++ greedy matcher (native.coco_match) over all IoU thresholds:
    (dt_m (nt, nd) sorted-gt index or -1, dt_ig (nt, nd) bool)."""
    return native.coco_match(ious, g_order, gi, iscrowd, IOU_THRS)


def _match_plain(ious, g_order, gi, iscrowd):
    """``_native_match`` as the Python loop of COCOeval's greedy matching."""
    nt = len(IOU_THRS)
    nd, ng = ious.shape
    dt_m = -np.ones((nt, nd), np.int64)
    gt_m = -np.ones((nt, ng), np.int64)  # sorted-gt space
    dt_ig = np.zeros((nt, nd), bool)

    for ti, t in enumerate(IOU_THRS):
        for di in range(nd):
            best = min(t, 1 - 1e-10)
            m = -1  # sorted-gt index of current match
            for sj in range(ng):
                gj = g_order[sj]
                # gt already matched (crowds may rematch)
                if gt_m[ti, sj] >= 0 and not iscrowd[gj]:
                    continue
                # real match made, reached the ignored tail
                if m > -1 and not gi[m] and gi[sj]:
                    break
                if ious[di, gj] < best:
                    continue
                best = ious[di, gj]
                m = sj
            if m == -1:
                continue
            dt_ig[ti, di] = gi[m]
            dt_m[ti, di] = m
            gt_m[ti, m] = di
    return dt_m, dt_ig


def _segm_iou(dt_rles, gt_rles, iscrowd):
    if not dt_rles or not gt_rles:
        return np.zeros((len(dt_rles), len(gt_rles)))
    return rle_codec.iou(dt_rles, gt_rles, iscrowd)


class LiteCOCOeval:
    """Evaluate a COCO-format results list against ground truth.

    Args:
      gt: COCOGroundTruth
      results: list of result dicts (bbox results need 'bbox'; segm need
        'segmentation' RLE) with 'image_id', 'category_id', 'score'.
      iou_type: 'bbox' | 'segm'
    """

    def __init__(self, gt, results, iou_type="bbox"):
        self.gt = gt
        self.iou_type = iou_type
        self.dets = defaultdict(list)
        for r in results:
            self.dets[(r["image_id"], r["category_id"])].append(r)
        self.stats = None
        self.eval = None

    # ------------------------------------------------------------- matching

    @staticmethod
    def _counts_form(r):
        """RLE dict -> array-form RLE {'size', 'counts': int64 array}.

        Leaves the input dict untouched (detection dicts are later
        json-dumped by the shard-merge protocol; a numpy leaf would break
        that)."""
        counts = r["counts"]
        if isinstance(counts, (str, bytes)):
            return {"size": r["size"], "counts": rle_codec._raw_counts(counts)}
        return {"size": r["size"], "counts": np.asarray(counts, np.int64)}

    def _evaluate_img_cat(self, img_id, cat_id):
        gts = self.gt.anns.get((img_id, cat_id), [])
        dts = self.dets.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        dts = sorted(dts, key=lambda d: -d["score"])[: max(MAX_DETS)]

        if self.iou_type == "bbox":
            g_geom = [g["bbox"] for g in gts]
            d_geom = [d["bbox"] for d in dts]
            d_areas = np.array([b[2] * b[3] for b in d_geom], np.float64)
        else:
            # Decode every RLE's counts string exactly ONCE: the IoU and the
            # area both consume raw counts, and rle._raw_counts passes
            # array-form counts straight through.
            g_geom = [self._counts_form(self.gt.ann_rle(g)) for g in gts]
            d_geom = [self._counts_form(d["segmentation"]) for d in dts]
            d_areas = np.array(
                [int(r["counts"][1::2].sum()) for r in d_geom], np.float64)
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]

        if self.iou_type == "bbox":
            ious = _bbox_iou_xywh(d_geom, g_geom, iscrowd)
        else:
            ious = _segm_iou(d_geom, g_geom, iscrowd)

        g_areas = np.array([g.get("area", 0.0) for g in gts], np.float64)
        d_scores = np.array([d["score"] for d in dts], np.float64)

        out = {}
        for akey in AREA_KEYS:
            lo, hi = AREA_RNG[akey]
            g_ignore_base = np.array(
                [bool(ic) or not (lo <= a <= hi) for ic, a in zip(iscrowd, g_areas)],
                dtype=bool,
            )
            # sort gts: non-ignored first (stable), as COCOeval does
            g_order = np.argsort(g_ignore_base, kind="stable")
            gi = g_ignore_base[g_order]

            dt_m, dt_ig = _native_match(ious, g_order, gi, iscrowd)
            # dets unmatched + outside the area range are ignored
            d_out = (d_areas < lo) | (d_areas > hi)
            dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
            out[akey] = {
                "scores": d_scores,
                "dt_matched": dt_m >= 0,
                "dt_ignore": dt_ig,
                "num_gt": int((~g_ignore_base).sum()),
            }
        return out

    # ----------------------------------------------------------- accumulate

    def evaluate(self):
        cat_ids = self.gt.cat_ids
        nt, nr = len(IOU_THRS), len(REC_THRS)
        nk, na, nm = len(cat_ids), len(AREA_KEYS), len(MAX_DETS)
        precision = -np.ones((nt, nr, nk, na, nm))
        recall = -np.ones((nt, nk, na, nm))

        for ki, cat_id in enumerate(cat_ids):
            per_img = [self._evaluate_img_cat(img_id, cat_id)
                       for img_id in self.gt.img_ids]
            per_img = [p for p in per_img if p is not None]
            for ai, akey in enumerate(AREA_KEYS):
                blocks = [p[akey] for p in per_img]
                num_gt = sum(b["num_gt"] for b in blocks)
                if num_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [b["scores"][:max_det] for b in blocks]
                    ) if blocks else np.zeros(0)
                    matched = np.concatenate(
                        [b["dt_matched"][:, :max_det] for b in blocks], axis=1
                    ) if blocks else np.zeros((nt, 0), bool)
                    ignored = np.concatenate(
                        [b["dt_ignore"][:, :max_det] for b in blocks], axis=1
                    ) if blocks else np.zeros((nt, 0), bool)

                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(nt):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        nd = len(tp)
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # monotone-decreasing precision envelope
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(nr)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.eval = {"precision": precision, "recall": recall}
        return self.eval

    # ------------------------------------------------------------ summarize

    def summarize(self):
        if self.eval is None:
            self.evaluate()
        p, r = self.eval["precision"], self.eval["recall"]

        def ap(iou=None, area="all", max_det=100):
            ai, mi = AREA_KEYS.index(area), MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                s = s[[int(round((iou - 0.5) / 0.05))]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai, mi = AREA_KEYS.index(area), MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        self.stats = np.array([
            ap(), ap(iou=0.5), ap(iou=0.75),
            ap(area="small"), ap(area="medium"), ap(area="large"),
            ar(max_det=1), ar(max_det=10), ar(max_det=100),
            ar(area="small"), ar(area="medium"), ar(area="large"),
        ])
        return self.stats

    def per_category_ap(self):
        """Per-category AP (area=all, maxDet=100), percent scale."""
        if self.eval is None:
            self.evaluate()
        p = self.eval["precision"]
        out = []
        for ki in range(p.shape[2]):
            s = p[:, :, ki, 0, -1]
            s = s[s > -1]
            out.append(float(s.mean() * 100) if s.size else float("nan"))
        return out
