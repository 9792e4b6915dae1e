"""The port's COCO evaluation (orienmask_tpu_torch/eval) against
orienmask_tpu.eval on the same seeded masks, ground truth and detections:
the RLE codec, LiteCOCOeval's 12-stat vectors (to 1e-12) and
COCOMetrics.to_coco_format (original sizes other than the network size,
pad and flip info, the ``_pad`` skip)."""

import json
import time

import numpy as np
import pytest
import torch

from orienmask_tpu.eval import rle as jax_rle
from orienmask_tpu.eval.coco_eval import COCOMetrics as JaxCOCOMetrics
from orienmask_tpu.eval.lite_cocoeval import COCOGroundTruth as JaxGroundTruth
from orienmask_tpu.eval.lite_cocoeval import LiteCOCOeval as JaxLiteCOCOeval
from orienmask_tpu_torch.data import make_scenes
from orienmask_tpu_torch.eval import COCOGroundTruth, COCOMetrics, LiteCOCOeval, rle
from orienmask_tpu_torch.utils import timer

NET = 64  # network size of the detections


def _masks(seed, n, h, w):
    """Random rectangles, ellipses and noise, plus an empty and a full mask."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    out = [np.zeros((h, w), bool), np.ones((h, w), bool), rng.uniform(size=(h, w)) < 0.3]
    for _ in range(n):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        rx, ry = rng.uniform(0.5, max(1, w / 2)), rng.uniform(0.5, max(1, h / 2))
        if rng.random() < 0.5:
            out.append((np.abs(xs - cx) <= rx) & (np.abs(ys - cy) <= ry))
        else:
            out.append(((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1)
    return np.stack(out).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(37, 53), (64, 64), (1, 1)])
def test_rle_matches_jax(h, w):
    masks = _masks(h * w, 6, h, w)
    got = rle.encode_batch(masks)
    want = jax_rle.encode_batch(masks)
    assert got == want
    for m, enc in zip(masks, got):
        assert rle.encode(m) == jax_rle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(rle.decode(enc), jax_rle.decode(enc))
        assert rle.area(enc) == jax_rle.area(enc) == int(m.sum())
        np.testing.assert_array_equal(rle.to_bbox(enc), jax_rle.to_bbox(enc))
    np.testing.assert_array_equal(rle.iou(got, got[::-1], [0, 1] * 4 + [0]),
                                  jax_rle.iou(want, want[::-1], [0, 1] * 4 + [0]))
    counts = [rle._raw_counts(r) for r in got]
    for intersect in (False, True):
        np.testing.assert_array_equal(rle.merge_counts(counts, h, w, intersect),
                                      jax_rle.merge_counts(counts, h, w, intersect))


def test_rle_polygons_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        polys = [list(rng.uniform(-2, 40, 2 * int(rng.integers(3, 9))))
                 for _ in range(int(rng.integers(1, 3)))]
        np.testing.assert_array_equal(rle.polygons_to_counts(polys, 33, 41),
                                      jax_rle.polygons_to_counts(polys, 33, 41))
        np.testing.assert_array_equal(rle.polygons_to_mask(polys, 33, 41),
                                      jax_rle.polygons_to_mask(polys, 33, 41))
        assert rle.polygons_to_rle(polys, 33, 41) == jax_rle.polygons_to_rle(polys, 33, 41)


def _gt_and_results(seed):
    """Synthetic scenes' ground truth plus a crowd and a polygon annotation,
    and detections near the truth (jittered boxes, shifted masks), false
    positives and duplicates, with seeded scores."""
    rng = np.random.default_rng(seed)
    _, infos, gt = make_scenes(rng, 6, NET, num_classes=8)
    gt["annotations"].append({
        "id": 1000, "image_id": 0, "category_id": 1, "bbox": [2.0, 2.0, 20.0, 10.0],
        "area": 200.0, "iscrowd": 1, "segmentation": rle.encode(
            np.pad(np.ones((10, 20), np.uint8), ((2, 52), (2, 42))))})
    gt["annotations"].append({
        "id": 1001, "image_id": 1, "category_id": 2, "bbox": [5.0, 5.0, 30.0, 30.0],
        "area": 900.0, "iscrowd": 0, "segmentation": [[5, 5, 35, 5, 35, 35, 5, 35]]})
    bbox_res, segm_res = [], []
    for ann in gt["annotations"]:
        for _ in range(int(rng.integers(1, 3))):
            x, y, w, h = ann["bbox"]
            box = [x + rng.normal(0, 2), y + rng.normal(0, 2),
                   w * rng.uniform(0.8, 1.2), h * rng.uniform(0.8, 1.2)]
            score = float(rng.uniform(0.05, 1.0))
            cat = ann["category_id"] if rng.random() < 0.9 else int(rng.integers(1, 9))
            bbox_res.append({"image_id": ann["image_id"], "category_id": cat,
                             "bbox": box, "score": score})
            m = np.roll(rle.decode(ann["segmentation"]) if isinstance(ann["segmentation"], dict)
                        else rle.polygons_to_mask(ann["segmentation"], NET, NET),
                        tuple(rng.integers(-3, 4, 2)), axis=(0, 1))
            segm_res.append({"image_id": ann["image_id"], "category_id": cat,
                             "segmentation": rle.encode(m), "score": score})
    for i in range(12):  # false positives
        m = _masks(seed + i, 1, NET, NET)[-1]
        bbox_res.append({"image_id": int(rng.integers(0, 6)),
                         "category_id": int(rng.integers(1, 9)),
                         "bbox": list(rng.uniform(0, 40, 4)), "score": float(rng.uniform())})
        segm_res.append(dict(bbox_res[-1], segmentation=rle.encode(m)))
        del segm_res[-1]["bbox"]
    return gt, bbox_res, segm_res


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_lite_cocoeval_stats_match_jax(iou_type):
    gt, bbox_res, segm_res = _gt_and_results(3)
    results = bbox_res if iou_type == "bbox" else segm_res
    ev = LiteCOCOeval(COCOGroundTruth(json.loads(json.dumps(gt))), results, iou_type)
    jev = JaxLiteCOCOeval(JaxGroundTruth(json.loads(json.dumps(gt))), results, iou_type)
    got, want = ev.summarize(), jev.summarize()
    assert got.shape == (12,) and 0.1 < got[0] < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ev.per_category_ap(), jev.per_category_ap(), rtol=0, atol=1e-12)


# Info of the detections' images: (id, original height, width, extra keys).
INFOS = [
    {"id": 0, "height": NET, "width": NET},
    {"id": 1, "height": 48, "width": 80, "pad": (13, 13, 0, 0, NET, NET)},
    {"id": 2, "height": 100, "width": 60, "pad": (0, 0, 13, 13, NET, NET), "hflip": True},
    {"id": 3, "height": 37, "width": 121, "vflip": True},
    {"id": 4, "height": 480, "width": 640, "collate_pad": (0, 8, 4, 0, NET, NET)},
    {"id": 0, "height": NET, "width": NET, "_pad": True},  # wrap padding: skipped
]


def _detections(seed):
    rng = np.random.default_rng(seed)
    dets = []
    for i in range(len(INFOS)):
        n = 0 if i == 3 else int(rng.integers(2, 7))
        bbox = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.5, (n, 2)),
                               rng.uniform(0.01, 1, (n, 1))], 1).astype(np.float32)
        masks = _masks(seed + i, max(n - 3, 0), NET, NET)[:n].astype(bool)
        dets.append({"bbox": bbox, "mask": masks, "cls": rng.integers(0, 3, n)})
    return dets


def test_to_coco_format_matches_jax(tmp_path):
    """Boxes and scores equal; the recovered masks (OpenCV's INTER_LINEAR
    arithmetic in both packages) of these 22 masks (shapes, an empty, a
    full and a noise mask per image) resized to four original sizes (up
    and down) differ in 0 pixels; the COCO stats of the results agree to
    1e-12."""
    cat2label = [1, 2, 3]
    dets = _detections(4)
    got = COCOMetrics(None, cat2label, True, str(tmp_path)).to_coco_format(INFOS, dets)
    want = JaxCOCOMetrics(None, cat2label, True, str(tmp_path)).to_coco_format(INFOS, dets)
    n = sum(len(d["cls"]) for d in dets[:-1])
    assert len(got["bbox"]) == len(want["bbox"]) == n == len(got["segm"])
    assert {r["image_id"] for r in got["bbox"]} == {0, 1, 2, 4}
    for g, w in zip(got["bbox"], want["bbox"]):
        assert (g["image_id"], g["category_id"], g["score"]) == \
            (w["image_id"], w["category_id"], w["score"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-12, atol=1e-9)
    mismatched = 0
    for g, w in zip(got["segm"], want["segm"]):
        assert g["segmentation"]["size"] == w["segmentation"]["size"]
        mismatched += int((rle.decode(g["segmentation"]) != rle.decode(w["segmentation"])).sum())
    assert mismatched == 0

    # the whole metric over these results against a ground truth of the
    # same images (the results' own masks and boxes, jittered by one pixel)
    anns = []
    for r, s in zip(got["bbox"], got["segm"]):
        m = np.roll(rle.decode(s["segmentation"]), 1, axis=1)
        anns.append({"id": len(anns) + 1, "image_id": r["image_id"], "iscrowd": 0,
                     "category_id": r["category_id"], "bbox": [v + 1 for v in r["bbox"]],
                     "area": float(m.sum()), "segmentation": rle.encode(m)})
    images = [{"id": i["id"], "height": i["height"], "width": i["width"]} for i in INFOS[:5]]
    gt_file = tmp_path / "gt.json"
    gt_file.write_text(json.dumps({"images": images, "annotations": anns,
                                   "categories": [{"id": c} for c in cat2label]}))
    stats = []
    for cls, out in ((COCOMetrics, got), (JaxCOCOMetrics, want)):
        metrics = cls(str(gt_file), cat2label, True, str(tmp_path))
        metrics.update_results(out)
        log = metrics.coco_eval(per_cats=True)
        stats.append((metrics.bbox_eval_stats, metrics.segm_eval_stats, log))
    np.testing.assert_allclose(stats[0][0], stats[1][0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(stats[0][1], stats[1][1], rtol=0, atol=1e-12)
    assert stats[0][2].keys() == stats[1][2].keys() and len(stats[0][2]) == 24
    assert 0.0 < stats[0][1][0] < 1.0


def test_recover_shape_segm_against_jax_on_noise_masks():
    """Mask recovery alone, on noise masks (every pixel a boundary), at sizes
    that scale up and down by non-integer factors: the port's resize does
    OpenCV's INTER_LINEAR arithmetic (``ops/resize.py``), so no pixel
    differs from the JAX package's cv2 call, not even where the
    interpolated value is exactly 0.5 (``np.round`` gives 0).  Torch's
    bilinear resize, which the port used before, differed in 9,340 of these
    1,287,456 pixels, all at those ties."""
    torch.set_num_threads(1)
    masks = np.random.default_rng(5).uniform(size=(4, NET, NET)) < 0.5
    total = mismatched = 0
    for oh, ow in ((37, 121), (100, 60), (480, 640), (64, 64), (13, 7)):
        info = {"id": 0, "height": oh, "width": ow}
        got = COCOMetrics._recover_shape_segm(masks, info)
        want = JaxCOCOMetrics._recover_shape_segm(masks, info)
        assert got.shape == want.shape == (4, oh, ow) and got.dtype == np.uint8
        total += got.size
        mismatched += int((got != want).sum())
    assert total == 1287456 and mismatched == 0, f"{mismatched} of {total} pixels differ"


def test_pad_skip_in_to_coco_format():
    m = COCOMetrics(gt_file=None, cat2label=[1], with_mask=False, save_dir=".")
    det = {"bbox": np.array([[0.5, 0.5, 0.2, 0.2, 0.9]], np.float32), "cls": np.array([0])}
    infos = [{"id": 1, "height": 64, "width": 64},
             {"id": 1, "height": 64, "width": 64, "_pad": True}]
    out = m.to_coco_format(infos, [det, det])
    assert len(out["bbox"]) == 1 and "segm" not in out


def test_to_coco_format_times_its_parts(tmp_path):
    """One entry per call for the boxes, the masks' resize and their RLE
    encoding, each summed over the batch's images; the parts lie inside
    the call's own wall time."""
    timer.reset()
    start = time.perf_counter()
    COCOMetrics(None, [1, 2, 3], True, str(tmp_path)).to_coco_format(INFOS, _detections(4))
    wall_ms = (time.perf_counter() - start) * 1000
    history = dict(timer._timer_history)
    assert list(history) == ["COCO Boxes", "Mask Resize", "RLE Encode"]
    assert all(len(v) == 1 and v[0] > 0 for v in history.values())
    assert sum(v[0] for v in history.values()) <= wall_ms


def test_timer_entered_twice_is_one_entry():
    timer.reset()
    part = timer.timer("part")
    for _ in range(2):
        with part:
            time.sleep(0.01)
    with timer.timer("part"):
        pass
    history = timer._timer_history["part"]
    assert len(history) == 2 and history[0] >= 20 and history[1] < history[0]
    assert timer.get_all_elapsed_time()["part"] == pytest.approx(sum(history) / 2)
