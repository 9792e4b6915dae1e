"""The port's ``InferenceVisualizer`` (``orienmask_tpu_torch/utils/
visualizer.py``, numpy only) against the JAX package's
(``orienmask_tpu/utils/visualizer.py``, which draws with cv2), under the same
``random.seed`` on seeded detections: masks on and off, every detection
below ``conf_thresh``, none at all, K >= 3 with equal-area ties, K = 40, a
letterboxed ``pad_info``, boxes and labels that cross every edge.

Measured: every case is identical pixel for pixel, inside the label
rectangles too (100% of their pixels; largest difference 0), so the tests
assert equality of the whole image; the label rectangles are still counted
and reported, since the label glyphs come from a committed atlas
(``label_font.npz``, ``probe/make_glyph_atlas.py``) rather than cv2."""

import random

import cv2
import numpy as np
import pytest

from orienmask_tpu.utils.visualizer import InferenceVisualizer as JaxVisualizer
from orienmask_tpu_torch.utils.visualizer import InferenceVisualizer, LabelFont, resize_linear


def _detections(rng, k, size, ties=False, scores=None):
    bbox = np.zeros((k, 5), np.float32)
    bbox[:, :2] = rng.uniform(-0.1, 1.1, (k, 2))
    bbox[:, 2:4] = rng.uniform(0.05, 0.9, (k, 2))
    bbox[:, 4] = rng.uniform(0.0, 1.0, k) if scores is None else scores
    cls = rng.integers(0, 80, k)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((k, size, size), np.uint8)
    for i in range(k):
        if ties:  # squares of three sizes, placed anywhere: equal areas
            s = (8, 12, 8)[i % 3]
            y0, x0 = rng.integers(0, size - s, 2)
            mask[i, y0:y0 + s, x0:x0 + s] = 1
        else:
            cy, cx, r = rng.uniform(0, size, 3)
            mask[i] = ((yy - cy) ** 2 + (xx - cx) ** 2 < (r / 2) ** 2)
    return {"bbox": bbox, "cls": cls, "mask": mask}


def _label_rectangles(font, detections, shape, pad_info, conf_thresh, classes):
    """Where each label is drawn: the filled background from (x1, y1) to
    (x1 + tw, y1 - th - 4) and the glyphs' own extent, clipped."""
    h, w = shape[:2]
    inside = np.zeros((h, w), bool)
    bbox = detections["bbox"][detections["bbox"][:, 4] > conf_thresh]
    cls = detections["cls"][detections["bbox"][:, 4] > conf_thresh]
    xyxy = InferenceVisualizer._recover_shape_bbox(bbox[:, :4], w, h, pad_info)
    for (x1, y1, _, _), score, c in zip(xyxy, bbox[:, 4], cls):
        text = "%s %.2f" % (classes[int(c)], score)
        tw, th = font.text_size(text)
        ya, xb = max(y1 - th - 4, 0), min(x1 + tw + 2, w)
        inside[ya:max(y1 + 4, 0), max(x1 - 2, 0):max(xb, 0)] = True
    return inside


CASES = {
    "masks": dict(k=12, with_mask=True),
    "no_masks": dict(k=12, with_mask=False),
    "all_below_threshold": dict(k=7, scores=np.full(7, 0.29, np.float32)),
    "none": dict(k=0),
    "equal_area_ties": dict(k=9, ties=True, scores=np.linspace(0.95, 0.4, 9, dtype=np.float32)),
    "many": dict(k=40),
    "letterboxed": dict(k=10, pad_info=(8, 8, 24, 24, 136, 136)),
    "labels_at_the_edges": dict(k=12, scores=np.full(12, 0.9, np.float32), edge=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_visualizer_matches_the_jax_visualizer(name):
    case = dict(CASES[name])
    rng = np.random.default_rng(sorted(CASES).index(name))
    with_mask = case.pop("with_mask", True)
    pad_info = case.pop("pad_info", (0, 0, 0, 0, 136, 136))
    edge = case.pop("edge", False)
    detections = _detections(rng, case.pop("k"), 136, **case)
    if edge:  # boxes hugging and crossing the borders: labels clipped on every side
        detections["bbox"][:, :2] = rng.choice([-0.05, 0.0, 0.02, 0.98, 1.0, 1.05], (12, 2))
    image = rng.integers(0, 256, (97, 131, 3)).astype(np.float32)
    kw = dict(with_mask=with_mask, conf_thresh=0.3, alpha=0.6)
    port, ref = InferenceVisualizer("COCO", **kw), JaxVisualizer("COCO", **kw)
    random.seed(11)
    want = ref(detections, image, pad_info)
    after_ref = random.random()
    random.seed(11)
    got = port(detections, image, pad_info)
    assert random.random() == after_ref  # the same draws from ``random``
    assert got.dtype == np.uint8 and got.shape == want.shape == (97, 131, 3)
    labels = _label_rectangles(port.font, detections, got.shape, pad_info, 0.3, port.classes)
    differ = (got != want).any(axis=2)
    assert not differ[~labels].any(), f"{int(differ[~labels].sum())} pixels outside labels"
    print(f"{name}: {int(labels.sum())} label pixels, {int(differ[labels].sum())} differ, "
          f"largest difference {int(np.abs(got.astype(int) - want).max())}")
    np.testing.assert_array_equal(got, want)
    if name in ("all_below_threshold", "none"):
        np.testing.assert_array_equal(got, np.round(image).astype(np.uint8))


@pytest.mark.parametrize("shape", [(544, 544, 480, 640), (736, 736, 720, 1280),
                                   (37, 53, 100, 20), (136, 96, 97, 131)],
                         ids=lambda s: "%dx%d_to_%dx%d" % s)
def test_resize_linear_is_opencvs_inter_linear(shape):
    """Masks (0/1) and general floats, up and down, bit for bit."""
    sh, sw, h, w = shape
    rng = np.random.default_rng(sh + w)
    for m in ((rng.random((sh, sw)) < 0.4).astype(np.float32),
              rng.random((sh, sw)).astype(np.float32)):
        np.testing.assert_array_equal(resize_linear(m, w, h),
                                      cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR))


def test_label_font_matches_cv2_text():
    """The atlas against cv2.getTextSize and cv2.putText on every COCO
    label at a few scores, over a coloured background and clipped at the
    left and top edges."""
    from orienmask_tpu_torch.data.dataset import COCODataset

    font = LabelFont()
    for name in COCODataset.CLASSES:
        for score in (0.3, 0.76):
            text = "%s %.2f" % (name, score)
            assert font.text_size(text) == cv2.getTextSize(text, cv2.FONT_HERSHEY_DUPLEX,
                                                            0.4, 1)[0]
            for org in ((5, 20), (-7, 6)):
                want = np.full((24, 160, 3), (37, 150, 201), np.uint8)
                cv2.putText(want, text, org, cv2.FONT_HERSHEY_DUPLEX, 0.4, (255, 255, 255), 1,
                            cv2.LINE_AA)
                got = np.full((24, 160, 3), (37, 150, 201), np.uint8)
                font.put_text(got, text, org)
                np.testing.assert_array_equal(got, want, err_msg=f"{text} at {org}")


def test_blend_keeps_no_k_by_h_by_w_by_3_temporary():
    """The mask blend's peak memory stays near the (K, H, W) masks' own, not
    the JAX module's (K, H, W, 3) product (what matters at 736^2 x 100)."""
    import tracemalloc

    rng = np.random.default_rng(3)
    k, h, w = 30, 120, 160
    masks = (rng.random((k, h, w)) < 0.3).astype(np.float32)
    colors = rng.uniform(0, 255, (k, 3)).astype(np.float32)
    image = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    vis = InferenceVisualizer("COCO", alpha=0.6)
    tracemalloc.start()
    got = image.copy()
    vis._plot_all_mask(masks, got, colors)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    assert peak < 8 * h * w * 3 * 4 < (k - 1) * h * w * 3 * 4, peak  # a few (H, W, 3) arrays
    want = image.copy()
    JaxVisualizer("COCO", alpha=0.6)._plot_all_mask(masks, want, colors)
    np.testing.assert_array_equal(got, want)


def test_fused_multiply_add_breaks_double_rounding_ties():
    """1 + 2^-24 + 2^-60 rounds to 1 + 2^-24 in float64, halfway between
    two float32 values; rounded once (as a fused multiply-add) it is
    1 + 2^-23.  Just below the halfway point it is 1."""
    from orienmask_tpu_torch.ops.resize import _fma32

    a = np.array([2.0 ** -24 * (1 + 2.0 ** -12), 2.0 ** -24 * (1 + 2.0 ** -18)], np.float32)
    b = np.array([1 - 2.0 ** -12 + 2.0 ** -24, 1 - 2.0 ** -18], np.float32)
    got = _fma32(a, b, np.float32(1))
    np.testing.assert_array_equal(got, np.array([1 + 2.0 ** -23, 1], np.float32))
    assert (a.astype(np.float64) * b + 1).astype(np.float32)[0] == 1  # the double rounding
