"""The port's native host library (orienmask_tpu_torch/native, its own copy
of omtpu.cc) against the JAX package's orienmask_tpu.native on the same
seeded inputs, entry point by entry point, bit for bit; the column-packed
encoder against the numpy RLE at column seams; the codec's and the
matcher's native routes against their plain versions; and no fallback: the
library raises when it cannot be built."""

import shutil

import numpy as np
import pytest
import torch

from orienmask_tpu import native as jax_native
from orienmask_tpu.eval import rle as jax_rle
from orienmask_tpu_torch import kernels, native
from orienmask_tpu_torch.eval import lite_cocoeval, rle
from orienmask_tpu_torch.ops.recover import _pack_columns


@pytest.fixture(scope="module", autouse=True)
def jax_lib():
    assert jax_native.get_lib() is not None, "the JAX package's native library did not build"


def _mask_cases(rng, h, w):
    """Noise at three densities, empty, full, a first pixel of 1, a last
    pixel of 1, one full column and one full row."""
    first = np.zeros((h, w), np.uint8)
    first[0, 0] = 1
    last = np.zeros((h, w), np.uint8)
    last[-1, -1] = 1
    col = np.zeros((h, w), np.uint8)
    col[:, w // 2] = 1
    row = np.zeros((h, w), np.uint8)
    row[h // 2] = 1
    noise = [(rng.random((h, w)) < p).astype(np.uint8) for p in (0.05, 0.5, 0.95)]
    return np.stack(noise + [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
                             first, last, col, row])


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (33, 1), (1, 40), (64, 64), (160, 120)])
def test_rle_encode_and_batch_match_jax(h, w):
    masks = _mask_cases(np.random.default_rng(h * w), h, w)
    for m in masks:
        got = native.rle_encode(m)
        assert got == jax_native.rle_encode(m) == jax_rle._counts_to_string(
            jax_rle._mask_to_counts(m))
    assert native.rle_encode_batch(masks) == jax_native.rle_encode_batch(masks)
    assert native.rle_encode_batch(masks[:0]) == jax_native.rle_encode_batch(masks[:0]) == []


def test_rle_decode_counts_matches_jax():
    rng = np.random.default_rng(1)
    strings = [native.rle_encode(m) for m in _mask_cases(rng, 97, 61)]
    # long runs: counts past 2^20 and deltas of either sign
    strings.append(rle._counts_to_string(np.array([0, 3, 2 ** 21, 5, 2 ** 20 + 7, 1, 9])))
    strings.append("")
    for s in strings:
        got = native.rle_decode_counts(s)
        want = jax_native.rle_decode_counts(s)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rle._string_to_counts_plain(s))


def test_rle_decode_of_a_truncated_string_raises():
    """The JAX binding returns None (and its codec falls back); the port
    raises."""
    assert jax_native.rle_decode_counts("1k") is None
    with pytest.raises(ValueError, match="truncated"):
        native.rle_decode_counts("1k")


def test_nms_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 17, 128):
        dets = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                         rng.uniform(0.05, 0.4, n), rng.uniform(0.05, 0.4, n),
                         rng.integers(0, 4, n) / 4], axis=1).astype(np.float32)  # tied scores
        for thresh in (0.3, 0.5):
            got = native.nms(dets, thresh)
            np.testing.assert_array_equal(got, jax_native.nms(dets, thresh))
            np.testing.assert_array_equal(got, jax_native._np_nms(dets, thresh))


def _polygon_cases(rng):
    cases = [[], [[]], [[3.0, 3.0, 3.0, 3.0, 3.0, 3.0]],  # none, empty, degenerate
             [[-5.0, -5.0, 60.0, -5.0, 60.0, 60.0, -5.0, 60.0]],  # past every edge
             [[0.5, 0.5, 10.5, 0.5, 10.5, 10.5, 0.5, 10.5],
              [5.5, 5.5, 20.5, 5.5, 20.5, 20.5]]]  # overlapping union
    for _ in range(20):
        cases.append([list(rng.uniform(-2, 45, 2 * int(rng.integers(3, 12))))
                      for _ in range(int(rng.integers(1, 4)))])
    return cases


def test_poly_merge_matches_jax():
    rng = np.random.default_rng(3)
    for h, w in ((33, 41), (48, 48)):
        for polys in _polygon_cases(rng):
            got = native.poly_merge_counts(polys, h, w)
            np.testing.assert_array_equal(got, jax_native.poly_merge_counts(polys, h, w))
            np.testing.assert_array_equal(got, rle.polygons_to_counts_plain(polys, h, w))
            np.testing.assert_array_equal(rle.polygons_to_mask(polys, h, w),
                                          rle.polygons_to_mask_plain(polys, h, w))


def _iou_grids(rng):
    thrs = np.linspace(0.5, 0.95, 10)
    for _ in range(40):
        nd, ng = int(rng.integers(0, 12)), int(rng.integers(0, 10))
        ious = rng.integers(0, 8, (nd, ng)).astype(np.float64) / 7.0  # exact ties
        iscrowd = (rng.random(ng) < 0.25).astype(np.uint8)
        g_ignore = (rng.random(ng) < 0.3) | iscrowd.astype(bool)
        g_order = np.argsort(g_ignore, kind="stable")
        yield ious, g_order, g_ignore[g_order], iscrowd, thrs


def test_coco_match_matches_jax_and_the_python_loop():
    for ious, g_order, gi, iscrowd, thrs in _iou_grids(np.random.default_rng(7)):
        got_m, got_ig = native.coco_match(ious, g_order, gi, iscrowd, thrs)
        want_m, want_ig = jax_native.coco_match(ious, g_order, gi, iscrowd, thrs)
        np.testing.assert_array_equal(got_m, want_m)
        np.testing.assert_array_equal(got_ig, want_ig)
        plain_m, plain_ig = lite_cocoeval._match_plain(ious, g_order, gi, iscrowd)
        np.testing.assert_array_equal(got_m, plain_m)
        np.testing.assert_array_equal(got_ig, plain_ig)
        np.testing.assert_array_equal(
            lite_cocoeval._native_match(ious, g_order, gi, iscrowd)[0], plain_m)


def test_rle_iou_matches_jax():
    rng = np.random.default_rng(4)
    masks = _mask_cases(rng, 40, 52)
    a = [rle.encode(m) for m in masks]
    b = [{"size": r["size"], "counts": rle._raw_counts(r)} for r in a[::-1]]  # raw counts too
    for crowd in (None, [0, 1] * 4 + [1]):
        got = native.rle_iou(a, b, crowd)
        np.testing.assert_array_equal(got, jax_native.rle_iou(a, b, crowd))
        np.testing.assert_allclose(got, rle.iou_plain(a, b, crowd), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(rle.iou(a, b, crowd), got)
    assert native.rle_iou([], b).shape == jax_native.rle_iou([], b).shape == (0, len(b))
    assert native.rle_iou(a, []).shape == (len(a), 0)


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(5)
    for shape, (dh, dw) in (((37, 53, 3), (96, 128)), ((40, 40), (17, 23)),
                            ((8, 9, 2), (8, 9))):
        img = rng.random(shape).astype(np.float32)
        for align in (False, True):
            np.testing.assert_array_equal(native.resize_bilinear(img, dh, dw, align),
                                          jax_native.resize_bilinear(img, dh, dw, align))


@pytest.mark.parametrize("oh", [1, 31, 32, 33, 480])
def test_rle_encode_colpacked_equals_the_numpy_rle(oh):
    """Column seams at every word boundary: oh of 1, 31, 32, 33 and 480;
    all ones, empty, a first pixel of 1 (counts start with a 0 run), noise,
    a full column and a full row; words of int32 and of uint32."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(oh)
    for ow in (1, 2, 7):
        masks = _mask_cases(rng, oh, ow)
        words = _pack_columns(torch.from_numpy(masks.astype(bool))).numpy()
        want = [rle.encode_plain(m)["counts"] for m in masks]
        assert native.rle_encode_colpacked(words, len(masks), oh, ow) == want
        assert native.rle_encode_colpacked(words.view(np.uint32), len(masks), oh, ow) == want
        # bits past oh are ignored
        stray = words.view(np.uint32).reshape(len(masks), ow, -1).copy()
        stray[..., -1] |= np.uint32((0xFFFFFFFF << (oh % 32)) & 0xFFFFFFFF if oh % 32 else 0)
        assert native.rle_encode_colpacked(stray, len(masks), oh, ow) == want
    assert native.rle_encode_colpacked(np.zeros(0, np.int32), 0, oh, 5) == []
    with pytest.raises(ValueError, match="words for"):
        native.rle_encode_colpacked(np.zeros(3, np.int32), 1, oh, 5)


def test_the_library_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    """No fallback: without g++, or with a g++ that fails, the first call
    raises (the JAX binding returns None and numpy carries on)."""
    false = shutil.which("false")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.rle_encode(np.zeros((4, 4), np.uint8))
    monkeypatch.setattr(kernels.shutil, "which", lambda name: false)
    with pytest.raises(RuntimeError, match="failed"):
        rle.encode(np.zeros((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="failed"):
        native.coco_match(np.zeros((1, 1)), [0], [False], [0], [0.5])
