"""The port's target assignment, ``orienmask_tpu_torch.ops.targets``, against
``orienmask_tpu.ops.targets`` on the same numpy inputs.

Integer and boolean outputs (match, masks, ignore, multi-hot tcls) must be
equal; the painter geometry (products and sums in the same order) must be
equal by bits; float targets that pass through log (twh) or the IoU
division hold to rtol = 1e-6, atol = 1e-7, an ulp or two of f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.ops.targets import OrientationPainter as JaxPainter
from orienmask_tpu.ops.targets import TargetBuilder as JaxBuilder
from orienmask_tpu_torch.ops.targets import OrientationPainter, TargetBuilder

IMAGE = (64, 64)
GRIDS = [(2, 2), (4, 4), (8, 8)]
ANCHORS = [[4, 6], [8, 10], [12, 8], [10, 20], [20, 16], [18, 36],
           [36, 28], [48, 60], [60, 50]]
MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
NUM_CLASSES = 5
N_MAX = 16
THRESH = 0.6


def _batch(seed, counts=(7, 0, 12)):
    """B = 3 samples of random boxes; sample 0 also holds two instances of
    different classes on one cell of one anchor (multi-hot tcls) and one
    invalid row in the middle."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    bbox = np.zeros((b, N_MAX, 4), np.float32)
    cls = np.zeros((b, N_MAX), np.int32)
    valid = np.zeros((b, N_MAX), bool)
    for i, k in enumerate(counts):
        w, h = rng.uniform(0.05, 0.8, k), rng.uniform(0.05, 0.8, k)
        bbox[i, :k] = np.stack([rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2),
                                w, h], -1)
        cls[i, :k] = rng.integers(0, NUM_CLASSES, k)
        valid[i, :k] = True
    bbox[0, 0] = [0.3, 0.3, 0.1, 0.12]  # on the finest scale's anchor 1
    bbox[0, 1] = bbox[0, 0] * np.float32([1, 1, 1.01, 0.99])
    cls[0, 0], cls[0, 1] = 1, 3
    valid[0, 4] = False
    mask = rng.uniform(size=(b, N_MAX, *IMAGE)) < 0.5
    return bbox, cls, valid, mask


def _pred_boxes(seed, grid, b):
    """Predicted boxes in grid units; some sit on the GT so the ignore mask
    is exercised."""
    rng = np.random.default_rng(seed + 100)
    p = 3 * grid[0] * grid[1]
    return np.stack([rng.uniform(0, grid[1], (b, p)), rng.uniform(0, grid[0], (b, p)),
                     rng.uniform(0.2, grid[1], (b, p)), rng.uniform(0.2, grid[0], (b, p))],
                    -1).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("scale", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_and_bbox_targets_match_jax(seed, scale):
    bbox, cls, valid, _ = _batch(seed)
    pred = _pred_boxes(seed, GRIDS[scale], len(bbox))
    jb = JaxBuilder(GRIDS[scale], IMAGE, ANCHORS, MASKS[scale], NUM_CLASSES,
                    obj_ignore_threshold=THRESH)
    tb = TargetBuilder(GRIDS[scale], IMAGE, ANCHORS, MASKS[scale], NUM_CLASSES,
                       obj_ignore_threshold=THRESH, device="cpu")

    want_local, want_matched = jax.vmap(jb.match)(jnp.asarray(bbox), jnp.asarray(valid))
    local, matched = tb.match(*_t(bbox, valid))
    np.testing.assert_array_equal(local.numpy(), np.asarray(want_local))
    np.testing.assert_array_equal(matched.numpy(), np.asarray(want_matched))

    want = jax.vmap(jb.bbox_targets)(*map(jnp.asarray, (bbox, cls, valid, pred)))
    got = tb.bbox_targets(*_t(bbox, cls, valid, pred))
    names = ("pos_mask", "neg_mask", "pos_scale", "txy", "twh", "tiou", "tcls")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("pos_mask", "neg_mask", "tcls"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=name)


def test_targets_exercise_multi_hot_and_ignore():
    """The batch of the test above holds a multi-hot cell and ignored
    predictions on the finest scale."""
    bbox, cls, valid, _ = _batch(0)
    tb = TargetBuilder(GRIDS[2], IMAGE, ANCHORS, MASKS[2], NUM_CLASSES,
                       obj_ignore_threshold=THRESH, device="cpu")
    pos, neg, _, _, _, _, tcls = tb.bbox_targets(*_t(bbox, cls, valid, _pred_boxes(0, GRIDS[2], 3)))
    assert (tcls.sum(-1) > 1).any()  # two classes on one cell
    assert ((neg == 0) & (pos == 0)).any()  # ignored, neither positive nor negative


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_inputs_match_jax_by_bits(seed):
    bbox, _, valid, _ = _batch(seed)
    rng = np.random.default_rng(seed)
    ga = np.where(valid, rng.integers(0, 9, valid.shape), -1).astype(np.int32)
    jp = JaxPainter(IMAGE, ANCHORS, MASKS, GRIDS, center_region=0.6, valid_region=0.6)
    want_geom, want_n = jp.kernel_inputs(jnp.asarray(bbox), jnp.asarray(ga), jnp.asarray(ga >= 0))
    painter = OrientationPainter(IMAGE, ANCHORS, MASKS, GRIDS, center_region=0.6,
                                 valid_region=0.6, device="cpu")
    geom, n_last = painter.kernel_inputs(*_t(bbox, ga.astype(np.int64), ga >= 0))
    assert geom.dtype == torch.float32 and n_last.dtype == torch.int32
    np.testing.assert_array_equal(geom.numpy().view(np.int32),
                                  np.asarray(want_geom).view(np.int32))
    np.testing.assert_array_equal(n_last.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("scale", [0, 2])
def test_standalone_targets_match_jax(scale):
    """TargetBuilder's own path (bbox targets and this scale's painting on
    its 3 anchors) against JAX's, whose XLA painter sums the background
    offsets in another order: rtol = atol = 1e-5 there."""
    bbox, cls, valid, mask = _batch(3)
    pred = _pred_boxes(3, GRIDS[scale], len(bbox))
    jb = JaxBuilder(GRIDS[scale], IMAGE, ANCHORS, MASKS[scale], NUM_CLASSES,
                    obj_ignore_threshold=THRESH, chunk=4)
    tb = TargetBuilder(GRIDS[scale], IMAGE, ANCHORS, MASKS[scale], NUM_CLASSES,
                       obj_ignore_threshold=THRESH, device="cpu")
    want = jax.vmap(jb)(*map(jnp.asarray, (bbox, cls, mask, valid, pred)))
    got = tb(*_t(bbox, cls, np.packbits(mask, axis=-1), valid, pred))
    assert float(np.asarray(want[7]).sum()) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=str(i))
