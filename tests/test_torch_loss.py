"""The port's loss, ``orienmask_tpu_torch.ops.loss``, against
``orienmask_tpu.ops.loss`` on the same predictions and targets.

JAX paints with the Pallas kernel in interpret mode (the port's plain
painter gives its bits), so the two differ only in the order of their f32
sums: every log item and metric holds to rtol = 1e-5 (as
``tests/test_loss.py`` holds the two JAX painters), and the gradient with
respect to the predictions to rtol = 1e-5 with an atol of 1e-6 of the
largest gradient of its tensor, for entries that cancel to near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.ops.loss import OrienMaskYOLOMultiScaleLoss as JaxLoss
from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss

IMAGE = (64, 64)
GRIDS = [(2, 2), (4, 4), (8, 8)]
ANCHORS = [[4, 6], [8, 10], [12, 8], [10, 20], [20, 16], [18, 36],
           [36, 28], [48, 60], [60, 50]]
MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
NUM_CLASSES = 5
N_MAX = 16
KW = dict(grid_size=[list(g) for g in GRIDS], image_size=list(IMAGE), anchors=ANCHORS,
          anchor_mask=MASKS, num_classes=NUM_CLASSES, center_region=0.6, valid_region=0.6,
          label_smooth=False, obj_ignore_threshold=0.6, weight=[1, 1, 1, 1, 1, 20, 20],
          scales_weight=[1, 1, 1])


def _inputs(seed, counts=(5, 9, 0)):
    """Random predictions and GT (elliptic masks, packed) for a batch."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    bbox = np.zeros((b, N_MAX, 4), np.float32)
    valid = np.zeros((b, N_MAX), bool)
    mask = np.zeros((b, N_MAX, *IMAGE), bool)
    ys, xs = np.mgrid[0:IMAGE[0], 0:IMAGE[1]] / np.float32(IMAGE[0])
    for i, k in enumerate(counts):
        for j in range(k):
            w, h = rng.uniform(0.1, 0.7, 2)
            cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
            bbox[i, j] = [cx, cy, w, h]
            mask[i, j] = ((xs - cx) / (w / 2)) ** 2 + ((ys - cy) / (h / 2)) ** 2 <= 1
        valid[i, :k] = True
    target = {"bbox": bbox, "cls": rng.integers(0, NUM_CLASSES, (b, N_MAX)).astype(np.int32),
              "mask": np.packbits(mask, axis=-1), "valid": valid}
    predict = [(rng.standard_normal((b, nh, nw, 3 * (5 + NUM_CLASSES))).astype(np.float32),
                rng.standard_normal((b, IMAGE[0] // 4, IMAGE[1] // 4, 6)).astype(np.float32))
               for nh, nw in GRIDS]
    return predict, target


def _torch(predict, target, grad=False):
    pt = [tuple(torch.tensor(x, requires_grad=grad) for x in pair) for pair in predict]
    tt = {k: torch.from_numpy(np.array(v)) for k, v in target.items()}
    return pt, tt


def _jax_loss():
    return JaxLoss(painter_impl="pallas", painter_interpret=True, **KW)


def _port_loss():
    return OrienMaskYOLOMultiScaleLoss(device="cpu", **KW)


def _close(got, want, err_msg):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-5, err_msg=err_msg)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's loss sum, logs, metrics and gradient for seed 0, one compile."""
    predict, target = _inputs(0)
    loss = _jax_loss()
    tj = {k: jnp.asarray(v) for k, v in target.items()}

    def f(p):
        s, log, metric = loss(p, tj, training=False)
        return s, (log, metric)

    pj = [tuple(map(jnp.asarray, pair)) for pair in predict]
    (s, (log, metric)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    return predict, target, jax.tree_util.tree_map(np.asarray, (s, log, metric, grads))


def test_loss_logs_match_jax(jax_run):
    predict, target, (want_sum, want_log, _, _) = jax_run
    pt, tt = _torch(predict, target)
    loss_sum, log, metric = _port_loss()(pt, tt, training=True)
    assert metric == {} and set(log) == set(want_log)
    _close(loss_sum.item(), want_sum, "loss_sum")
    for k in want_log:
        _close(log[k].item(), want_log[k], k)
    assert want_log["cross_scale_loss_orien_neg"] > 0 and want_log["cross_scale_loss_xy"] > 0


def test_eval_metrics_match_jax(jax_run):
    predict, target, (_, want_log, want_metric, _) = jax_run
    pt, tt = _torch(predict, target)
    _, log, metric = _port_loss()(pt, tt, training=False)
    assert set(metric) == set(want_metric)
    for k, (num, den) in want_metric.items():
        _close([metric[k][0].item(), metric[k][1].item()], [num, den], k)
    for k in want_log:
        _close(log[k].item(), want_log[k], k)


def test_gradient_matches_jax(jax_run):
    predict, target, (_, _, _, want_grads) = jax_run
    pt, tt = _torch(predict, target, grad=True)
    loss_sum, _, _ = _port_loss()(pt, tt, training=True)
    loss_sum.backward()
    for s, (pair, want) in enumerate(zip(pt, want_grads)):
        for name, t, w in zip(("bbox", "orien"), pair, want):
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{s} {name}")


def test_sample_weight_matches_jax():
    """A wrap-padded batch: sample 0 again at the end with weight 0."""
    predict, target = _inputs(1, counts=(6, 3))
    pad = lambda x: np.concatenate([x, x[:1]])  # noqa: E731
    predict = [tuple(pad(x) for x in pair) for pair in predict]
    target = {k: pad(v) for k, v in target.items()}
    target["sample_weight"] = np.float32([1, 1, 0])
    tj = {k: jnp.asarray(v) for k, v in target.items()}
    want = jax.jit(lambda p: _jax_loss()(p, tj, training=False))(
        [tuple(map(jnp.asarray, pair)) for pair in predict])
    want_sum, want_log, want_metric = jax.tree_util.tree_map(np.asarray, want)
    got_sum, got_log, got_metric = _port_loss()(*_torch(predict, target), training=False)
    _close(got_sum.item(), want_sum, "loss_sum")
    for k in want_log:
        _close(got_log[k].item(), want_log[k], k)
    for k, (num, den) in want_metric.items():
        _close([got_metric[k][0].item(), got_metric[k][1].item()], [num, den], k)


def test_standalone_scale_loss_matches_jax():
    """Each scale's loss called alone (``orien=None``): it paints its own 3
    anchors through the painter's wrapper; JAX uses its XLA painter there,
    whose background sums differ in order (rtol = 1e-5 holds)."""
    predict, target = _inputs(2)
    jax_loss, port_loss = _jax_loss(), _port_loss()
    tj = {k: jnp.asarray(v) for k, v in target.items()}
    pt, tt = _torch(predict, target)
    for s, (jl, pl) in enumerate(zip(jax_loss.scale_losses, port_loss.scale_losses)):
        want = jax.jit(lambda p, jl=jl: jl(p, tj, training=False))(
            tuple(map(jnp.asarray, predict[s])))
        want_sum, want_log, want_metric = jax.tree_util.tree_map(np.asarray, want)
        got_sum, got_log, got_metric = pl(pt[s], tt, training=False)
        _close(got_sum.item(), want_sum, f"scale {s}")
        for k in want_log:
            _close(got_log[k].item(), want_log[k], k)
        for k, (num, den) in want_metric.items():
            _close([got_metric[k][0].item(), got_metric[k][1].item()], [num, den], k)
