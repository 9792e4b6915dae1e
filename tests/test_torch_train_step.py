"""The slice as a whole: the port's ``make_train_step`` against
``orienmask_tpu.trainer.train_state.make_train_step`` from the same numpy
weights and batch, plus the NaN guard, SGD, the schedules and collate.

Slim depth (stage blocks (1, 1, 1, 1, 1)) at the published widths, 128²,
B = 4 (the deepest BatchNorms see 64 values a channel), f32, JAX on its
master stem, lr 1e-4 (the train config's first step).  Each step starts
from the same state: after step 1 the port takes JAX's parameters, BN
statistics, momentum and counter.  Each step's gradient is read from the
momentum it leaves (``_state_errors``), so neither the momentum carried in
from step 1 nor the rounding of the parameters hides a gradient error.

* Logs agree to rtol = 2e-4 (measured worst 4.7e-5).
* Gradients agree to 5% in relative L2 norm per tensor and 4% all
  together (measured worst 3.7% and 2.5%, over both tests and steps); the
  updates (new - old) to 5% per tensor.  With random weights every
  objectness cell pulls the same way, and the train-mode BatchNorms remove
  that common part of their upstream gradient, so f32 rounding is
  amplified along the backward.  Against a float64 evaluation of the port
  the port's f32 gradients sit 2.5% (median tensor) and 3.6% (worst) away,
  JAX's 1.4% and 1.8% (``test_gradients_match_a_float64_evaluation``).
  One layer's batch-statistics backward is held to 1e-5 by
  ``test_torch_models.py::test_conv_bn_leaky_backward_matches_jax``.
* BN running statistics agree to rtol = 1e-3 with an atol of 5e-5 of the
  tensor's largest value (measured worst 1.2e-5 of it)."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from orienmask_tpu.data.collate import collate as jax_collate
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.ops.loss import OrienMaskYOLOMultiScaleLoss as JaxLoss
from orienmask_tpu.optim import SGD as JaxSGD
from orienmask_tpu.optim.lr_scheduler import PolyLR as JaxPolyLR
from orienmask_tpu.optim.lr_scheduler import StepWarmUpLR as JaxStepWarmUpLR
from orienmask_tpu.parallel.mesh import data_mesh, shard_batch
from orienmask_tpu.trainer.train_state import make_eval_step as jax_make_eval_step
from orienmask_tpu.trainer.train_state import make_train_step as jax_make_train_step
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as cfg
from orienmask_tpu_torch.data import collate
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, layers, variables_from_jax
from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
from orienmask_tpu_torch.ops import loss as loss_module
from orienmask_tpu_torch.optim import SGD, PolyLR, StepWarmUpLR
from orienmask_tpu_torch.trainer import make_eval_step, make_train_step
from orienmask_tpu_torch.trainer.train_state import to_device, unpack_target

SIZE = 128
COUNTS = (3, 5, 2, 4)  # instances per image: B = 4
SLIM = (1, 1, 1, 1, 1)
NUM_CLASSES = 8
LOSS = dict(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
            image_size=[SIZE, SIZE],
            anchors=[[8, 12], [16, 20], [24, 16], [20, 40], [40, 32], [36, 72],
                     [72, 56], [96, 120], [120, 100]],
            anchor_mask=[[6, 7, 8], [3, 4, 5], [0, 1, 2]], num_classes=NUM_CLASSES,
            center_region=0.6, valid_region=0.6, obj_ignore_threshold=0.7,
            weight=[1, 1, 1, 1, 1, 20, 20], scales_weight=[1, 1, 1])
SGD_KW = dict(lr=1e-3, momentum=0.9, weight_decay=5e-4)
LR = 1e-4
LOG_RTOL = 2e-4
GRAD_RTOL, GRAD_RTOL_ALL, UPDATE_RTOL = 0.05, 0.04, 0.05


def _samples(seed, counts, size=SIZE):
    """Transformed samples: images in [0, 1], boxes with elliptic masks."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size] / np.float32(size)
    out = []
    for k in counts:
        w, h = rng.uniform(0.1, 0.7, k), rng.uniform(0.1, 0.7, k)
        cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        masks = (((xs - cx[:, None, None]) / (w[:, None, None] / 2)) ** 2
                 + ((ys - cy[:, None, None]) / (h[:, None, None] / 2)) ** 2 <= 1)
        out.append({"image": rng.uniform(0, 1, (size, size, 3)).astype(np.float32),
                    "bbox": np.stack([cx, cy, w, h], -1).astype(np.float32),
                    "cls": rng.integers(0, NUM_CLASSES, k), "mask": masks})
    return out


def _batch(seed, jax_side=False):
    return (jax_collate if jax_side else collate)(_samples(seed, COUNTS), max_instances=8,
                                                  pack_masks=True)


@pytest.fixture(scope="module")
def variables():
    jm = JaxModel(num_anchors=3, num_classes=NUM_CLASSES, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    return jm, jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(0)))


def _port(variables, accumulate=1):
    torch.set_num_threads(1)
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    opt = SGD(pm.parameters(), **SGD_KW)
    step = make_train_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS), opt,
                           accumulate=accumulate, device="cpu")
    return pm, opt, step


def _jax_state_dict(pm, state):
    """JAX's parameters, BN statistics and momentum under the port's names."""
    np_state = jax.tree_util.tree_map(np.asarray, state)
    stats = np_state["batch_stats"]
    sd = variables_from_jax(pm, {"params": np_state["params"], "batch_stats": stats})
    momentum = variables_from_jax(pm, {"params": np_state["opt_state"]["momentum"],
                                       "batch_stats": stats})
    names = [name for name, _ in pm.named_parameters()]
    return sd, {name: momentum[name] for name in names}


def _port_state(pm, opt):
    """The port's state dict and momentum by parameter name (zeros before
    the first update)."""
    names = [name for name, _ in pm.named_parameters()]
    bufs = opt.buffers or [torch.zeros_like(p) for p in opt.params]
    return ({k: t.clone() for k, t in pm.state_dict().items()},
            {name: b.clone() for name, b in zip(names, bufs)})


def _state_errors(before, after, want_after):
    """``after`` against JAX's ``want_after``, both reached from ``before``
    (each a (state dict, momentum) pair).  Returns the worst relative L2
    error of a tensor's gradient, that of all gradients together, and that
    of a tensor's update (new - old).  The gradient of a step is read from
    the momentum, where it is not rounded to the parameters' magnitude:
    buf' = momentum * buf + grad + weight_decay * param, so with ``before``
    the same on both sides buf'_port - buf'_jax = grad_port - grad_jax."""
    (sd0, buf0), (sd1, buf1), (want_sd, want_buf) = before, after, want_after
    worst_grad = worst_update = 0.0
    diff_all, grad_all = [], []
    for k, w in want_sd.items():
        if "num_batches_tracked" in k:
            continue
        got, want = sd1[k].double().numpy(), w.double().numpy()
        if "running_" in k:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-5 * np.abs(want).max(),
                                       err_msg=k)
            continue
        w0 = sd0[k].double().numpy()
        want_grad = (want_buf[k].double() - SGD_KW["momentum"] * buf0[k].double()
                     - SGD_KW["weight_decay"] * sd0[k].double()).numpy()
        diff = (buf1[k].double() - want_buf[k].double()).numpy()
        worst_grad = max(worst_grad, np.linalg.norm(diff) / np.linalg.norm(want_grad))
        diff_all.append(diff.ravel())
        grad_all.append(want_grad.ravel())
        worst_update = max(worst_update, np.linalg.norm(got - want) / np.linalg.norm(want - w0))
    diff_all, grad_all = np.concatenate(diff_all), np.concatenate(grad_all)
    return worst_grad, np.linalg.norm(diff_all) / np.linalg.norm(grad_all), worst_update


def _assert_state_close(before, after, want_after):
    worst, together, update = _state_errors(before, after, want_after)
    assert worst < GRAD_RTOL, f"a tensor's gradient differs by {worst:.4f} (relative L2)"
    assert together < GRAD_RTOL_ALL, f"the gradients differ by {together:.4f} (relative L2)"
    assert update < UPDATE_RTOL, f"a tensor's update differs by {update:.4f} (relative L2)"


def _load_jax_state(pm, opt, state):
    """JAX's train state into the port's model and SGD."""
    sd, momentum = _jax_state_dict(pm, state)
    pm.load_state_dict(sd)
    with torch.no_grad():
        for (name, _), buf in zip(pm.named_parameters(), opt.buffers):
            buf.copy_(momentum[name])
        opt.step.fill_(int(np.asarray(state["opt_state"]["step"])))


def _jax_run(jm, variables, batches, accumulate, do_steps):
    """JAX's state after each step, and its logs."""
    loss = JaxLoss(**LOSS)
    step, init = jax_make_train_step(jm, loss, JaxSGD(**SGD_KW), data_mesh(n_devices=1),
                                     accumulate=accumulate)
    state, states, logs = init(variables), [], []
    for batch, do in zip(batches, do_steps):
        state, log = step(state, shard_batch(batch, data_mesh(n_devices=1)), LR, do)
        states.append(jax.tree_util.tree_map(np.array, state))
        logs.append(jax.tree_util.tree_map(np.asarray, log))
    return states, logs


@pytest.fixture(scope="module")
def jax_two_steps(variables):
    """JAX's states and logs after two steps on batch 0."""
    jm, v = variables
    return _jax_run(jm, v, [_batch(0, jax_side=True)] * 2, 1, [True, True])


def test_train_steps_match_jax(variables, jax_two_steps):
    _, v = variables
    batch = _batch(0)
    states, want_logs = jax_two_steps
    pm, opt, step = _port(v)
    for i, (want_state, want) in enumerate(zip(states, want_logs)):
        before = _port_state(pm, opt)
        got = step(batch, LR)
        assert float(got["skipped"]) == 0.0 == float(want["skipped"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOG_RTOL,
                                       err_msg=f"step {i + 1}: {k}")
        _assert_state_close(before, _port_state(pm, opt), _jax_state_dict(pm, want_state))
        assert int(opt.step) == i + 1
        _load_jax_state(pm, opt, want_state)


def _loss_grads(pm, dtype):
    """The gradient of the train loss on batch 0 by parameter name, in train
    mode, without an update."""
    batch = to_device(_batch(0), "cpu")
    loss_fn = OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS)
    pm.train()
    loss, _, _ = loss_fn(pm(batch["image"].permute(0, 3, 1, 2).to(dtype), dtype),
                         unpack_target(batch), training=True)
    names = [name for name, _ in pm.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(pm.parameters()))))


def test_gradients_match_a_float64_evaluation(variables, jax_two_steps, monkeypatch):
    """Step 1's gradients, port f32 and JAX f32, against the port evaluated
    in float64 (heads and the x4 upsample kept in float64 too).  The f64
    port has no rounding to speak of, so JAX's distance from it is JAX's own
    f32 rounding plus any difference of the two computations: JAX within
    2.5% per tensor in relative L2 (measured median 1.4%, worst 1.8%), the
    port's f32 within 5% (measured median 2.5%, worst 3.6%)."""
    _, v = variables
    pm, _, _ = _port(v)
    g32 = _loss_grads(pm, torch.float32)
    p0 = {name: p.detach().double() for name, p in pm.named_parameters()}
    _, momentum = _jax_state_dict(pm, jax_two_steps[0][0])
    monkeypatch.setattr(layers.Conv, "forward", lambda self, x, dtype: F.conv2d(
        x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        + self.bias[:, None, None])
    resize = loss_module.resize_nhwc
    monkeypatch.setattr(loss_module, "resize_nhwc",
                        lambda x, mh, mw: resize(x, mh.to(x.dtype), mw.to(x.dtype)))
    g64 = _loss_grads(pm.double(), torch.float64)
    for name, want in g64.items():
        jax_grad = momentum[name].double() - SGD_KW["weight_decay"] * p0[name]
        norm = torch.linalg.norm(want)
        jax_err = float(torch.linalg.norm(jax_grad - want) / norm)
        port_err = float(torch.linalg.norm(g32[name].double() - want) / norm)
        assert jax_err < 0.025, f"{name}: JAX f32 is {jax_err:.4f} from the f64 port"
        assert port_err < 0.05, f"{name}: the f32 port is {port_err:.4f} from the f64 port"


def test_accumulate_two_matches_jax(variables):
    """Two microbatches with accumulate=2: the first only adds its
    gradients, the second applies their sum with lr / 2."""
    jm, v = variables
    states, _ = _jax_run(jm, v, [_batch(s, jax_side=True) for s in (1, 2)], 2, [False, True])
    pm, opt, step = _port(v, accumulate=2)
    before = _port_state(pm, opt)
    step(_batch(1), LR, do_step=False)
    assert opt.step is None  # nothing applied yet
    for k, t in pm.state_dict().items():
        if "running_" not in k and "num_batches" not in k:
            assert torch.equal(t, before[0][k]), k
    step(_batch(2), LR, do_step=True)
    _assert_state_close(before, _port_state(pm, opt), _jax_state_dict(pm, states[1]))


def test_eval_step_matches_jax(variables):
    """Running statistics, no update: the heads agree to 1e-4 as the folded
    forward does, and the logs and metric sums to rtol = 1e-4.  JAX paints
    with its XLA painter here (another order of the background sums)."""
    jm, v = variables
    batch = _batch(4, jax_side=True)
    mesh = data_mesh(n_devices=1)
    want_out, want_log, want_metric = jax.tree_util.tree_map(np.asarray, jax_make_eval_step(
        jm, JaxLoss(**LOSS), mesh)(v["params"], v["batch_stats"], shard_batch(batch, mesh)))
    torch.set_num_threads(1)
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, v), strict=True)
    out, log, metric = make_eval_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS),
                                      device="cpu")(batch)
    for got_pair, want_pair in zip(out, want_out):
        for g, w in zip(got_pair, want_pair):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    assert set(log) == set(want_log) and set(metric) == set(want_metric)
    for k in want_log:
        np.testing.assert_allclose(float(log[k]), float(want_log[k]), rtol=1e-4, err_msg=k)
    for k, (num, den) in want_metric.items():
        np.testing.assert_allclose([float(metric[k][0]), float(metric[k][1])], [num, den],
                                   rtol=1e-4, err_msg=k)


def test_nan_batch_is_skipped_and_state_is_unchanged(variables):
    _, v = variables
    pm, opt, step = _port(v)
    step(_batch(3), LR)  # momentum and the counter are live before the bad step
    snap = {k: t.clone() for k, t in pm.state_dict().items()}
    bufs = [b.clone() for b in opt.buffers]
    counter = opt.step.clone()
    bad = _batch(3)
    bad["image"][0, 5, 5, 0] = np.nan
    logs = step(bad, LR)
    assert float(logs["skipped"]) == 1.0 and not np.isfinite(float(logs["loss"]))
    for k, t in pm.state_dict().items():
        assert torch.equal(t.view(-1).view(torch.uint8), snap[k].view(-1).view(torch.uint8)), k
    for b, s in zip(opt.buffers, bufs):
        assert torch.equal(b.view(torch.int32), s.view(torch.int32))
    assert torch.equal(opt.step, counter)
    assert float(step(_batch(3), LR)["skipped"]) == 0.0


def test_sgd_matches_jax():
    """Three updates, the second gated off, on random leaves; SGD's
    arithmetic is elementwise in the same order, so the bits agree."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3), (7,), (2, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    jopt = JaxSGD(**SGD_KW)
    jp, jstate = list(params), jopt.init(list(params))
    tp = [torch.tensor(p) for p in params]
    topt = SGD(tp, **SGD_KW)
    for i, (g, gate) in enumerate(zip(grads, [True, False, True])):
        lr = 1e-3 * (i + 1)
        jp, jstate = jopt.apply(jp, g, jstate, lr, update_gate=np.bool_(gate))
        topt.apply([torch.tensor(x) for x in g], lr, update_gate=torch.tensor(gate))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jstate["momentum"], topt.buffers):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(topt.step) == int(jstate["step"]) == 2


@pytest.mark.parametrize("warmup", ["linear", "const", "power"])
def test_schedules_match_jax(warmup):
    kw = dict(warmup_type=warmup, warmup_iter=50, warmup_ratio=0.1, milestones=[80, 120],
              gamma=0.1, base_lr=1e-3)
    steps = list(range(0, 200, 7)) + [50, 51, 80, 120]
    assert [StepWarmUpLR(**kw)(s) for s in steps] == [JaxStepWarmUpLR(**kw)(s) for s in steps]
    poly = [PolyLR(150, base_lr=1e-3)(s) for s in steps]
    assert poly == [JaxPolyLR(150, base_lr=1e-3)(s) for s in steps]


def test_config_schedule_is_the_warmup_of_the_train_config():
    sched = StepWarmUpLR(**{k: v for k, v in cfg["lr_scheduler"].items() if k != "type"},
                         base_lr=cfg["optimizer"]["lr"])
    assert sched(0) == pytest.approx(1e-4) and sched(1000) == pytest.approx(1e-3)


@pytest.mark.parametrize("pack", [True, False])
def test_collate_matches_jax(pack):
    """Padding, the keep-the-largest truncation (a sample of 12 instances
    at max_instances = 10) and the uint8 image transport."""
    samples = _samples(5, (0, 4, 12))
    for transport in ("float32", "uint8"):
        want = jax_collate(samples, max_instances=10, pack_masks=pack, image_transport=transport)
        got = collate(samples, max_instances=10, pack_masks=pack, image_transport=transport)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
