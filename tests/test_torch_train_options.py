"""The train step's options in the port (``optim/param_groups.py``,
``optim/sgd.py``'s factors and mask, the backbone's ``freeze_backbone`` and
``batchnorm_eval``, ``trainer/builder.py::build_optimizer`` and ``remat``)
against ``orienmask_tpu``.

* SGD with per-parameter lr factors (not powers of two), weight decays and
  a freeze mask, three updates with the second gated off, is JAX's
  ``SGD.apply`` bit for bit when JAX is given the lr as an f32 scalar, as
  its jitted train step takes it: the port rounds the lr to f32 before its
  product with the factor (a Python float lr, JAX's eager way, rounds the
  product once in float64 and differs by an ulp).  Jitted on the CPU, XLA
  also contracts ``p - s * buf`` into a fused multiply-add, one rounding
  where the port's two ops (and JAX's eager ones) round twice: 3 of the
  108 elements of the leaf with factor 1.7 differ by an ulp there.
* ``param_group_factors`` classes the slim model's parameters as JAX's
  classes its pytree's leaves, exactly.
* One train step with ``freeze_backbone: 2``, ``backbone_batchnorm_eval``
  and ``param_groups`` (the slim model at 64², B = 4, f32; JAX on its master
  stem; the optimizers from each package's ``build_optimizer``) against
  JAX's step from the same weights: the loss to 1e-5 and the logs to 2e-4
  of themselves or 2e-6 of the loss (``test_torch_trainer.py``'s figures);
  the other parameters' gradients (read from the momentum) to 5% in
  relative L2 a tensor and 4% all together and their updates to 5%
  (``test_torch_train_step.py``'s); the heads' running statistics to 1e-3
  with an atol of 5e-5 of the tensor's largest value.  The frozen stages'
  parameters, every backbone BatchNorm buffer and the frozen momentum are
  equal by bits to JAX's (unchanged, zeros).  This is the file's one JAX
  train-step compile.
* ``remat`` against no remat from the same weights, on the CPU: loss,
  gradients, parameters, momentum and every BatchNorm buffer equal by bits,
  ``num_batches_tracked`` raised once, the backbone's layers run again in
  the backward and the heads' once; plain, with frozen stages and with
  ``batchnorm_eval``."""

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.data.collate import collate as jax_collate
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.ops.loss import OrienMaskYOLOMultiScaleLoss as JaxLoss
from orienmask_tpu.optim import SGD as JaxSGD
from orienmask_tpu.optim.param_groups import param_group_factors as jax_param_group_factors
from orienmask_tpu.parallel.mesh import data_mesh, shard_batch
from orienmask_tpu.trainer import builder as jax_builder
from orienmask_tpu.trainer.train_state import make_train_step as jax_make_train_step
from orienmask_tpu_torch.data import collate
from orienmask_tpu_torch.models import (
    OrienMaskYOLOFPNPlus,
    build_model,
    init_random,
    variables_from_jax,
    variables_to_jax,
)
from orienmask_tpu_torch.models.layers import ConvBNLeaky
from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
from orienmask_tpu_torch.optim import SGD, param_group_factors
from orienmask_tpu_torch.trainer import builder, make_train_step

SIZE = 64
SLIM = (1, 1, 1, 1, 1)
NUM_CLASSES = 8
COUNTS = (3, 5, 2, 4)  # instances per image: B = 4
LOSS = dict(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
            image_size=[SIZE, SIZE],
            anchors=[[4, 6], [8, 10], [12, 8], [10, 20], [20, 16], [18, 36],
                     [36, 28], [48, 60], [60, 50]],
            anchor_mask=[[6, 7, 8], [3, 4, 5], [0, 1, 2]], num_classes=NUM_CLASSES,
            center_region=0.6, valid_region=0.6, obj_ignore_threshold=0.7,
            weight=[1, 1, 1, 1, 1, 20, 20], scales_weight=[1, 1, 1])
OPTIMIZER = {"type": "SGD", "lr": 1e-3, "momentum": 0.9, "weight_decay": 5e-4,
             "param_groups": {"norm_weight_decay": 0.0, "bias_lr_factor": 2.0,
                              "bias_weight_decay": 0.0}}
OPTIONS = {"freeze_backbone": 2, "backbone_batchnorm_eval": True}
LR = 1e-4
LOSS_RTOL, LOG_RTOL, LOG_ATOL_OF_LOSS = 1e-5, 2e-4, 2e-6
GRAD_RTOL, GRAD_RTOL_ALL, UPDATE_RTOL = 0.05, 0.04, 0.05


def _samples(seed, counts=COUNTS, size=SIZE):
    """Transformed samples: images in [0, 1], boxes with elliptic masks."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size] / np.float32(size)
    out = []
    for k in counts:
        w, h = rng.uniform(0.15, 0.7, k), rng.uniform(0.15, 0.7, k)
        cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        masks = (((xs - cx[:, None, None]) / (w[:, None, None] / 2)) ** 2
                 + ((ys - cy[:, None, None]) / (h[:, None, None] / 2)) ** 2 <= 1)
        out.append({"image": rng.uniform(0, 1, (size, size, 3)).astype(np.float32),
                    "bbox": np.stack([cx, cy, w, h], -1).astype(np.float32),
                    "cls": rng.integers(0, NUM_CLASSES, k), "mask": masks})
    return out


def _model_cfg(**options):
    return {"type": "OrienMaskYOLOFPNPlus", "num_anchors": 3, "num_classes": NUM_CLASSES,
            "backbone_stage_blocks": list(SLIM), **options}


@pytest.fixture(scope="module")
def init():
    """The port's seeded init as a state dict."""
    torch.set_num_threads(1)
    pm = init_random(OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM), seed=0)
    return {k: t.clone() for k, t in pm.state_dict().items()}


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


# ------------------------------------------------------------------ SGD

def test_sgd_with_factors_and_mask_matches_jax():
    """Three updates, the second gated off, with lr factors that are not
    powers of two, absolute weight decays and a frozen leaf, against JAX's
    ``SGD.apply`` given the lr as an f32 scalar."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3), (7,), (2, 5), (6,)]
    lr_factors, wd_factors = [1.7, 1.0, 0.3, 2.0], [5e-4, 0.0, 1e-4, 0.0]
    frozen = [False, True, False, False]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    kw = dict(momentum=0.9, weight_decay=5e-4, lr_factors=lr_factors, wd_factors=wd_factors,
              freeze_mask=frozen)
    jopt = JaxSGD(lr=1e-3, **kw)
    jp, jstate = list(params), jopt.init(list(params))
    tp = [torch.tensor(p) for p in params]
    topt = SGD(tp, lr=1e-3, **kw)
    for i, (g, gate) in enumerate(zip(grads, [True, False, True])):
        lr = 1.3e-3 * (i + 1)
        jp, jstate = jopt.apply(jp, g, jstate, np.float32(lr), update_gate=np.bool_(gate))
        topt.apply([torch.tensor(x) for x in g], lr, update_gate=torch.tensor(gate))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a).view(np.uint32))
    for a, b in zip(jstate["momentum"], topt.buffers):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a).view(np.uint32))
    np.testing.assert_array_equal(tp[1].numpy(), params[1])
    assert not topt.buffers[1].any()
    assert int(topt.step) == int(jstate["step"]) == 2


@pytest.mark.parametrize("groups", [{}, OPTIMIZER["param_groups"]], ids=["defaults", "config"])
def test_param_group_factors_match_jax(init, groups):
    """Per parameter of the slim model, in order: JAX's factor of the leaf
    that ``variables_from_jax`` maps to it."""
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    pm.load_state_dict(init)
    params = jax.tree_util.tree_map(np.asarray, variables_to_jax(pm)["params"])
    want = jax_param_group_factors(params, weight_decay=5e-4, **groups)
    got = param_group_factors(pm, weight_decay=5e-4, **groups)
    names = [name for name, _ in pm.named_parameters()]
    for want_tree, got_list in zip(want, got):
        full = jax.tree_util.tree_map(lambda f, p: np.full(p.shape, f, np.float64),
                                      want_tree, params)
        by_name = variables_from_jax(pm, {"params": full, "batch_stats": None})
        assert len(got_list) == len(names)
        for name, value in zip(names, got_list):
            assert np.all(by_name[name].numpy() == value), name


# ------------------------------------------------- frozen stages, vs JAX

def _port_step(init, model_cfg, remat=False):
    pm = build_model(model_cfg)
    pm.load_state_dict(init, strict=True)
    opt = builder.build_optimizer(OPTIMIZER, pm)
    step = make_train_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS), opt,
                           device="cpu", remat=remat)
    return pm, opt, step


def test_frozen_and_batchnorm_eval_step_matches_jax(init):
    batch_np = _samples(0)
    pm, opt, step = _port_step(init, _model_cfg(**OPTIONS))
    names = [name for name, _ in pm.named_parameters()]
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    logs = {k: float(v) for k, v in step(collate(batch_np, max_instances=8,
                                                 pack_masks=True), LR).items()}

    jm = JaxModel(num_anchors=3, num_classes=NUM_CLASSES, backbone_stage_blocks=SLIM, **OPTIONS)
    jm.backbone.s2d_stem = False
    variables = jax.tree_util.tree_map(np.asarray, variables_to_jax(pm, before))
    jopt = jax_builder.build_optimizer(OPTIMIZER, jm, variables["params"])
    jstep, jinit = jax_make_train_step(jm, JaxLoss(**LOSS), jopt, data_mesh(n_devices=1))
    state, jlogs = jstep(jinit(variables), shard_batch(jax_collate(
        batch_np, max_instances=8, pack_masks=True), data_mesh(n_devices=1)), LR, True)
    state = jax.tree_util.tree_map(np.asarray, state)
    jlogs = {k: float(np.asarray(v)) for k, v in jlogs.items()}

    np.testing.assert_allclose(logs["loss"], jlogs["loss"], rtol=LOSS_RTOL)
    assert logs.keys() == jlogs.keys() and logs["skipped"] == jlogs["skipped"] == 0.0
    for k in jlogs:
        np.testing.assert_allclose(logs[k], jlogs[k], rtol=LOG_RTOL,
                                   atol=LOG_ATOL_OF_LOSS * jlogs["loss"], err_msg=k)
    want_sd = variables_from_jax(pm, {"params": state["params"],
                                      "batch_stats": state["batch_stats"]})
    want_buf = variables_from_jax(pm, {"params": state["opt_state"]["momentum"],
                                       "batch_stats": None})
    got_sd = pm.state_dict()
    frozen = dict(zip(names, opt.freeze_mask))
    wd = dict(zip(names, opt.wd_factors))
    assert [n for n in names if frozen[n]] == [n for n in names if n.startswith(
        ("backbone.conv1.", "backbone.conv2."))]
    worst_grad = worst_update = 0.0
    diffs, grads = [], []
    for k, want in want_sd.items():
        if "num_batches_tracked" in k:
            continue
        if k.startswith("backbone.") and "running_" in k or frozen.get(k):
            assert torch.equal(_bits(got_sd[k]), _bits(want)), k
            assert torch.equal(_bits(got_sd[k]), _bits(before[k])), k
            continue
        if "running_" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), rtol=1e-3,
                                       atol=5e-5 * np.abs(want.numpy()).max(), err_msg=k)
            continue
        buf = opt.buffers[names.index(k)].double()
        want_grad = want_buf[k].double() - wd[k] * before[k].double()
        diff = (buf - want_buf[k].double()).numpy()
        worst_grad = max(worst_grad, np.linalg.norm(diff) / np.linalg.norm(want_grad.numpy()))
        diffs.append(diff.ravel())
        grads.append(want_grad.numpy().ravel())
        step_want = (want.double() - before[k].double()).numpy()
        step_got = (got_sd[k].double() - before[k].double()).numpy()
        worst_update = max(worst_update,
                           np.linalg.norm(step_got - step_want) / np.linalg.norm(step_want))
    together = np.linalg.norm(np.concatenate(diffs)) / np.linalg.norm(np.concatenate(grads))
    assert worst_grad < GRAD_RTOL and together < GRAD_RTOL_ALL, (worst_grad, together)
    assert worst_update < UPDATE_RTOL, worst_update
    for name, buf in zip(names, opt.buffers):
        if frozen[name]:
            assert not buf.any() and not want_buf[name].any(), name
    assert int(opt.step) == int(state["opt_state"]["step"]) == 1


def test_frozen_stages_keep_their_state_under_remat(init):
    """Two steps with ``freeze_backbone: 2`` and ``remat``: conv1 and conv2
    keep their parameters and BatchNorm buffers by bits and have zero
    momentum; every other parameter and the later stages' buffers move; the
    counter counts both steps."""
    pm, opt, step = _port_step(init, _model_cfg(freeze_backbone=2), remat=True)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    for seed in (0, 1):
        assert float(step(collate(_samples(seed), max_instances=8, pack_masks=True),
                          LR)["skipped"]) == 0.0
    frozen = ("backbone.conv1.", "backbone.conv2.")
    for k, t in pm.state_dict().items():
        if "num_batches_tracked" in k:
            continue
        assert torch.equal(_bits(t), _bits(before[k])) is k.startswith(frozen), k
    for (name, _), buf in zip(pm.named_parameters(), opt.buffers):
        assert (not buf.any()) is name.startswith(frozen), name
    assert int(opt.step) == 2


# ----------------------------------------------------------------- remat

def _run(init, model_cfg, remat):
    """One step: (logs, gradients, state dict, momentum, backbone and head
    ConvBNLeaky calls)."""
    pm, opt, step = _port_step(init, model_cfg, remat)
    grads, calls = [], {"backbone": 0, "heads": 0}
    apply = opt.apply
    opt.apply = lambda g, lr, update_gate=None: (grads.append([x.clone() for x in g]),
                                                 apply(g, lr, update_gate))
    for name, m in pm.named_modules():
        if isinstance(m, ConvBNLeaky):
            part = "backbone" if name.startswith("backbone.") else "heads"
            m.register_forward_hook(lambda *_, part=part: calls.__setitem__(
                part, calls[part] + 1))
    logs = step(collate(_samples(0), max_instances=8, pack_masks=True), LR)
    return ({k: float(v) for k, v in logs.items()}, grads[0],
            {k: t.clone() for k, t in pm.state_dict().items()},
            [b.clone() for b in opt.buffers], calls)


@pytest.mark.parametrize("options", [{}, {"freeze_backbone": 2}, {"backbone_batchnorm_eval": True}],
                         ids=["plain", "freeze_backbone", "batchnorm_eval"])
def test_remat_changes_nothing_but_memory(init, options):
    off = _run(init, _model_cfg(**options), remat=False)
    on = _run(init, _model_cfg(**options), remat=True)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert torch.equal(_bits(a), _bits(b))
    for k in off[2]:
        assert torch.equal(_bits(on[2][k]), _bits(off[2][k])), k
    for a, b in zip(on[3], off[3]):
        assert torch.equal(_bits(a), _bits(b))
    n_backbone = sum(isinstance(m, ConvBNLeaky) and n.startswith("backbone.")
                     for n, m in OrienMaskYOLOFPNPlus(
                         3, NUM_CLASSES, backbone_stage_blocks=SLIM).named_modules())
    # the recompute stops once it has what the backward needs (26 calls of
    # the 16 layers, measured)
    assert off[4]["backbone"] == n_backbone < on[4]["backbone"] <= 2 * n_backbone
    assert on[4]["heads"] == off[4]["heads"]
    tracked = {k: int(t) for k, t in on[2].items() if k.endswith("num_batches_tracked")}
    assert set(tracked.values()) <= {0, 1} and any(tracked.values())
