"""Data parallelism of the port (``parallel/mesh.py``, ``utils/envs.py`` and
the collectives of the BatchNorm, the loss and the train step) on two CPU
ranks over gloo, against one process on the concatenated batch and against
JAX's ``make_train_step`` on a 2-device mesh (conftest's virtual devices).

One pair of rank processes (``python tests/test_torch_parallel.py RANK 2
DIR``: one thread each, a file rendezvous, a deadline each) runs every case
in order, counting every collective it issues, and saves what it saw; the
tests compare.  Meanwhile this process runs the port in one process and
compiles the file's one JAX train step, ``accumulate=2`` on the 2-device
mesh: a first microbatch with ``do_step`` and twice the lr is an
``accumulate=1`` step bit for bit (the accumulator starts at zeros).

The step: the slim model (stage blocks (1, 1, 1, 1, 1)) at the published
widths, 64², 8 classes, f32, B = 2 a rank (4 in all), lr 1e-4 (the
train config's first step), from one seeded init of the port's
(``init_random``) given to JAX through ``variables_to_jax``.  Tolerances, each
from measurement (worst seen in brackets):

* The synced BatchNorm (one ``ConvBNLeaky``, 2 + 2 images): outputs and
  gradients to 1e-5 of each tensor's largest value against
  ``nn.BatchNorm2d`` and JAX on the 4 images (measured 3.4e-7), as
  ``test_torch_models.py`` holds one process to JAX; running statistics to
  2e-6 of themselves (4.8e-7).
* The loss with global divisors: the ranks' losses, log terms, metric
  pairs and the heads' gradients add up to one process's on the 4 images to
  1e-6 of themselves (measured 0: two terms sum exactly).
* The step: logs to 2e-4 of themselves, as the train-step test states,
  against the port in one process and JAX (measured 1.7e-5 and 1.4e-5: the
  wh and orientation terms); gradients (read from the momentum) to 5% in
  relative L2 a tensor and 4% all together against either, as
  ``test_torch_train_step.py`` states for random weights (measured 3.3% and
  2.9% a tensor, 2.2% all together; the port in one process and JAX differ
  by 3.3% and 2.7% there); BN running statistics to 1e-3 with an atol of
  5e-5 of the tensor's largest value.
  Both ranks end equal by bits.
* ``remat`` with ``freeze_backbone: 2`` (one step on 2 + 2 images): each
  rank's state equal by bits to its step without ``remat``, both ranks
  equal by bits, the frozen stages unchanged with zero momentum; against
  one process at the step's tolerances; the recompute issues no collective
  and the frozen stages' eval-mode BatchNorms none either.
"""

import datetime
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from orienmask_tpu.data.collate import collate as jax_collate
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.layers import ConvBNLeaky as JaxConvBNLeaky
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu.ops.loss import OrienMaskYOLOMultiScaleLoss as JaxLoss
from orienmask_tpu.optim import SGD as JaxSGD
from orienmask_tpu.parallel.mesh import data_mesh, shard_batch
from orienmask_tpu.trainer.train_state import make_train_step as jax_make_train_step
from orienmask_tpu.utils import envs as jax_envs
from orienmask_tpu_torch.data import collate
from orienmask_tpu_torch.models import (
    OrienMaskYOLOFPNPlus,
    init_random,
    variables_from_jax,
    variables_to_jax,
)
from orienmask_tpu_torch.models.layers import ConvBNLeaky
from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
from orienmask_tpu_torch.optim import SGD
from orienmask_tpu_torch.parallel import mesh
from orienmask_tpu_torch.trainer import make_train_step
from orienmask_tpu_torch.trainer.builder import _freeze_mask
from orienmask_tpu_torch.utils import envs

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
RANK_DEADLINE_S = 300
SIZE = 64
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
COUNTS_A, COUNTS_B = (3, 5, 2, 4), (2, 4, 3, 1)  # instances an image, microbatches A, B


# ------------------------------------------------------------------ inputs

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


def _batch(samples, jax_side=False):
    return (jax_collate if jax_side else collate)(samples, max_instances=8, pack_masks=True)


def _share(samples, rank, world=WORLD):
    n = len(samples) // world
    return samples[rank * n:(rank + 1) * n]


def _bn_inputs():
    """One ConvBNLeaky's parameters (JAX layout), input and cotangent for 4
    images (NHWC)."""
    rng = np.random.default_rng(7)
    params = {"kernel": rng.standard_normal((3, 3, 3, 6)).astype(np.float32) * 0.3,
              "scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.uniform(-0.2, 0.2, 6).astype(np.float32)}
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32) + 0.5
    cot = rng.standard_normal((4, 8, 8, 6)).astype(np.float32)
    return params, x, cot


def _bn_layer(params):
    layer = ConvBNLeaky(3, 6, 3, padding=1).train()
    with torch.no_grad():
        layer.conv_block[0].weight.copy_(torch.from_numpy(params["kernel"].transpose(3, 2, 0, 1)))
        layer.conv_block[1].weight.copy_(torch.from_numpy(params["scale"]))
        layer.conv_block[1].bias.copy_(torch.from_numpy(params["bias"]))
    return layer


def _run_bn(x, cot):
    """Outputs, gradients and running statistics of ``_bn_layer`` on
    ``x`` (a group's share, or all 4 images without one), NHWC."""
    layer = _bn_layer(_bn_inputs()[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = layer(xt, torch.float32)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    conv, bn = layer.conv_block
    return {"out": out.detach().permute(0, 2, 3, 1), "input": xt.grad.permute(0, 2, 3, 1),
            "kernel": conv.weight.grad.permute(2, 3, 1, 0), "scale": bn.weight.grad,
            "bias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


LOSS_CASES = {
    # rank 1's two images hold no instance: no positives there
    "no_positives": dict(counts=(2, 3, 0, 0), weight=None, training=True),
    # rank 1's two images weigh 0 (the wrap-pads of a val batch)
    "zero_weights": dict(counts=(2, 3, 1, 2), weight=(1.0, 1.0, 0.0, 0.0), training=False),
}


def _loss_inputs(case):
    """Random heads (JAX layout) and the collated targets of 4 images."""
    rng = np.random.default_rng(11)
    heads = []
    for (g, _), _ in zip(LOSS["grid_size"], LOSS["anchor_mask"]):
        heads.append((rng.standard_normal((4, g, g, 3 * (5 + NUM_CLASSES))).astype(np.float32),
                      rng.standard_normal((4, SIZE // 4, SIZE // 4, 6)).astype(np.float32)))
    spec = LOSS_CASES[case]
    target = _batch(_samples(12, spec["counts"]))
    if spec["weight"] is not None:
        target["sample_weight"] = np.asarray(spec["weight"], np.float32)
    return heads, {k: v for k, v in target.items() if k != "image"}, spec["training"]


def _run_loss(case, rows):
    """The port's loss on ``rows`` of the case's 4 images: loss, logs,
    metric pairs and the heads' gradients."""
    heads, target, training = _loss_inputs(case)
    heads = [tuple(torch.from_numpy(h[rows]).requires_grad_() for h in pair) for pair in heads]
    target = {k: torch.from_numpy(v[rows]) for k, v in target.items()}
    loss = OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS)
    loss_sum, log, metrics = loss(heads, target, training=training)
    grads = torch.autograd.grad(loss_sum, [h for pair in heads for h in pair])
    return {"loss": loss_sum.detach(), "log": {k: v.detach() for k, v in log.items()},
            "metrics": {k: torch.stack([v[0], v[1]]) for k, v in metrics.items()},
            "grads": [g for g in grads]}


def _port_model(init, accumulate=1):
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    pm.load_state_dict(init, strict=True)
    opt = SGD(pm.parameters(), **SGD_KW)
    step = make_train_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS), opt,
                           accumulate=accumulate, device="cpu")
    return pm, opt, step


def _digest(*tensor_dicts):
    h = hashlib.sha256()
    for tensors in tensor_dicts:
        for t in tensors.values():
            h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _port_state(pm, opt, logs):
    names = [name for name, _ in pm.named_parameters()]
    state = {k: t.clone() for k, t in pm.state_dict().items()}
    momentum = {n: b.clone() for n, b in zip(names, opt.buffers)}
    return {"state": state, "momentum": momentum, "digest": _digest(state, momentum),
            "step": int(opt.step), "logs": {k: float(v) for k, v in logs.items()}}


def _steps(init, rank=None):
    """The step cases on this rank's share (``rank`` None: one process, all
    4 images, no NaN case)."""
    a, b = _samples(0, COUNTS_A), _samples(1, COUNTS_B)
    if rank is not None:
        a, b = _share(a, rank), _share(b, rank)
    out = {}
    pm, opt, step = _port_model(init)
    out["step"] = _port_state(pm, opt, step(_batch(a), LR))

    if rank is not None:
        nan_batch = _batch(a)
        if rank == 1:
            nan_batch["image"][-1, 5, 7, 1] = np.nan
        pm, opt, step = _port_model(init)
        out["nan"] = _port_state(pm, opt, step(nan_batch, LR))

    pm, opt, step = _port_model(init, accumulate=2)
    first = step(_batch(a), 2 * LR, False)
    out["accumulate"] = _port_state(pm, opt, step(_batch(b), 2 * LR, True))
    out["accumulate"]["first_logs"] = {k: float(v) for k, v in first.items()}
    return out


def _option_steps(init, rank=None):
    """One step on this rank's share of A (``rank`` None: one process, all
    4 images) with ``freeze_backbone: 2``, with ``remat`` and without."""
    a = _samples(0, COUNTS_A)
    if rank is not None:
        a = _share(a, rank)
    out = {}
    for case, remat in (("options_remat", True), ("options", False)):
        pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM, freeze_backbone=2)
        pm.load_state_dict(init, strict=True)
        opt = SGD(pm.parameters(), freeze_mask=_freeze_mask(pm), **SGD_KW)
        step = make_train_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS), opt,
                               device="cpu", remat=remat)
        out[case] = _port_state(pm, opt, step(_batch(a), LR))
    return out


# ------------------------------------------------------------- the ranks

def _count_collectives(log):
    """Wrap the collectives the port calls so that each appends (name,
    shape, dtype) to ``log``."""
    for name in ("all_reduce", "broadcast", "barrier"):
        def wrapped(*args, _fn=getattr(dist, name), _name=name, **kw):
            t = args[0] if args and isinstance(args[0], torch.Tensor) else None
            log.append((_name, tuple(t.shape) if t is not None else (),
                        str(t.dtype) if t is not None else ""))
            return _fn(*args, **kw)
        setattr(dist, name, wrapped)


def rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    workdir = Path(workdir)
    collectives = []
    _count_collectives(collectives)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {}
    tree = {"a": np.arange(3, dtype=np.int64) * (rank + 1),
            "b": [float(rank), np.float32(2.5)], "t": torch.tensor([rank + 1.0])}
    out["contracts"] = {"rank": envs.get_device_rank(), "world": envs.get_world_size(),
                        "local": envs.get_local_device_count(),
                        "sum": envs.reduce_sum(tree), "mean": envs.reduce_mean(tree),
                        "stamp": envs.broadcast_str(f"0101_00000{rank}")}
    _, x, cot = _bn_inputs()
    collectives.append("bn")
    out["bn"] = _run_bn(x[2 * rank:2 * rank + 2], cot[2 * rank:2 * rank + 2])
    collectives.append("loss")
    out["loss"] = {case: _run_loss(case, slice(2 * rank, 2 * rank + 2)) for case in LOSS_CASES}
    init = torch.load(workdir / "init.pt")
    collectives.append("steps")
    out.update(_steps(init, rank))
    collectives.append("replicate")
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    if rank == 0:
        pm.load_state_dict(init)
    mesh.replicate_global([*pm.parameters(), *pm.buffers()])
    out["replicated"] = {"state": pm.state_dict(), "digest": _digest(pm.state_dict())}
    collectives.append("options")
    out.update(_option_steps(init, rank))
    dist.destroy_process_group()
    out["collectives"] = collectives
    if rank != 0:  # rank 0 keeps the tensors; the others their digests
        for case in ("step", "nan", "accumulate", "replicated", "options", "options_remat"):
            out[case].pop("state")
            out[case].pop("momentum", None)
    torch.save(out, workdir / f"rank{rank}.pt")


# ------------------------------------------------------------ the fixture

def _init():
    """The port's seeded init (``init_random``), its state dict, and the JAX
    model with the same weights (the port's stem)."""
    pm = init_random(OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM), seed=0)
    jm = JaxModel(num_anchors=3, num_classes=NUM_CLASSES, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = jax.tree_util.tree_map(np.asarray, variables_to_jax(pm))
    return jm, variables, pm, {k: t.clone() for k, t in pm.state_dict().items()}


def _jax_steps(jm, variables):
    """JAX on a 2-device mesh, accumulate=2: (the accumulate=1 step on A
    at LR, the state after A then B), each as (state, logs)."""
    mesh2 = data_mesh(n_devices=WORLD)
    step, init = jax_make_train_step(jm, JaxLoss(**LOSS), JaxSGD(**SGD_KW), mesh2, accumulate=2)
    a = shard_batch(_batch(_samples(0, COUNTS_A), True), mesh2)
    b = shard_batch(_batch(_samples(1, COUNTS_B), True), mesh2)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    one, log_one = step(init(variables), a, 2 * LR, True)
    mid, log_a = step(init(variables), a, 2 * LR, False)
    acc, log_b = step(mid, b, 2 * LR, True)
    return {"step": (host(one), host(log_one)), "accumulate": (host(acc), host(log_b)),
            "first_logs": host(log_a)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's and rank 1's results, one process's, JAX's, the init);
    the ranks' files go when the module ends."""
    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("ranks")
    jm, variables, pm, init = _init()
    torch.save(init, workdir / "init.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(workdir)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        one = {"bn": _run_bn(*_bn_inputs()[1:]),
               "loss": {case: _run_loss(case, slice(0, 4)) for case in LOSS_CASES},
               **_steps(init), **_option_steps(init)}
        want = _jax_steps(jm, variables)
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=RANK_DEADLINE_S)
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    shutil.rmtree(workdir, ignore_errors=True)
    yield ranks, one, want, (pm, variables, init)


# ----------------------------------------------------------------- checks

def _rel_max(got, want):
    """The largest difference over the largest value (the difference alone
    where ``want`` is all zeros: a loss term with no positives)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def test_reductions_and_broadcast_keep_jax_contracts(runs):
    """Under a group: the sum and mean of every leaf over the ranks, numpy
    leaves as numpy of their dtype, tensors as tensors; rank 0's string on
    every rank.  Without one, both packages hand back their input."""
    ranks = runs[0]
    for r, out in enumerate(ranks):
        c = out["contracts"]
        assert (c["rank"], c["world"], c["local"]) == (r, WORLD, 1)
        np.testing.assert_array_equal(c["sum"]["a"], np.arange(3) * 3)
        assert c["sum"]["a"].dtype == np.int64
        assert [float(v) for v in c["sum"]["b"]] == [1.0, 5.0]
        assert torch.equal(c["sum"]["t"], torch.tensor([3.0]))
        np.testing.assert_array_equal(c["mean"]["a"], np.arange(3) * 1.5)
        assert [float(v) for v in c["mean"]["b"]] == [0.5, 2.5]
        assert torch.equal(c["mean"]["t"], torch.tensor([1.5]))
        assert c["stamp"] == "0101_000000"
    tree = {"a": np.arange(3), "b": [1.0]}
    for port, ref in ((envs.reduce_sum, jax_envs.reduce_sum),
                      (envs.reduce_mean, jax_envs.reduce_mean)):
        assert port(tree) is tree and ref(tree) is tree
    assert envs.broadcast_str("0101_000001") == jax_envs.broadcast_str("0101_000001")
    assert (envs.get_device_rank(), envs.get_world_size()) == (0, 1)


def test_synced_batchnorm_is_the_global_batchs(runs):
    """Forward, backward (input, kernel, scale, bias: the ranks' parameter
    gradients summed) and running statistics of one ConvBNLeaky on 2 + 2
    images against nn.BatchNorm2d and JAX's ConvBNLeaky on all 4."""
    ranks, one = runs[0], runs[1]
    params, x, cot = _bn_inputs()
    jl = JaxConvBNLeaky(3, 6, 3, padding=1)
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    out, new_stats = jl.apply(params, stats, jnp.asarray(x), default_ctx(train=True))
    _, vjp = jax.vjp(lambda p, x: jl.apply(p, stats, x, default_ctx(train=True))[0],
                     params, jnp.asarray(x))
    want_p, want_x = jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(cot)))
    jax_ref = {"out": np.asarray(out), "input": want_x, "kernel": want_p["kernel"],
               "scale": want_p["scale"], "bias": want_p["bias"]}
    got = {k: torch.cat([ranks[0]["bn"][k], ranks[1]["bn"][k]]) for k in ("out", "input")}
    got.update({k: ranks[0]["bn"][k] + ranks[1]["bn"][k] for k in ("kernel", "scale", "bias")})
    for name, value in got.items():
        for ref_name, ref in (("nn.BatchNorm2d", one["bn"][name]), ("JAX", jax_ref[name])):
            err = _rel_max(value, ref)
            assert err < 1e-5, f"{name} vs {ref_name}: {err:.2e} of the largest value"
    for key, jax_key in (("running_mean", "mean"), ("running_var", "var")):
        assert torch.equal(ranks[0]["bn"][key], ranks[1]["bn"][key])
        for ref in (one["bn"][key], np.asarray(new_stats[jax_key])):
            np.testing.assert_allclose(ranks[0]["bn"][key].numpy(), ref, rtol=2e-6, atol=0,
                                       err_msg=key)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_uses_global_divisors(runs, case):
    """The ranks' losses, log terms and metric pairs add up to one
    process's on the 4 images; each rank's heads get one process's
    gradient rows."""
    ranks, one = runs[0], runs[1]
    got = [r["loss"][case] for r in ranks]
    want = one["loss"][case]
    np.testing.assert_allclose(float(got[0]["loss"] + got[1]["loss"]), float(want["loss"]),
                               rtol=1e-6)
    for key, value in want["log"].items():
        np.testing.assert_allclose(float(got[0]["log"][key] + got[1]["log"][key]), float(value),
                                   rtol=1e-6, atol=1e-6 * float(want["loss"]), err_msg=key)
    for key, value in want["metrics"].items():
        np.testing.assert_allclose((got[0]["metrics"][key] + got[1]["metrics"][key]).numpy(),
                                   value.numpy(), rtol=1e-6, err_msg=key)
    assert bool(want["metrics"]) == (not LOSS_CASES[case]["training"])
    for i, g in enumerate(want["grads"]):
        both = torch.cat([got[0]["grads"][i], got[1]["grads"][i]])
        assert _rel_max(both, g) < 1e-6, f"head {i}: {_rel_max(both, g):.2e}"


def _grad_errors(got, want, init, names):
    """Worst relative L2 error of a tensor's gradient and of all together,
    read from the momentum after one step from ``init`` (zero momentum:
    buf = grad + weight_decay * param)."""
    worst, diff_all, grad_all = 0.0, [], []
    for n in names:
        want_grad = want["momentum"][n].double() - SGD_KW["weight_decay"] * init[n].double()
        diff = (got["momentum"][n].double() - want["momentum"][n].double()).numpy()
        worst = max(worst, np.linalg.norm(diff) / np.linalg.norm(want_grad.numpy()))
        diff_all.append(diff.ravel())
        grad_all.append(want_grad.numpy().ravel())
    together = np.linalg.norm(np.concatenate(diff_all)) / np.linalg.norm(np.concatenate(grad_all))
    return worst, together


def _jax_as_port(pm, state, logs):
    np_state = jax.tree_util.tree_map(np.asarray, state)
    stats = np_state["batch_stats"]
    sd = variables_from_jax(pm, {"params": np_state["params"], "batch_stats": stats})
    momentum = variables_from_jax(pm, {"params": np_state["opt_state"]["momentum"],
                                       "batch_stats": stats})
    names = [name for name, _ in pm.named_parameters()]
    return {"state": sd, "momentum": {n: momentum[n] for n in names},
            "step": int(np_state["opt_state"]["step"]),
            "logs": {k: float(v) for k, v in logs.items()}}


@pytest.mark.parametrize("case", ["step", "accumulate"])
def test_two_rank_step_matches_one_process_and_jax(runs, case):
    """One step (``step``: accumulate 1 on A; ``accumulate``: A then B at
    accumulate 2) on 2 ranks of 2 images against the port in one process
    and JAX on a 2-device mesh on 4: logs, gradients, statistics; both
    ranks equal by bits."""
    ranks, one, want, (pm, _, init) = runs
    got = ranks[0][case]
    assert got["digest"] == ranks[1][case]["digest"], "the ranks' states differ"
    assert got["logs"] == ranks[1][case]["logs"] and got["step"] == ranks[1][case]["step"] == 1
    assert got["logs"]["skipped"] == 0.0
    jax_ref = _jax_as_port(pm, *want[case])
    names = list(got["momentum"])
    for ref_name, ref, log_rtol in (("one process", one[case], 2e-4), ("JAX", jax_ref, 2e-4)):
        for key, value in ref["logs"].items():
            np.testing.assert_allclose(got["logs"][key], value, rtol=log_rtol,
                                       atol=2e-6 * ref["logs"]["loss"],
                                       err_msg=f"{key} vs {ref_name}")
        worst, together = _grad_errors(got, ref, init, names)
        assert worst < 0.05 and together < 0.04, \
            f"gradients vs {ref_name}: worst tensor {worst:.4f}, all {together:.4f}"
        for k, w in ref["state"].items():
            if "running_" in k:
                np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=1e-3,
                                           atol=5e-5 * np.abs(w.numpy()).max(), err_msg=k)
    if case == "accumulate":
        for key, value in want["first_logs"].items():
            np.testing.assert_allclose(got["first_logs"][key], float(value), rtol=2e-4,
                                       atol=2e-6 * float(want["first_logs"]["loss"]),
                                       err_msg=key)


def test_a_nan_on_one_rank_skips_the_step_on_both(runs):
    """A NaN pixel in rank 1's batch: both ranks log the NaN loss and
    ``skipped``, and leave parameters, BN buffers, momentum and the update
    counter as they were, by bits."""
    ranks, _, _, (_, _, init) = runs
    for r in ranks:
        nan = r["nan"]
        assert np.isnan(nan["logs"]["loss"]) and nan["logs"]["skipped"] == 1.0
        assert nan["step"] == 0 and nan["digest"] == ranks[0]["nan"]["digest"]
    for name, t in init.items():
        assert torch.equal(ranks[0]["nan"]["state"][name], t), name
    assert all(not m.any() for m in ranks[0]["nan"]["momentum"].values())


def test_collectives_match_in_count_and_size(runs):
    """Both ranks issue the same collectives, of the same shapes and
    dtypes, in the same order; a train step issues two a BatchNorm, one for
    the loss's counts, one a gradient bucket and one for the logs."""
    ranks, _, _, (pm, _, _) = runs
    seq = [r["collectives"] for r in ranks]
    assert seq[0] == seq[1]
    steps = seq[0][seq[0].index("steps") + 1:seq[0].index("replicate")]
    n_bn = sum(isinstance(m, ConvBNLeaky) for m in pm.modules())
    n_buckets = len(mesh._buckets(list(pm.parameters())))
    one_step = 2 * n_bn + 1 + n_buckets + 1
    # step, NaN step, two accumulate microbatches
    assert len(steps) == 4 * one_step, (len(steps), one_step)
    assert all(name == "all_reduce" for name, _, _ in steps)


def test_remat_and_frozen_stages_on_two_ranks(runs):
    """``remat`` and ``freeze_backbone: 2`` under a group: the recompute
    takes the first pass's global statistics (no collective, the buffers
    updated once), so each rank ends where its step without ``remat`` ends,
    by bits, and both ranks equal; the frozen stages keep their parameters
    and buffers with zero momentum; against one process at the step's
    tolerances.  A step issues two collectives a BatchNorm outside the
    frozen stages, one for the loss's counts, one a bucket and one for the
    logs, on both ranks alike."""
    ranks, one, _, (pm, _, init) = runs
    for r in (*ranks, one):
        assert r["options_remat"]["digest"] == r["options"]["digest"]
        assert r["options_remat"]["logs"] == r["options"]["logs"]
    got = ranks[0]["options_remat"]
    assert got["digest"] == ranks[1]["options_remat"]["digest"]
    assert got["logs"] == ranks[1]["options_remat"]["logs"] and got["step"] == 1
    frozen = ("backbone.conv1.", "backbone.conv2.")
    for name, t in init.items():
        if name.startswith(frozen):
            assert torch.equal(got["state"][name], t), name
    names = [n for n in got["momentum"] if not n.startswith(frozen)]
    assert all(not m.any() for n, m in got["momentum"].items() if n.startswith(frozen))
    ref = one["options_remat"]
    for key, value in ref["logs"].items():
        np.testing.assert_allclose(got["logs"][key], value, rtol=2e-4,
                                   atol=2e-6 * ref["logs"]["loss"], err_msg=key)
    worst, together = _grad_errors(got, ref, init, names)
    assert worst < 0.05 and together < 0.04, (worst, together)

    seq = [r["collectives"] for r in ranks]
    assert seq[0] == seq[1]
    steps = seq[0][seq[0].index("options") + 1:]
    n_bn = sum(isinstance(m, ConvBNLeaky) for m in pm.modules())
    n_frozen = sum(isinstance(m, ConvBNLeaky) for name in ("conv1", "conv2")
                   for m in getattr(pm.backbone, name).modules())
    one_step = 2 * (n_bn - n_frozen) + 1 + len(mesh._buckets(list(pm.parameters()))) + 1
    assert len(steps) == 2 * one_step and all(name == "all_reduce" for name, _, _ in steps)


def test_backend_rule(monkeypatch):
    """gloo on the CPU; NCCL when every rank has a card of its own; gloo
    with CUDA tensors when ranks share one (NCCL refuses two ranks on one
    device)."""
    card = torch.device("cuda", 0)
    assert mesh.choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.choose_backend(card, 1) == "nccl" and mesh.choose_backend(card, 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.choose_backend(card, 4) == "nccl" and mesh.choose_backend(card, 8) == "gloo"


def test_replicate_global_gives_rank_0s_state(runs):
    """Rank 1 starts from torch's own init and ends with rank 0's state."""
    ranks, _, _, (_, _, init) = runs
    assert ranks[0]["replicated"]["digest"] == ranks[1]["replicated"]["digest"]
    for name, t in init.items():
        assert torch.equal(ranks[0]["replicated"]["state"][name], t), name


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
