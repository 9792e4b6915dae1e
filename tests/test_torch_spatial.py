"""Spatial partitioning of the port (``parallel/spatial.py``: row shards over
a space group of ranks with halo exchange) on four CPU ranks over gloo,
against the port in one process and against the JAX package's
``orienmask_tpu/parallel/spatial.py`` on conftest's virtual CPU devices.

Four rank processes (``python tests/test_torch_spatial.py RANK 4 DIR``: one
thread each, a file rendezvous, a deadline each) run every case in order and
save what they saw; meanwhile this process runs the port in one process and
JAX's counterparts (one JAX train-step compile).  The ranks form two grids:
``spatial_groups(2, 2)`` (two data indices of two space ranks, JAX's
``spatial_mesh(2, 2)``) and ``spatial_groups(4)`` (one image over four).
The rank processes import no JAX.

The cases and their tolerances (worst measured in brackets):

* ``sync_batch_norm`` on four ranks holding 4, 8, 4 and 8 rows of the same
  two images (one ``ConvBNLeaky`` 1x1, train mode) against JAX's
  ``ConvBNLeaky`` on the whole 24 rows: outputs, input and parameter
  gradients to 1e-5 of each tensor's largest value, running statistics to
  2e-6 of theirs, as ``test_torch_parallel.py`` holds the even case.
* The halo helper (``layers.conv2d``, ``layers.max_pool_3x3_s2``) on two
  shards of 32 rows against the same call on the whole 64 rows: 3x3/1,
  3x3/2, 7x7/2 (ResNet's stem), 1x1/2, a grouped 3x3 and the max pool;
  outputs by bits, input gradients to 1e-6 of their largest value (1.4e-7:
  a halo row's gradient is added on its owner after the rest), weight
  gradients (the ranks' summed) to 1e-5 (1.2e-6).
* ``spatial_forward`` of the slim model, f32, folded, at 128² (64 + 64
  rows) and 96² (64 + 32: uneven) against the port in one process and
  JAX's ``spatial_forward``, to 1e-6 of each head's largest value (1.2e-7
  against either; JAX's own test holds 2e-5, tests/test_spatial.py:42-47).
* ``run_batch_spatial`` over four ranks on random heads at 96², B = 2,
  against the port's ``_run_batch`` by bits, and JAX's
  ``run_batch_spatial`` on ``spatial_mesh(4)``: validity, classes and mask
  bytes by bits, boxes and scores to ``test_torch_postprocess.py``'s 1e-6
  (3.0e-8: the port's decode against XLA's).
* The int8 pipeline (``quantize_int8`` on the same calibration image on
  every rank) over two space ranks against the one-process int8 pipeline:
  heads to 1e-6 of their largest value (3.1e-8, in the float 1x1 head
  convolution at stride 32 alone; every int8 convolution's output equal).
* One spatial train step at 96² (64 + 32 rows), B = 1 a data index, against
  the port's one-process step on both images and JAX's
  ``spatial_train_step`` on ``spatial_mesh(2, 2)``: logs to 2e-4 of
  themselves (7.7e-6, 7.0e-6); gradients (read from the momentum) to 5% in
  relative L2 a tensor and 4% all together, ``test_torch_parallel.py``'s
  figures for random weights (4.5% and 2.4% against one process, 1.7% and
  1.1% against JAX; one process and JAX differ by 4.3% and 2.1%);
  parameters and BatchNorm statistics to JAX's atol 2e-3
  (tests/test_spatial.py:155-156; 1.9e-3 against one process, 8.7e-4
  against JAX); the four ranks equal by bits; with ``remat`` the same step
  by bits.
"""

import datetime
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orienmask_tpu_torch.data import FastCOCOTransform, collate
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, init_random
from orienmask_tpu_torch.models.layers import ConvBNLeaky, conv2d, max_pool_3x3_s2
from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss, OrienMaskYOLOPostProcess
from orienmask_tpu_torch.optim import SGD
from orienmask_tpu_torch.parallel import spatial
from orienmask_tpu_torch.pipeline import InferencePipeline
from orienmask_tpu_torch.trainer import make_train_step

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
RANK_DEADLINE_S = 300
SLIM = (1, 1, 1, 1, 1)
NUM_CLASSES = 8
FWD_SIZES = (128, 96)
TRAIN = 96
PP_SIZE = 96
ANCHORS = [[4, 6], [8, 10], [12, 8], [10, 20], [20, 16], [18, 36], [36, 28], [48, 60], [60, 50]]
ANCHOR_MASK = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
LOSS = dict(grid_size=[[TRAIN // 32] * 2, [TRAIN // 16] * 2, [TRAIN // 8] * 2],
            image_size=[TRAIN, TRAIN], anchors=ANCHORS, anchor_mask=ANCHOR_MASK,
            num_classes=NUM_CLASSES, center_region=0.6, valid_region=0.6,
            obj_ignore_threshold=0.7, weight=[1, 1, 1, 1, 1, 20, 20], scales_weight=[1, 1, 1])
SGD_KW = dict(lr=1e-3, momentum=0.9, weight_decay=5e-4)
LR = 1e-3
BN_ROWS = (4, 8, 4, 8)
HALO_OPS = {  # name: (cin, cout, k, stride, padding, groups); "maxpool" alone
    "3x3s1": (4, 6, 3, 1, 1, 1), "3x3s2": (4, 6, 3, 2, 1, 1), "7x7s2": (3, 5, 7, 2, 3, 1),
    "1x1s2": (4, 6, 1, 2, 0, 1), "grouped": (4, 8, 3, 1, 1, 2), "maxpool": None,
}
INT8_SIZE = 128
FWD_RTOL = 1e-6


# ------------------------------------------------------------------ inputs

def _images(size, b=2, seed=3):
    return np.random.default_rng(seed).standard_normal((b, 3, size, size)).astype(np.float32)


def _bn_inputs():
    rng = np.random.default_rng(7)
    kernel = rng.standard_normal((6, 3, 1, 1)).astype(np.float32) * 0.5
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    x = rng.standard_normal((2, 3, sum(BN_ROWS), 5)).astype(np.float32) + 0.5
    cot = rng.standard_normal((2, 6, sum(BN_ROWS), 5)).astype(np.float32)
    return (kernel, scale, bias), x, cot


def _run_bn(x, cot):
    (kernel, scale, bias), _, _ = _bn_inputs()
    layer = ConvBNLeaky(3, 6, 1).train()
    with torch.no_grad():
        conv, bn = layer.conv_block
        conv.weight.copy_(torch.from_numpy(kernel))
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, torch.float32)
    out.backward(torch.from_numpy(cot))
    conv, bn = layer.conv_block
    return {"out": out.detach(), "input": xt.grad, "kernel": conv.weight.grad,
            "scale": bn.weight.grad, "bias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _halo_weights(name):
    cin, cout, k, _, _, groups = HALO_OPS[name]
    rng = np.random.default_rng(len(name))
    return torch.from_numpy(rng.standard_normal((cout, cin // groups, k, k)).astype(np.float32))


def _halo_input(d, name):
    cin = HALO_OPS[name][0] if HALO_OPS[name] else 4
    rng = np.random.default_rng(100 + d)
    return torch.from_numpy(rng.standard_normal((2, cin, 64, 12)).astype(np.float32))


def _halo_op(name, x, weight):
    if name == "maxpool":
        return max_pool_3x3_s2(x)
    _, _, _, stride, padding, groups = HALO_OPS[name]
    return conv2d(x, weight, None, stride, padding, groups)


def _run_halo(name, x, space=None):
    """Output, input gradient and weight gradient of one op on ``x`` (a row
    shard under ``space``), the cotangent the output's own rows of a fixed
    whole-image cotangent."""
    weight = None if name == "maxpool" else _halo_weights(name).requires_grad_()
    x = x.clone().requires_grad_()
    if space is None:
        out = _halo_op(name, x, weight)
    else:
        with space.active():
            out = _halo_op(name, x, weight)
    n = out.shape[2]
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (out.shape[0], out.shape[1], 2 * n if space else n, out.shape[3])).astype(np.float32))
    if space is not None:  # the shards are even here
        cot = cot[:, :, space.space_index * n:(space.space_index + 1) * n]
    out.backward(cot)
    return {"out": out.detach(), "input": x.grad,
            "weight": None if weight is None else weight.grad}


def _port_model(init):
    pm = OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM)
    pm.load_state_dict(init, strict=True)
    return pm


def _forward(pm, x, space=None):
    with torch.no_grad():
        folded = pm.fold()
        if space is None:
            return pm.apply_folded(folded, torch.from_numpy(x), torch.float32)
        return spatial.spatial_forward(pm, space, torch.float32)(folded, torch.from_numpy(x))


def _postprocess(size=PP_SIZE):
    return OrienMaskYOLOPostProcess(
        grid_size=[[size // 32] * 2, [size // 16] * 2, [size // 8] * 2], image_size=[size, size],
        anchors=ANCHORS, anchor_mask=ANCHOR_MASK, num_classes=NUM_CLASSES, conf_thresh=0.005,
        nms=dict(threshold=0.5), nms_pre=40, nms_post=12, orien_thresh=0.3, device="cpu")


def _pp_heads(b=2, size=PP_SIZE):
    rng = np.random.default_rng(5)
    out = []
    for g in (size // 32, size // 16, size // 8):
        out.append((rng.standard_normal((b, g, g, 3 * (5 + NUM_CLASSES))).astype(np.float32),
                    rng.standard_normal((b, size // 4, size // 4, 6)).astype(np.float32)))
    return out


def _transform(size):
    return FastCOCOTransform([
        dict(type="Resize", size=(size, size), interpolation="bilinear", align_corners=False),
        dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255))])


def _uint8_images(b=2, seed=8):
    return np.random.default_rng(seed).integers(0, 256, (b, 96, 120, 3), dtype=np.uint8)


def _int8_heads(init, space=None):
    pipe = InferencePipeline(_port_model(init), _transform(INT8_SIZE),
                             _postprocess(INT8_SIZE), compute_dtype="float32", device="cpu",
                             space=space)
    pipe.quantize_int8(_uint8_images(1, seed=9))
    image = _uint8_images()
    if space is not None:
        image = image[space.data_index:space.data_index + 1]
    return [tuple(t.clone() for t in pair) for pair in pipe.heads(image)]


def _samples(seed, counts, size=TRAIN):
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


TRAIN_COUNTS = (3, 4)


def _digest(*tensor_dicts):
    h = hashlib.sha256()
    for tensors in tensor_dicts:
        for t in tensors.values():
            h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _train_step(init, space=None, remat=False):
    """One step from ``init`` on the two train images (under ``space`` its
    data index's image): (state, momentum by name, digest, logs)."""
    pm = _port_model(init)
    opt = SGD(pm.parameters(), **SGD_KW)
    step = make_train_step(pm, OrienMaskYOLOMultiScaleLoss(device="cpu", **LOSS), opt,
                           device="cpu", remat=remat, space=space)
    samples = _samples(0, TRAIN_COUNTS)
    if space is not None:
        samples = samples[space.data_index:space.data_index + 1]
    logs = step(collate(samples, max_instances=8, pack_masks=True), LR)
    names = [n for n, _ in pm.named_parameters()]
    state = {k: t.clone() for k, t in pm.state_dict().items()}
    momentum = {n: b.clone() for n, b in zip(names, opt.buffers)}
    return {"state": state, "momentum": momentum, "digest": _digest(state, momentum),
            "logs": {k: float(v) for k, v in logs.items()}}


# ------------------------------------------------------------- the ranks

def rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    grid = spatial.spatial_groups(2, 2)
    line = spatial.spatial_groups(4)
    init = torch.load(workdir / "init.pt")
    out = {"grid": (grid.data_index, grid.space_index), "line": line.space_index}

    _, x, cot = _bn_inputs()
    r0 = sum(BN_ROWS[:rank])
    rows = slice(r0, r0 + BN_ROWS[rank])
    out["bn"] = _run_bn(np.ascontiguousarray(x[:, :, rows]), np.ascontiguousarray(cot[:, :, rows]))

    out["halo"] = {name: _run_halo(name, grid.shard(_halo_input(grid.data_index, name)), grid)
                   for name in HALO_OPS}
    pm = _port_model(init).eval()
    out["forward"] = {size: _forward(pm, _images(size)[grid.data_index:grid.data_index + 1], grid)
                      for size in FWD_SIZES}
    heads = [tuple(torch.from_numpy(h) for h in pair) for pair in _pp_heads()]
    with torch.no_grad():
        out["run_batch"] = spatial.run_batch_spatial(_postprocess(), line, heads)
    out["int8"] = _int8_heads(init, grid)
    out["train"] = _train_step(init, grid)
    out["train_remat"] = _train_step(init, grid, remat=True)
    dist.destroy_process_group()
    if rank:  # the others' digests are what the tests compare
        for case in ("train", "train_remat"):
            out[case].pop("state")
            out[case].pop("momentum")
    torch.save(out, workdir / f"rank{rank}.pt")


# ------------------------------------------------------------ the fixture

def _jax_runs(jm, variables):
    """JAX's counterparts: ``spatial_forward`` on ``spatial_mesh(2, 2)``,
    ``run_batch_spatial`` on ``spatial_mesh(4)``, ``spatial_train_step``
    on ``spatial_mesh(2, 2)``."""
    import jax
    import jax.numpy as jnp

    from orienmask_tpu.data.collate import collate as jax_collate
    from orienmask_tpu.ops.loss import OrienMaskYOLOMultiScaleLoss as JaxLoss
    from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
    from orienmask_tpu.optim import SGD as JaxSGD
    from orienmask_tpu.parallel.spatial import (
        run_batch_spatial,
        shard_spatial_batch,
        spatial_forward,
        spatial_mesh,
        spatial_train_step,
    )

    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    mesh22 = spatial_mesh(n_space=2, n_data=2)
    fwd = spatial_forward(jm, mesh22)
    out = {"forward": {size: host(fwd(variables, jnp.asarray(_images(size).transpose(0, 2, 3, 1))))
                       for size in FWD_SIZES}}
    pp = JaxPostProcess(
        grid_size=[[PP_SIZE // 32] * 2, [PP_SIZE // 16] * 2, [PP_SIZE // 8] * 2],
        image_size=[PP_SIZE, PP_SIZE], anchors=ANCHORS, anchor_mask=ANCHOR_MASK,
        num_classes=NUM_CLASSES, conf_thresh=0.005, nms=dict(threshold=0.5), nms_pre=40,
        nms_post=12, orien_thresh=0.3, pack_masks=True, use_pallas_masks=False)
    mesh4 = spatial_mesh(n_space=4, n_data=1)
    heads = [tuple(jnp.asarray(h) for h in pair) for pair in _pp_heads()]
    out["run_batch"] = host(jax.jit(lambda p: run_batch_spatial(pp, mesh4, p))(heads))
    step, init = spatial_train_step(jm, JaxLoss(**LOSS), JaxSGD(**SGD_KW), mesh22)
    batch = jax_collate(_samples(0, TRAIN_COUNTS), max_instances=8, pack_masks=True)
    state, logs = step(init(variables), shard_spatial_batch(batch, mesh22), LR, True)
    out["train"] = (host(state), host(logs))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, one process's, JAX's, the init)."""
    import jax

    from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
    from orienmask_tpu_torch.models import variables_to_jax

    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("space_ranks")
    pm = init_random(OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM), seed=0)
    init = {k: t.clone() for k, t in pm.state_dict().items()}
    torch.save(init, workdir / "init.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(workdir)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        pm.eval()
        heads = [tuple(torch.from_numpy(h) for h in pair) for pair in _pp_heads()]
        with torch.no_grad():
            run_batch = _postprocess()._run_batch(heads)
        one = {"bn_x": _bn_inputs()[1],
               "halo": {name: [_run_halo(name, _halo_input(d, name)) for d in (0, 1)]
                        for name in HALO_OPS},
               "forward": {size: _forward(pm, _images(size)) for size in FWD_SIZES},
               "run_batch": run_batch, "int8": _int8_heads(init),
               "train": _train_step(init)}
        jm = JaxModel(num_anchors=3, num_classes=NUM_CLASSES, backbone_stage_blocks=SLIM)
        jm.backbone.s2d_stem = False
        variables = jax.tree_util.tree_map(np.asarray, variables_to_jax(pm))
        want = _jax_runs(jm, variables)
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
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


@pytest.mark.parametrize("h,n_space,want", [
    (544, 2, [288, 256]), (96, 2, [64, 32]), (128, 4, [32, 32, 32, 32]),
    (736, 4, [192, 192, 192, 160]), (32, 1, [32]),
])
def test_row_split_aligns_shards_to_the_coarsest_stride(h, n_space, want):
    assert spatial.row_split(h, n_space) == want


@pytest.mark.parametrize("h,n_space,message", [
    (100, 2, "not a multiple of 32"), (64, 3, "fewer than n_space=3"),
])
def test_row_split_refuses_what_cannot_align(h, n_space, message):
    with pytest.raises(ValueError, match=message):
        spatial.row_split(h, n_space)


def test_spatial_groups_refuse_a_world_of_another_size():
    with pytest.raises(ValueError, match="need n_data \\* n_space = 1 \\* 2 ranks"):
        spatial.spatial_groups(2, 1)
    one = spatial.spatial_groups(1)
    assert (one.n_space, one.n_data, one.space_index) == (1, 1, 0)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_gemm_route_pads_columns_alone_for_a_shard(stride):
    """The card's int8 route (im2col + ``torch._int_mm``, which runs on the
    CPU too) with ``padding=(0, 1)``, as a shard with its halo rows calls
    it, equals the plain version by bits."""
    from orienmask_tpu_torch.ops.int8_conv import conv2d_int8_gemm, conv2d_int8_plain

    rng = np.random.default_rng(stride)
    q = torch.from_numpy(rng.integers(-127, 128, (1, 16, 10, 12), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (8, 16, 3, 3), dtype=np.int8))
    q = q.contiguous(memory_format=torch.channels_last)
    got = conv2d_int8_gemm(q, w, stride, (0, 1))
    want = conv2d_int8_plain(q, w, stride, (0, 1))
    assert got.shape == want.shape == (1, 8, (10 - 3) // stride + 1, 12 // stride)
    assert torch.equal(got, want)


def test_spatial_pipeline_options_are_checked_and_export_refuses_it(tmp_path):
    """``spatial_masks=True`` needs the network height to divide by
    ``n_space``; ``"auto"`` falls back to the replicated tail where it does
    not (JAX ``pipeline.py:119-129``); a spatial pipeline is not exported
    (JAX ``serving.py:71-73``)."""
    from orienmask_tpu_torch.serving import export_pipeline

    init = init_random(OrienMaskYOLOFPNPlus(3, NUM_CLASSES, backbone_stage_blocks=SLIM))
    three = spatial.SpaceGroup(3, 1, 0, None, None)  # a grid's place; no collective runs
    with pytest.raises(ValueError, match="network height 128 not divisible by n_space=3"):
        InferencePipeline(init, _transform(128), _postprocess(128), "float32", device="cpu",
                          space=three, spatial_masks=True)
    for size, want in ((96, True), (128, False)):
        pipe = InferencePipeline(init, _transform(size), _postprocess(size), "float32",
                                 device="cpu", space=three)
        assert pipe.spatial_masks is want
    with pytest.raises(ValueError, match="a spatial pipeline"):
        export_pipeline(pipe, [(1, 96, 120, 3)], tmp_path)


def test_ranks_take_their_places_in_both_grids(runs):
    ranks = runs[0]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["line"] for r in ranks] == [0, 1, 2, 3]


def test_synced_batchnorm_counts_uneven_shards_once(runs):
    """Four ranks of 4, 8, 4 and 8 rows of the same two images against JAX's
    ConvBNLeaky on all 24 rows: the count of each rank goes into the
    global one (the old count, the rank's own shape times the world, would
    have been 8, 16, 8, 16 rows a rank)."""
    import jax
    import jax.numpy as jnp

    from orienmask_tpu.models.layers import ConvBNLeaky as JaxConvBNLeaky
    from orienmask_tpu.models.layers import default_ctx

    ranks = runs[0]
    (kernel, scale, bias), x, cot = _bn_inputs()
    params = {"kernel": kernel.transpose(2, 3, 1, 0), "scale": scale, "bias": bias}
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}
    jl = JaxConvBNLeaky(3, 6, 1)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    out, new_stats = jl.apply(params, stats, xj, default_ctx(train=True))
    _, vjp = jax.vjp(lambda p, x: jl.apply(p, stats, x, default_ctx(train=True))[0], params, xj)
    want_p, want_x = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    got = {k: torch.cat([r["bn"][k] for r in ranks], 2) for k in ("out", "input")}
    assert _rel_max(got["out"].permute(0, 2, 3, 1), out) < 1e-5
    assert _rel_max(got["input"].permute(0, 2, 3, 1), want_x) < 1e-5
    for key, want in (("kernel", np.asarray(want_p["kernel"]).transpose(3, 2, 0, 1)),
                      ("scale", want_p["scale"]), ("bias", want_p["bias"])):
        assert _rel_max(sum(r["bn"][key] for r in ranks), want) < 1e-5, key
    for r in ranks:
        assert _rel_max(r["bn"]["running_mean"], new_stats["mean"]) < 2e-6
        assert _rel_max(r["bn"]["running_var"], new_stats["var"]) < 2e-6


@pytest.mark.parametrize("name", list(HALO_OPS))
def test_halo_op_is_the_whole_images_op(runs, name):
    """Forward and backward of a convolution or the max pool on two row
    shards with their halos against the whole image's, for both data
    indices."""
    ranks, one = runs[0], runs[1]
    for d in (0, 1):
        shards = [ranks[2 * d + s]["halo"][name] for s in (0, 1)]
        whole = one["halo"][name][d]
        assert torch.equal(torch.cat([s["out"] for s in shards], 2), whole["out"]), d
        assert _rel_max(torch.cat([s["input"] for s in shards], 2), whole["input"]) < 1e-6, d
        if whole["weight"] is not None:
            summed = shards[0]["weight"] + shards[1]["weight"]
            assert _rel_max(summed, whole["weight"]) < 1e-5, d


@pytest.mark.parametrize("size", FWD_SIZES)
def test_spatial_forward_matches_one_process_and_jax(runs, size):
    ranks, one, want = runs[0], runs[1], runs[2]
    for r, rank in enumerate(ranks):
        d = r // 2
        for s, (got_pair, one_pair, jax_pair) in enumerate(zip(
                rank["forward"][size], one["forward"][size], want["forward"][size])):
            for got, whole, ref in zip(got_pair, one_pair, jax_pair):
                assert got.shape == whole[d:d + 1].shape
                assert _rel_max(got, whole[d:d + 1]) < FWD_RTOL, (size, r, s)
                ref = np.asarray(ref)[d:d + 1].transpose(0, 3, 1, 2)
                assert _rel_max(got, ref) < FWD_RTOL, (size, r, s)
                assert _rel_max(got, ref) < 2e-5, (size, r, s, _rel_max(got, ref))


def test_run_batch_spatial_is_run_batch_and_jaxs_by_bits(runs):
    ranks, one, want = runs[0], runs[1], runs[2]
    assert one["run_batch"]["valid"].any()
    for rank in ranks:
        for key in ("bbox", "cls", "mask", "valid"):
            got = rank["run_batch"][key]
            assert got.dtype == one["run_batch"][key].dtype, key
            assert torch.equal(got, one["run_batch"][key]), key
            if key == "bbox":  # the postprocess test's figure for the port's decode
                np.testing.assert_allclose(got.numpy(), want["run_batch"][key], rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got.numpy(), want["run_batch"][key], err_msg=key)


def test_int8_spatial_heads_are_one_processs(runs):
    ranks, one = runs[0], runs[1]
    for r, rank in enumerate(ranks):
        d = r // 2
        for got_pair, want_pair in zip(rank["int8"], one["int8"]):
            for got, want in zip(got_pair, want_pair):
                assert _rel_max(got, want[d:d + 1]) < FWD_RTOL, r


def _momentum_l2(got, want, before, wd=SGD_KW["weight_decay"]):
    """The gradients' difference (read from the momentum after one step
    from zero momentum: buf = grad + wd * param) in relative L2: the worst
    tensor's and all together."""
    worst, diffs, grads = 0.0, [], []
    for n, w in want.items():
        grad = (w.double() - wd * before[n].double()).reshape(-1)
        diff = (got[n].double() - w.double()).reshape(-1)
        worst = max(worst, float(diff.norm() / grad.norm()))
        diffs.append(diff)
        grads.append(grad)
    return worst, float(torch.cat(diffs).norm() / torch.cat(grads).norm())


def _jax_momentum(pm, state):
    from orienmask_tpu_torch.models import variables_from_jax

    momentum = variables_from_jax(pm, {"params": state["opt_state"]["momentum"],
                                       "batch_stats": None})
    return {n: momentum[n] for n, _ in pm.named_parameters()}


def test_spatial_train_step_matches_one_process_and_jax(runs):
    import jax

    from orienmask_tpu_torch.models import variables_to_jax

    ranks, one, want, (pm, _, init) = runs
    got = ranks[0]["train"]
    assert all(r["train"]["digest"] == got["digest"] for r in ranks)
    jax_state, jax_logs = want["train"]
    for key, value in one["train"]["logs"].items():
        assert abs(got["logs"][key] - value) <= 2e-4 * abs(value) + 1e-6, key
        if key in jax_logs:
            assert abs(got["logs"][key] - float(jax_logs[key])) <= 2e-4 * abs(value) + 1e-6, key
    assert got["logs"]["skipped"] == 0.0
    before = {n: init[n] for n, _ in pm.named_parameters()}
    for ref in (one["train"]["momentum"], _jax_momentum(pm, jax_state)):
        worst, together = _momentum_l2(got["momentum"], ref, before)
        assert worst < 0.05 and together < 0.04, (worst, together)
    mine = variables_to_jax(pm, got["state"])
    for key in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, mine[key]))
        b = jax.tree_util.tree_leaves(jax_state[key])
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            np.testing.assert_allclose(la, lb, rtol=0, atol=2e-3)
    for k, t in got["state"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), one["train"]["state"][k].numpy(), rtol=0,
                                       atol=2e-3, err_msg=k)


def test_spatial_train_step_with_remat_is_the_same_step(runs):
    ranks = runs[0]
    for r in ranks:
        assert r["train_remat"]["digest"] == r["train"]["digest"]
        assert r["train_remat"]["logs"] == r["train"]["logs"]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
