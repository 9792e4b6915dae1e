"""The port's model, weight bridge, resize and config against orienmask_tpu.

Slim depth (stage blocks (1, 1, 1, 1, 1)) at the published widths, 64²
inputs, f32 on the CPU.  JAX and the port get the same numpy weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.config import orienmask_yolo_coco_544_anchor4_fpn_plus as jax_train_cfg
from orienmask_tpu.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as jax_cfg
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.convert import variables_to_torch
from orienmask_tpu.models.layers import bilinear_resize as jax_bilinear_resize
from orienmask_tpu.models.layers import ConvBNLeaky as JaxConvBNLeaky
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as train_cfg
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, load_reference_state_dict, variables_from_jax
from orienmask_tpu_torch.models.layers import ConvBNLeaky, bilinear_resize

SLIM = (1, 1, 1, 1, 1)


def _jax_variables(jm, seed):
    """Seeded JAX init with BN statistics and affines drawn at random, so the
    fold is exercised; numpy leaves."""
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def randomize(params, stats):
        if isinstance(params, dict) and "scale" in params:
            n = params["scale"].shape[0]
            params["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params["bias"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif isinstance(params, dict):
            for key in params:
                randomize(params[key], stats.get(key, {}) if isinstance(stats, dict) else {})
        elif isinstance(params, list):
            for p, s in zip(params, stats):
                randomize(p, s)

    randomize(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    variables = _jax_variables(jm, 0)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    return jm, variables, pm


def test_weight_bridge_matches_reference_state_dict(models):
    """variables_from_jax and the reference-layout state dict of
    orienmask_tpu's variables_to_torch load (strict) into identical weights."""
    jm, variables, pm = models
    other = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    load_reference_state_dict(other, {"state_dict": variables_to_torch(jm, variables)})
    a, b = pm.state_dict(), other.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _forward_pair(models, s2d_stem, monkeypatch):
    jm, variables, pm = models
    monkeypatch.setattr(jm.backbone, "s2d_stem", s2d_stem)  # the fixture is shared
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    folded = jm.fold(variables)
    want = jax.jit(lambda f, x: jm.apply_folded(f, x, default_ctx(dtype=jnp.float32)))(
        folded, jnp.asarray(x))
    with torch.no_grad():
        got = pm.apply_folded(pm.fold(), torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.float32)
    return want, got


@pytest.mark.parametrize("s2d_stem", [False, True], ids=["master_stem", "phase_stem"])
def test_folded_forward_matches_jax(models, s2d_stem, monkeypatch):
    """f32 folded forward vs JAX apply_folded, rtol = atol = 1e-4.  With the
    master stem both run the same convolutions.  JAX's default space-to-depth
    phase stem reassociates the stem convolutions; on these inputs it agrees
    as closely: the largest difference from the port is 3.0e-7 with either
    stem (head outputs up to 0.32)."""
    want, got = _forward_pair(models, s2d_stem, monkeypatch)
    for (wb, wo), (gb, go) in zip(want, got):
        np.testing.assert_allclose(gb.permute(0, 2, 3, 1).numpy(), np.asarray(wb),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go.permute(0, 2, 3, 1).numpy(), np.asarray(wo),
                                   rtol=1e-4, atol=1e-4)


def test_bilinear_resize_matches_jax():
    torch.set_num_threads(1)
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    want = np.asarray(jax_bilinear_resize(jnp.asarray(x), 64, 80))
    got = bilinear_resize(torch.from_numpy(x), 64, 80).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_config_copy_matches_jax_config():
    for key in ("compute_dtype", "model", "transform", "postprocess"):
        assert cfg[key] == jax_cfg[key], key


def test_train_config_copy_matches_jax_config():
    assert train_cfg == jax_train_cfg


@pytest.mark.parametrize("name", [
    "orienmask_yolo_coco_544_anchor4_fpn_plus_test", "orienmask_yolo_coco_544_anchor4_test",
    "orienmask_yolo_coco_544_test", "orienmask_yolo_coco_544_anchor4", "orienmask_yolo_coco_544",
    "orienmask_yolo_coco_544_anchor4_fpn_plus_infer", "orienmask_yolo_coco_544_anchor4_infer",
    "orienmask_yolo_coco_544_infer", "orienmask_yolo_coco_736_anchor4_fpn_plus_infer",
])
def test_test_config_copies_match_jax_configs(name):
    import orienmask_tpu.config as jax_config
    import orienmask_tpu_torch.config as config

    assert getattr(config, name) == getattr(jax_config, name)


@pytest.mark.parametrize("name", [
    "transform_infer_736", "orienmask_yolo_coco_736_anchor4_postprocess", "coco_visualizer",
    "MEAN", "STD", "ANCHORS_MASK", "ANCHORS_YOLOV3", "ANCHORS_YOLOV4", "coco_train_dataset",
    "coco_val_dataset", "transform_train_544", "transform_val_544", "coco_544_train_loader",
    "coco_544_val_loader", "coco_train2017_gt_file", "coco_val2017_gt_file", "base_sgd",
    "step_lr_warmup_coco_e100", "orienmask_yolo_coco_544_anchor4_loss",
])
def test_infer_blocks_match_jax_base(name):
    import orienmask_tpu.config.base as jax_base
    import orienmask_tpu_torch.config as config

    assert getattr(config, name) == getattr(jax_base, name)


def test_construct_config_matches_jax():
    from orienmask_tpu.config.base import construct_config as jax_construct_config
    from orienmask_tpu_torch.config import construct_config

    base = {"a": {"b": 1, "c": [1, 2]}, "d": 3, "e": {"f": {"g": 4}}}
    update = {"a": {"b": 5}, "e": {"f": {"h": 6}}, "i": 7}
    pop = ["e.f.g", "d"]
    assert construct_config(base, update, pop) == jax_construct_config(base, update, pop)
    assert base == {"a": {"b": 1, "c": [1, 2]}, "d": 3, "e": {"f": {"g": 4}}}


@pytest.mark.parametrize("train", [True, False], ids=["batch_stats", "running_stats"])
def test_conv_bn_leaky_forward_matches_jax(train):
    """One ConvBNLeaky, unfolded (JAX ``apply``), f32: the output and the
    updated running statistics at rtol = atol = 1e-5.  JAX's E[y²] - E[y]²
    variance and BatchNorm2d's agree to f32 reduction order here."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    jl = JaxConvBNLeaky(8, 16, 3, stride=2, padding=1)
    params, stats = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(3)))
    params = dict(params, scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                  bias=rng.uniform(-0.2, 0.2, 16).astype(np.float32))
    stats = {"mean": rng.uniform(-0.2, 0.2, 16).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    want, want_stats = jl.apply(params, stats, jnp.asarray(x), default_ctx(train=train))
    layer = ConvBNLeaky(8, 16, 3, stride=2, padding=1)
    layer.load_state_dict({
        "conv_block.0.weight": torch.tensor(params["kernel"].transpose(3, 2, 0, 1)),
        "conv_block.1.weight": torch.tensor(params["scale"]),
        "conv_block.1.bias": torch.tensor(params["bias"]),
        "conv_block.1.running_mean": torch.tensor(stats["mean"]),
        "conv_block.1.running_var": torch.tensor(stats["var"]),
        "conv_block.1.num_batches_tracked": torch.tensor(0)})
    layer.train(train)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    bn = layer.conv_block[1]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_stats["var"]),
                               rtol=1e-5, atol=1e-6)


def test_conv_bn_leaky_backward_matches_jax():
    """One ConvBNLeaky in train mode, f32: the gradients of <out, cot> with
    respect to the input, the kernel and the BatchNorm affine against
    ``jax.vjp`` of JAX ``apply``, to 1e-5 of each tensor's largest value
    (measured worst 4.8e-7).  This holds the batch-statistics backward
    that the whole-model train-step test can only hold to a few percent."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(5)
    jl = JaxConvBNLeaky(8, 16, 3, stride=2, padding=1)
    params, stats = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(5)))
    params = dict(params, scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                  bias=rng.uniform(-0.2, 0.2, 16).astype(np.float32))
    x = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
    cot = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jl.apply(p, stats, x, default_ctx(train=True))[0],
                     params, jnp.asarray(x))
    want_p, want_x = jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(cot)))
    layer = ConvBNLeaky(8, 16, 3, stride=2, padding=1).train()
    with torch.no_grad():
        layer.conv_block[0].weight.copy_(torch.tensor(params["kernel"].transpose(3, 2, 0, 1)))
        layer.conv_block[1].weight.copy_(torch.tensor(params["scale"]))
        layer.conv_block[1].bias.copy_(torch.tensor(params["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = layer(xt, torch.float32)
    out.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
    conv, bn = layer.conv_block
    for name, got, want in (
            ("input", xt.grad.permute(0, 2, 3, 1), want_x),
            ("kernel", conv.weight.grad.permute(2, 3, 1, 0), want_p["kernel"]),
            ("scale", bn.weight.grad, want_p["scale"]), ("bias", bn.bias.grad, want_p["bias"])):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, f"{name}: {err:.2e} of the largest gradient"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unfolded_forward_matches_jax(models, train, monkeypatch):
    """The whole slim model's ``forward`` against JAX ``apply`` (master
    stem), f32, heads in the JAX layout.  Eval mode holds to 1e-4 like the
    folded forward.  Train mode normalises by batch statistics: at 64² the
    stride-32 BatchNorms see 8 values a channel and amplify rounding.  The
    heads (range up to 2.2) then sit up to 4.2e-4 (port) and 2.4e-4 (JAX)
    from an f64 evaluation of the port, and 4.1e-4 from each other;
    atol = 2e-3."""
    jm, variables, _ = models
    monkeypatch.setattr(jm.backbone, "s2d_stem", False)  # the fixture is shared
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    pm.train(train)
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want, _ = jax.jit(lambda x: jm.apply(variables["params"], variables["batch_stats"], x,
                                         default_ctx(train=train)))(jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    tol = 2e-3 if train else 1e-4
    for (wb, wo), (gb, go) in zip(want, got):
        assert gb.shape == wb.shape and go.shape == wo.shape
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=tol, atol=tol)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=tol, atol=tol)


@pytest.mark.parametrize("key,value", [("freeze_backbone", 2), ("backbone_batchnorm_eval", True)])
def test_build_model_takes_trainer_keys(models, key, value):
    """``build_model`` passes both keys to the backbone, as the JAX package
    does: ``freeze_backbone: 2`` freezes stages conv1 and conv2 (JAX's
    ``frozen_stages``) and keeps their BatchNorms in eval mode through
    ``train()``; ``backbone_batchnorm_eval`` keeps every backbone BatchNorm
    in eval mode.  The train-mode forward then matches JAX's, whose frozen
    and ``batchnorm_eval`` stages run on their running statistics, at
    ``test_unfolded_forward_matches_jax``'s train rtol and an atol of 5e-3
    (measured 2.6e-3 at worst, on one of 3,072 orientation outputs with
    ``backbone_batchnorm_eval``: the heads' train-mode BatchNorms at 64²
    amplify the eval-mode backbone's rounding); the frozen stages' buffers
    do not move."""
    from orienmask_tpu_torch.models import build_model

    _, variables, _ = models
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM, **{key: value})
    jm.backbone.s2d_stem = False
    pm = build_model(dict(train_cfg["model"], **{key: value}), backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    assert pm.backbone.frozen_stages() == jm.backbone.frozen_stages()
    eval_stages = pm.backbone.stage_names if key == "backbone_batchnorm_eval" else \
        ["conv1", "conv2"]
    pm.eval()
    pm.train()
    for name, m in pm.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            stage = name.split(".")[1] if name.startswith("backbone.") else None
            assert m.training is (stage not in eval_stages), name
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want, _ = jax.jit(lambda x: jm.apply(variables["params"], variables["batch_stats"], x,
                                             default_ctx(train=True)))(jnp.asarray(x))
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    for (wb, wo), (gb, go) in zip(want, got):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=2e-3, atol=5e-3)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=2e-3, atol=5e-3)
    for k, t in pm.state_dict().items():
        if k.startswith("backbone.") and k.split(".")[1] in eval_stages:
            assert torch.equal(t, before[k]), k
    assert isinstance(build_model(dict(train_cfg["model"], **{key: False}),
                                  backbone_stage_blocks=SLIM), OrienMaskYOLOFPNPlus)
