"""The port's model, weight bridge, resize and config against orienmask_tpu.

Slim depth (stage blocks (1, 1, 1, 1, 1)) at the published widths, 64²
inputs, f32 on the CPU.  JAX and the port get the same numpy weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as jax_cfg
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.convert import variables_to_torch
from orienmask_tpu.models.layers import bilinear_resize as jax_bilinear_resize
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, load_reference_state_dict, variables_from_jax
from orienmask_tpu_torch.models.layers import bilinear_resize

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


def _forward_pair(models, s2d_stem):
    jm, variables, pm = models
    jm.backbone.s2d_stem = s2d_stem
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
def test_folded_forward_matches_jax(models, s2d_stem):
    """f32 folded forward vs JAX apply_folded, rtol = atol = 1e-4.  With the
    master stem both run the same convolutions.  JAX's default space-to-depth
    phase stem reassociates the stem convolutions; on these inputs it agrees
    as closely: the largest difference from the port is 3.0e-7 with either
    stem (head outputs up to 0.32)."""
    want, got = _forward_pair(models, s2d_stem)
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
