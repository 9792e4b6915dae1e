"""The port's base model, ``OrienMaskYOLO``, against orienmask_tpu's: the
weight bridge, the folded and unfolded forwards at 128², and the inference
pipeline on the base model.

Slim depth (stage blocks (1, 1, 1, 1, 1)) at the published widths, f32 on
the CPU.  JAX and the port get the same numpy weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.data.transform import FastCOCOTransform as JaxTransform
from orienmask_tpu.models import OrienMaskYOLO as JaxModel
from orienmask_tpu.models.convert import variables_to_torch
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu.pipeline import InferencePipeline as JaxPipeline
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import (
    OrienMaskYOLO,
    build_model,
    load_reference_state_dict,
    variables_from_jax,
)
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.pipeline import InferencePipeline
from test_torch_models import _jax_variables
from test_torch_pipeline import TRANSFORM, _postprocess_kwargs

SLIM = (1, 1, 1, 1, 1)
SIZE = 128


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = _jax_variables(jm, 0)
    pm = OrienMaskYOLO(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    return jm, variables, pm


def test_build_model_builds_the_base_model():
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_infer as cfg

    model = build_model(cfg["model"], backbone_stage_blocks=SLIM)
    assert type(model) is OrienMaskYOLO
    assert model.module_names()[1:] == tuple(JaxModel(3, 80)._head_names())


def test_reference_state_dict_loads_strict(models):
    """The reference-layout state dict that orienmask_tpu's
    ``variables_to_torch`` writes for the base model loads with
    ``strict=True`` into the same weights as ``variables_from_jax``."""
    jm, variables, pm = models
    other = OrienMaskYOLO(3, 80, backbone_stage_blocks=SLIM)
    load_reference_state_dict(other, {"state_dict": variables_to_torch(jm, variables)})
    a, b = pm.state_dict(), other.state_dict()
    assert a.keys() == b.keys()
    assert any(k.startswith("route8.0.conv_block") for k in a)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _image():
    return np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)


def test_folded_forward_matches_jax(models):
    """f32 folded forward against JAX ``apply_folded`` (master stem),
    rtol = atol = 1e-4 as for FPNPlus (``test_torch_models.py``); the largest
    difference measured here is 3.3e-7 (head outputs up to 0.29)."""
    jm, variables, pm = models
    x = _image()
    want = jax.jit(lambda f, x: jm.apply_folded(f, x, default_ctx(dtype=jnp.float32)))(
        jm.fold(variables), jnp.asarray(x))
    with torch.no_grad():
        got = pm.apply_folded(pm.fold(), torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.float32)
    for (wb, wo), (gb, go) in zip(want, got):
        assert go.shape[1] == 6
        np.testing.assert_allclose(gb.permute(0, 2, 3, 1).numpy(), np.asarray(wb),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go.permute(0, 2, 3, 1).numpy(), np.asarray(wo),
                                   rtol=1e-4, atol=1e-4)


def test_unfolded_forward_matches_jax(models):
    """Eval-mode ``forward`` against JAX ``apply`` (running statistics),
    heads in the JAX layout, rtol = atol = 1e-4 (largest difference measured
    2.8e-7)."""
    jm, variables, pm = models
    pm.eval()
    x = _image()
    want, _ = jax.jit(lambda x: jm.apply(variables["params"], variables["batch_stats"], x,
                                         default_ctx(train=False)))(jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    for (wb, wo), (gb, go) in zip(want, got):
        assert gb.shape == wb.shape and go.shape == wo.shape
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-4, atol=1e-4)


def _spread_variables(jm):
    """JAX's seeded init with the bbox heads' objectness and class kernels
    scaled by 1e4, as ``test_torch_pipeline.py`` spreads the logits."""
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(0)))
    for name in ("bbox_head8", "bbox_head16", "bbox_head32"):
        k = v["params"][name][1]["kernel"].copy()
        k = k.reshape(k.shape[:3] + (3, 85))
        k[..., 4:] *= np.float32(1e4)
        v["params"][name][1]["kernel"] = k.reshape(k.shape[:3] + (255,))
    return v


@pytest.fixture(scope="module")
def pipeline_runs():
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = _spread_variables(jm)
    image = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    jpipe = JaxPipeline(jm, variables, JaxTransform(TRANSFORM),
                        JaxPostProcess(**_postprocess_kwargs()), compute_dtype="float32")
    want = jax.tree_util.tree_map(np.asarray, jpipe.run_device(image))
    pm = OrienMaskYOLO(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    pipe = InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")
    got = {k: v.numpy() for k, v in pipe.run_device(image).items()}
    return want, got


def test_base_model_pipeline_keeps_the_same_detections_as_jax(pipeline_runs):
    """Same detections (validity and classes exact, boxes to 1e-5) and mask
    pixel agreement >= 99.99% (measured 100% at W = 128, where the JAX
    ``arange / W`` and the port's ``x * (1/W)`` coordinates coincide)."""
    want, got = pipeline_runs
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-5, atol=2e-6)
    valid = got["valid"][..., None, None]
    a = np.unpackbits(want["mask"], axis=-1).astype(bool) & valid
    b = np.unpackbits(got["mask"], axis=-1).astype(bool) & valid
    assert (a == b).mean() >= 0.9999
    assert b.any()
