"""The slice as a whole: a uint8 image through orienmask_tpu's
InferencePipeline (f32, master stem) and through the port's pipeline on the
CPU in f32, from the same numpy weights.

Random init leaves the slim model's head logits near 1e-5, so every score
collapses onto the head bias and the detection order becomes noise.  The
objectness and class channels of the bbox heads' last Conv are scaled by
1e4 in the shared weights: logits then spread with std 0.1-0.6, the kept
scores sit at least 1.5e-6 apart, and the two frameworks' scores differ by
at most 3.9e-7 (measured on these inputs).  Both must then keep the same
detections.  The JAX side assembles masks with its XLA formulation
(``arange / W`` coordinates), the port with the kernel's ``x * (1/W)``;
at W = 128 the two coincide, and the mask pixel agreement measured here is
100% (the assert holds it to >= 99.99%)."""

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.data.transform import FastCOCOTransform as JaxTransform
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu.pipeline import InferencePipeline as JaxPipeline
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, variables_from_jax
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.pipeline import InferencePipeline

SIZE = 128
SLIM = (1, 1, 1, 1, 1)
TRANSFORM = [
    dict(type="Resize", size=(SIZE, SIZE), interpolation="bilinear", align_corners=False),
    dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255)),
]


def _postprocess_kwargs():
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    kw.update(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
              image_size=[SIZE, SIZE], pack_masks=True)
    return kw


def _variables(jm):
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(0)))
    for name in ("bbox_head8", "bbox_head16", "bbox_head32"):
        k = v["params"][name][1]["kernel"].copy()
        k = k.reshape(k.shape[:3] + (3, 85))
        k[..., 4:] *= np.float32(1e4)  # objectness and class logits
        v["params"][name][1]["kernel"] = k.reshape(k.shape[:3] + (255,))
    return v


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = _variables(jm)
    image = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)

    jpipe = JaxPipeline(jm, variables, JaxTransform(TRANSFORM),
                        JaxPostProcess(**_postprocess_kwargs()), compute_dtype="float32")
    want = jax.tree_util.tree_map(np.asarray, jpipe.run_device(image))

    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    pipe = InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")
    got = {k: v.numpy() for k, v in pipe.run_device(image).items()}
    return pipe, image, want, got


def test_pipeline_keeps_the_same_detections_as_jax(runs):
    _, _, want, got = runs
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > 0
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-5, atol=2e-6)


def test_pipeline_mask_pixel_agreement_with_jax(runs):
    _, _, want, got = runs
    valid = got["valid"][..., None, None]
    a = np.unpackbits(want["mask"], axis=-1).astype(bool) & valid
    b = np.unpackbits(got["mask"], axis=-1).astype(bool) & valid
    agreement = (a == b).mean()
    assert agreement >= 0.9999, agreement
    assert b.any()


def test_pipeline_call_returns_host_lists(runs):
    pipe, image, _, got = runs
    results, pad_info = pipe(image)
    assert pad_info == (0, 0, 0, 0, SIZE, SIZE)
    assert len(results) == 2
    for b, r in enumerate(results):
        n = int(got["valid"][b].sum())
        np.testing.assert_array_equal(r["bbox"], got["bbox"][b, :n])
        assert r["mask"].shape == (n, SIZE, SIZE) and r["cls"].dtype == np.int32


def test_pipeline_precasts_folded_weights_once():
    """In bf16 every conv weight and ConvBNLeaky bias is cast once when the
    pipeline is built; the four prediction heads keep their biases in f32.
    A pre-cast bias gives the same bits as the cast per call."""
    torch.set_num_threads(1)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pipe = InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="bfloat16", device="cpu")

    def leaves(tree):
        if isinstance(tree, list):
            return [x for t in tree for x in leaves(t)]
        if "weight" in tree:
            return [tree]
        return [x for t in tree.values() for x in leaves(t)]

    folded = leaves(pipe.folded)
    heads = [f for f in folded if "bias_f32" in f]
    assert len(heads) == 4 and all(f["bias_f32"].dtype == torch.float32 for f in heads)
    convs = [f for f in folded if "bias" in f]
    assert len(convs) + len(heads) == len(folded)
    for f in folded:
        assert f["weight"].dtype == torch.bfloat16
        assert f["weight"].is_contiguous(memory_format=torch.channels_last)
    assert all(f["bias"].dtype == torch.bfloat16 for f in convs)

    layer = pm.backbone.conv1
    f32 = layer.fold()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 16, 16))
                         .astype(np.float32))
    per_call = layer.apply_folded({"weight": folded[0]["weight"], "bias": f32["bias"]},
                                  x, torch.bfloat16)
    once = layer.apply_folded(folded[0], x, torch.bfloat16)
    assert torch.equal(per_call.view(torch.int16), once.view(torch.int16))
