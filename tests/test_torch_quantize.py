"""int8 post-training quantization in the port (``models/quantize.py``,
``ops/int8_conv.py``, ``models/layers.py``'s int8 leaf,
``pipeline.py::InferencePipeline.quantize_int8``) against
``orienmask_tpu``'s, on the CPU (the slim model at the published widths,
96², f32 compute).

Three levels, as the scales' arithmetic allows:

* With the same activation scales, the quantized tree is JAX's bit for bit
  (``qkernel``, ``in_inv``, ``oscale``, ``bias``; the float leaves as they
  were), and the int8 convolution's int32 output is JAX's
  (``conv_general_dilated`` with int32 accumulation), both for the plain
  version and for the card's im2col and ``torch._int_mm`` route, which
  runs on the CPU too.  A quantized layer on representable inputs matches
  its float layer (``tests/test_quantize.py``'s figures) and JAX's int8
  layer bit for bit.
* Calibrated scales agree with JAX's to 1e-5 of themselves (measured
  1.6e-6 against JAX's master stem, 1.9e-6 against its space-to-depth
  stem: the convolutions sum in other orders).
* Quantized heads with the same scales agree with JAX's to 5e-6 of each
  head's largest value on the master stem (measured 1.0e-6) and 2e-4 on
  JAX's space-to-depth stem (measured 4.6e-5: its float stem rounds
  otherwise and a few int8 values flip).
* The pipelines, on images through each package's transform: the port's
  on JAX's quantized weights, and the port's own ``quantize_int8`` without
  and with the stem, each against JAX's ``quantize_int8``.  Values near a
  rounding boundary of ``quantize_i8`` flip by one step where the inputs
  differ in their last bits, and the bbox heads' logits, which this file
  spreads x1e4 (random features tie them), move with each flip: the
  orientation heads agree to 1e-5 of their largest value (measured
  6.2e-7-9.6e-7), the bbox heads to 0.1 (measured 0.028-0.043); at least
  90% of JAX's detections are found with the same class and pixel box
  (measured all, and 31 of 32 with the stem), and the masks, slot by slot
  (the order of near-tied scores changes), agree on at least 98% of the
  valid detections' pixels (measured 98.98-99.35%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.data.transform import FastCOCOTransform as JaxTransform
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.layers import ConvBNLeaky as JaxConvBNLeaky
from orienmask_tpu.models.layers import conv2d as jax_conv2d
from orienmask_tpu.models.quantize import calibrate_folded as jax_calibrate_folded
from orienmask_tpu.models.quantize import quantize_folded as jax_quantize_folded
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu.pipeline import InferencePipeline as JaxPipeline
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, folded_from_jax, variables_from_jax
from orienmask_tpu_torch.models.layers import ConvBNLeaky
from orienmask_tpu_torch.models.quantize import (
    calibrate_folded,
    cast_kernels,
    iter_convbn,
    quantize_folded,
)
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.ops.int8_conv import conv2d_int8, conv2d_int8_gemm, conv2d_int8_plain
from orienmask_tpu_torch.pipeline import InferencePipeline, folded_to_device
from orienmask_tpu_torch.stream import StreamingPipeline

SIZE = 96
SLIM = (1, 1, 1, 1, 1)
TRANSFORM = [dict(type="Resize", size=(SIZE, SIZE)),
             dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255))]
F32 = {"train": False, "dtype": jnp.float32}


def _postprocess_kwargs():
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    kw.update(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
              image_size=[SIZE, SIZE], pack_masks=True)
    return kw


def _variables(jm):
    """Seeded JAX init with the bbox heads' objectness and class logits
    spread x1e4 (``test_torch_pipeline.py``: random features tie them)."""
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(0)))
    for name in ("bbox_head8", "bbox_head16", "bbox_head32"):
        k = v["params"][name][1]["kernel"].copy()
        k = k.reshape(k.shape[:3] + (3, 85))
        k[..., 4:] *= np.float32(1e4)
        v["params"][name][1]["kernel"] = k.reshape(k.shape[:3] + (255,))
    return v


@pytest.fixture(scope="module")
def models():
    """(JAX model on its master stem, its variables, the port's model with
    the same weights, calibration images)."""
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = _variables(jm)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    calib = np.random.default_rng(1).integers(0, 256, (2, 120, 160, 3), np.uint8)
    return jm, variables, pm, calib


@pytest.fixture(scope="module")
def jax_scales(models):
    """JAX's calibrated scales, through its master stem and through its
    space-to-depth stem."""
    jm, variables, _, calib = models
    out = {}
    for s2d in (False, True):
        jm.backbone.s2d_stem = s2d
        try:
            out[s2d] = jax_calibrate_folded(jm, _jax_folded(jm, variables), calib,
                                            transform=JaxTransform(TRANSFORM))
        finally:
            jm.backbone.s2d_stem = False
    return out


def _jax_folded(jm, variables):
    """JAX's folded tree as its pipeline holds it in f32 (numpy leaves)."""
    return jax.tree_util.tree_map(np.asarray, jm.fold(variables))


def _leaves(tree):
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    if any(isinstance(v, torch.Tensor) for v in tree.values()) or not tree:
        return [tree]
    return [x for t in tree.values() for x in _leaves(t)]


def _equal_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


# ------------------------------------------------------- the int8 conv

def test_int8_conv_exact_on_representable_inputs():
    """The counterpart of ``tests/test_quantize.py``'s first test: input and
    kernel on the int8 grids, so the quantized layer computes the float
    layer's contraction exactly (to the float conv's rounding), and JAX's
    int8 layer bit for bit."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    in_scale = 0.03
    wscale = rng.uniform(0.005, 0.02, 16).astype(np.float32)
    k_int = rng.integers(-127, 128, (3, 3, 8, 16))
    x_int = rng.integers(-127, 128, (1, 12, 12, 8))
    kernel = (k_int * wscale).astype(np.float32)
    x = (x_int * in_scale).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    leaf = {"qkernel": k_int.astype(np.int8), "in_inv": np.float32(1.0 / in_scale),
            "oscale": (in_scale * wscale).astype(np.float32), "bias": bias}
    jl = JaxConvBNLeaky(8, 16, 3, padding=1)
    want = np.asarray(jl.apply_folded(jax.tree_util.tree_map(jnp.asarray, leaf),
                                      jnp.asarray(x), F32))

    layer = ConvBNLeaky(8, 16, 3, padding=1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    qkernel = torch.from_numpy(k_int.astype(np.int8).transpose(3, 2, 0, 1))
    q = layer.apply_folded({"qkernel": qkernel,
                            "in_inv": torch.tensor(leaf["in_inv"]),
                            "oscale": torch.from_numpy(leaf["oscale"]),
                            "bias": torch.from_numpy(bias)}, xt, torch.float32)
    f = layer.apply_folded({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
                            "bias": torch.from_numpy(bias)}, xt, torch.float32)
    got = q.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), got, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("cin,cout,k,stride,padding,hw", [
    (8, 16, 1, 1, 0, (11, 13)),
    (16, 24, 3, 1, 1, (9, 10)),
    (16, 32, 3, 2, 1, (12, 15)),
    (3, 32, 3, 1, 1, (8, 9)),  # conv1 with stem=True: K = 27, padded to 32
], ids=["1x1", "3x3", "3x3_s2", "conv1"])
def test_int8_conv_matches_jax(cin, cout, k, stride, padding, hw):
    """int32 outputs at full int8 range, bit for bit: the plain version and
    the card's im2col and ``_int_mm`` route (on the CPU) against JAX's int8
    convolution with int32 accumulation."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(cin * 100 + k)
    x = rng.integers(-127, 128, (2,) + hw + (cin,)).astype(np.int8)
    kernel = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(kernel), stride, padding,
                                 preferred=jnp.int32))
    q = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    qk = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    for got in (conv2d_int8(q, qk, stride, padding), conv2d_int8_plain(q, qk, stride, padding),
                conv2d_int8_gemm(q, qk.contiguous(memory_format=torch.channels_last), stride,
                                 padding)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ------------------------------------------------- the quantized tree

@pytest.mark.parametrize("exclude_stem", [False, True], ids=["stem", "no_stem"])
def test_quantized_tree_matches_jax_with_the_same_scales(models, jax_scales, exclude_stem):
    """JAX's folded tree with its kernels cast to bf16 (as its bf16 pipeline
    quantizes them) and JAX's calibrated scales, through both packages'
    ``quantize_folded``: every leaf equal by bits."""
    jm, variables, pm, calib = models
    jf = _jax_folded(jm, variables)
    jf16 = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(jnp.asarray(leaf, jnp.bfloat16))
        if getattr(path[-1], "key", None) == "kernel" else leaf, jf)
    scales = jax_scales[False]
    want = folded_from_jax(pm, jax.tree_util.tree_map(
        np.asarray, jax_quantize_folded(jm, jf16, scales, exclude_stem=exclude_stem)))
    folded = cast_kernels(folded_from_jax(pm, jf16), torch.bfloat16)
    got = quantize_folded(pm, folded, scales, exclude_stem=exclude_stem)
    n_int8 = 0
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.keys() == w.keys()
        n_int8 += "qkernel" in g
        for key in g:
            value = g[key].float() if g[key].dtype == torch.bfloat16 else g[key]
            assert _equal_bits(value, w[key]), key
    stem = [p for p, _, _ in iter_convbn(pm, got) if p[:2] in (("backbone", "conv1"),
                                                                ("backbone", "conv2"))]
    assert n_int8 == len(scales) - (len(stem) + 1 if exclude_stem else 0)
    assert "weight" in got["bbox_head32"][1] and "weight" in got["orien_head"][5]
    with pytest.raises(ValueError, match="no convs were quantized"):
        quantize_folded(pm, folded, {})


@pytest.mark.parametrize("s2d_stem", [False, True], ids=["master_stem", "phase_stem"])
def test_calibrated_scales_match_jax(models, jax_scales, s2d_stem):
    _, _, pm, calib = models
    want = jax_scales[s2d_stem]
    folded = folded_to_device(pm.fold(), "cpu", torch.float32)
    got = calibrate_folded(pm, folded, calib, FastCOCOTransform(TRANSFORM))
    assert got.keys() == want.keys() and len(got) == 50
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5, err_msg=str(path))
    assert all(m.observer is None for m in pm.modules() if isinstance(m, ConvBNLeaky))


@pytest.mark.parametrize("s2d_stem,tol", [(False, 5e-6), (True, 2e-4)],
                         ids=["master_stem", "phase_stem"])
def test_quantized_heads_match_jax_with_the_same_scales(models, jax_scales, s2d_stem, tol,
                                                       monkeypatch):
    jm, variables, pm, _ = models
    monkeypatch.setattr(jm.backbone, "s2d_stem", s2d_stem)
    jf = _jax_folded(jm, variables)
    scales = jax_scales[s2d_stem]
    x = np.random.default_rng(2).integers(0, 256, (1, SIZE, SIZE, 3)).astype(np.float32) / 255
    want = jax.jit(lambda f, x: jm.apply_folded(f, x, F32))(
        jax_quantize_folded(jm, jf, scales, exclude_stem=True), jnp.asarray(x))
    q = folded_to_device(quantize_folded(pm, folded_from_jax(pm, jf), scales, exclude_stem=True),
                         "cpu", torch.float32)
    with torch.no_grad():
        got = pm.apply_folded(q, torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    for want_pair, got_pair in zip(want, got):
        for w, g in zip(want_pair, got_pair):
            w, g = np.asarray(w), g.permute(0, 2, 3, 1).numpy()
            assert np.abs(g - w).max() <= tol * np.abs(w).max()


# ------------------------------------------------------ the pipeline

@pytest.fixture(scope="module")
def jax_pipelines(models):
    """JAX's f32 pipeline after ``quantize_int8`` and its outputs on two
    images, by ``stem``, built at first use."""
    jm, variables, _, calib = models
    image = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    built = {}

    def get(stem):
        if stem not in built:
            jpipe = JaxPipeline(jm, variables, JaxTransform(TRANSFORM),
                                JaxPostProcess(**_postprocess_kwargs()), compute_dtype="float32")
            jpipe.quantize_int8(calib, stem=stem)
            built[stem] = jpipe, jax.tree_util.tree_map(np.asarray, jpipe.run_device(image))
        return built[stem] + (image,)

    return get


@pytest.mark.parametrize("mode", ["jax_weights", "no_stem", "stem"])
def test_quantized_pipeline_against_jax(models, jax_pipelines, mode):
    """The port's f32 pipeline on JAX's quantized weights (``jax_weights``)
    or after its own ``quantize_int8`` (``stem`` as the id says), against
    JAX's after its ``quantize_int8``; the contract of ``run_device`` and
    ``__call__`` is unchanged."""
    jm, _, pm, calib = models
    stem = mode == "stem"
    jpipe, want, image = jax_pipelines(stem)
    pipe = InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")
    if mode == "jax_weights":
        pipe.folded = folded_to_device(folded_from_jax(
            pm, jax.tree_util.tree_map(np.asarray, jpipe.folded)), "cpu", torch.float32)
    else:
        assert pipe.quantize_int8(calib, stem=stem) is pipe
    leaves = {path: leaf for path, _, leaf in iter_convbn(pm, pipe.folded)}
    assert ("qkernel" in leaves[("backbone", "conv1")]) is stem
    assert "qkernel" in leaves[("backbone", "conv3", 1, 0)]
    leaf = leaves[("backbone", "conv4", 0)]
    assert leaf["qkernel"].dtype == torch.int8 and leaf["oscale"].shape == (256,)
    assert leaf["qkernel"].is_contiguous(memory_format=torch.channels_last)

    x = jpipe.transform.apply(jnp.asarray(image, jnp.float32))
    for (wb, wo), (gb, go) in zip(jm.apply_folded(jpipe.folded, x, F32), pipe.heads(image)):
        wb, wo = np.asarray(wb), np.asarray(wo)
        assert np.abs(go.numpy() - wo).max() <= 1e-5 * np.abs(wo).max()
        assert np.abs(gb.numpy() - wb).max() <= 0.1 * np.abs(wb).max()

    got = {k: v.numpy() for k, v in pipe.run_device(image).items()}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for b in range(image.shape[0]):
        def keys(out):
            return {(int(c), tuple(np.round(box[:4]).astype(int)))
                    for c, box, v in zip(out["cls"][b], out["bbox"][b], out["valid"][b]) if v}
        same, theirs = len(keys(got) & keys(want)), len(keys(want))
        assert theirs > 0 and same >= 0.9 * theirs, (same, theirs)
    valid = got["valid"][..., None, None]
    a = np.unpackbits(want["mask"], axis=-1).astype(bool) & valid
    b = np.unpackbits(got["mask"], axis=-1).astype(bool) & valid
    assert (a == b).mean() >= 0.98 and b.any(), (a == b).mean()
    results, pad_info = pipe(image)
    assert pad_info == pipe.pad_info and len(results) == 2
    assert results[0]["mask"].shape[1:] == (SIZE, SIZE) and np.isfinite(results[0]["bbox"]).all()


def test_stream_over_quantized_pipeline(models):
    """Frames streamed through ``StreamingPipeline`` over a quantized
    pipeline equal the same pipeline's direct ``run_device`` outputs
    (``tests/test_quantize.py``'s streaming test)."""
    _, _, pm, _ = models
    rng = np.random.default_rng(11)
    pipe = InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")
    pipe.quantize_int8(rng.integers(0, 255, (1, 96, 96, 3), np.uint8))
    frames = [rng.integers(0, 255, (1, 128, 160, 3), np.uint8) for _ in range(4)]
    streamed = list(StreamingPipeline(pipe, depth=2, device="cpu")(frames))
    assert len(streamed) == len(frames)
    for frame, got in zip(frames, streamed):
        want = pipe.postprocess.to_host_list(pipe.run_device(frame))
        assert len(got) == len(want) == 1
        for k in ("bbox", "cls", "mask"):
            np.testing.assert_array_equal(want[0][k], got[0][k], err_msg=k)
