"""Serving artifacts of the port (``orienmask_tpu_torch/serving.py``,
``export_serving.py``, the custom operators of ``kernels/ops.py`` and the
``while_loop`` NMS fixpoint) on the CPU, against the live port pipeline and
against the JAX package's own serving artifact (``orienmask_tpu/serving.py``).

The slim model (``backbone_stage_blocks=(1, 1, 1, 1, 1)``, the master stem)
at 96², f32, inputs (1, 120, 160, 3) and (2, 96, 96, 3), as
``tests/test_serving.py``.  Weights reach both packages from one seeded JAX
init, with the bbox heads' objectness and class logits spread x1e4 as
``tests/test_torch_pipeline.py`` spreads them (random features tie the
scores); the port's pipeline runs JAX's folded weights
(``models/convert.py::folded_from_jax``), so both artifacts hold the same
weights.  Served equals live by bits; served port against served JAX at
``tests/test_torch_pipeline.py``'s tolerances (the same ``cls`` and
``valid``, ``bbox`` within rtol 1e-5 / atol 2e-6, mask pixel agreement at
least 0.9999)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.data.transform import FastCOCOTransform as JaxTransform
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.ops.nms import greedy_nms_fixpoint as jax_greedy_nms_fixpoint
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu.pipeline import InferencePipeline as JaxPipeline
from orienmask_tpu.serving import export_pipeline as jax_export_pipeline
from orienmask_tpu.serving import load_serving as jax_load_serving
from orienmask_tpu_torch import export_serving
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, folded_from_jax, variables_from_jax
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.ops.nms import ROUND_CHUNK, greedy_nms_fixpoint
from orienmask_tpu_torch.pipeline import InferencePipeline, folded_to_device
from orienmask_tpu_torch.serving import (
    MANIFEST,
    WEIGHTS,
    export_pipeline,
    load_serving,
    update_weights,
)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 96
SLIM = (1, 1, 1, 1, 1)
SHAPES = [(1, 120, 160, 3), (2, 96, 96, 3)]
TRANSFORM = [dict(type="Resize", size=(SIZE, SIZE)),
             dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255))]


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


def _port_pipeline(variables):
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    return InferencePipeline(pm, FastCOCOTransform(TRANSFORM),
                             OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu"),
                             compute_dtype="float32", device="cpu")


def _images(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, shape, np.uint8) for shape in shapes]


def _assert_same(want, got):
    assert sorted(want) == sorted(got) == ["bbox", "cls", "mask", "valid"]
    for key in want:
        assert want[key].dtype == got[key].dtype, key
        assert torch.equal(want[key], got[key]), key


@pytest.fixture(scope="module")
def models():
    """(JAX pipeline, the port's pipeline on JAX's folded weights)."""
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    jm.backbone.s2d_stem = False
    variables = _variables(jm)
    jpipe = JaxPipeline(jm, variables, JaxTransform(TRANSFORM),
                        JaxPostProcess(**_postprocess_kwargs()), compute_dtype="float32")
    pipe = _port_pipeline(variables)
    folded = folded_from_jax(pipe.model, jax.tree_util.tree_map(np.asarray, jpipe.folded))
    pipe.folded = folded_to_device(folded, pipe.device, pipe.dtype)
    return jpipe, pipe


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """(the JAX package's artifact, the port's artifact and its manifest),
    both of the same weights at ``SHAPES``."""
    jpipe, pipe = models
    jax_dir, port_dir = tmp_path_factory.mktemp("jax_art"), tmp_path_factory.mktemp("port_art")
    jax_export_pipeline(jpipe, SHAPES, str(jax_dir))
    manifest = export_pipeline(pipe, SHAPES, str(port_dir))
    return jax_dir, port_dir, manifest


@pytest.fixture(scope="module")
def served(artifacts):
    return load_serving(artifacts[1], device="cpu")


def test_export_load_bit_exact(models, artifacts, served):
    _, pipe = models
    manifest = artifacts[2]
    assert manifest["n_weights"] > 0 and len(manifest["programs"]) == 2
    assert manifest["platforms"] == ["cpu"] and manifest["torch_version"] == torch.__version__
    assert served.input_shapes == sorted(SHAPES)
    assert served.pad_info == pipe.pad_info
    for image in _images(7):
        _assert_same(pipe.run_device(image), served.run_device(image))
        _assert_same(pipe.run_device(image), served.run_device(torch.from_numpy(image)))

    # __call__ mirrors the pipeline's (trimmed host dicts, pad_info)
    image = _images(8)[0]
    live, live_pad = pipe(image)
    srv, srv_pad = served(image)
    assert live_pad == srv_pad and len(live) == len(srv)
    assert sum(len(r["cls"]) for r in live) > 0
    for lw, sv in zip(live, srv):
        assert sorted(lw) == sorted(sv)
        for key in lw:
            np.testing.assert_array_equal(lw[key], sv[key], err_msg=key)
            assert lw[key].dtype == sv[key].dtype


def test_weights_keep_their_dtype_and_memory_format(models, served):
    """The loaded weights are the live pipeline's folded leaves by value,
    dtype and strides (the conv kernels channels_last)."""
    _, pipe = models
    live = torch.utils._pytree.tree_leaves(pipe.folded)
    assert len(live) == len(served.weights)
    assert sum(t.dim() == 4 for t in live) > 50
    for a, b in zip(live, served.weights):
        assert a.dtype == b.dtype and a.shape == b.shape and a.stride() == b.stride()
        assert torch.equal(a, b)


def test_served_port_matches_the_jax_packages_artifact(artifacts, served):
    """The port's artifact against ``orienmask_tpu/serving.py``'s, the same
    weights and images."""
    jax_served = jax_load_serving(str(artifacts[0]))
    for image in _images(9):
        want = jax.tree_util.tree_map(np.asarray, jax_served.run_device(image))
        got = {k: v.numpy() for k, v in served.run_device(image).items()}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        assert got["valid"].sum() > 0
        np.testing.assert_array_equal(got["cls"], want["cls"])
        np.testing.assert_allclose(got["bbox"], want["bbox"], rtol=1e-5, atol=2e-6)
        valid = got["valid"][..., None, None]
        a = np.unpackbits(want["mask"], axis=-1).astype(bool) & valid
        b = np.unpackbits(got["mask"], axis=-1).astype(bool) & valid
        assert (a == b).mean() >= 0.9999, (a == b).mean()
        assert b.any()


def test_graph_calls_the_custom_operators(served):
    for shape in SHAPES:
        targets = [str(n.target) for n in served._fns[shape].graph.nodes
                   if n.op == "call_function"]
        assert targets.count("omt.exact_topk.default") == 2, shape
        assert targets.count("omt.assemble_masks_packed.default") == 1, shape
        assert any("while_loop" in t.lower() for t in targets), shape


def test_unknown_shape_raises(served):
    with pytest.raises(KeyError, match="no exported program"):
        served.run_device(np.zeros((1, 64, 64, 3), np.uint8))


def test_weight_swap_without_reexport(models, artifacts, tmp_path):
    """A new checkpoint of the same architecture swaps in by
    ``update_weights``: programs untouched, digests refreshed."""
    _, pipe = models
    shutil.copytree(artifacts[1], tmp_path, dirs_exist_ok=True)
    programs = {p.name: p.read_bytes() for p in tmp_path.glob("*.pt2")}
    flat, spec = torch.utils._pytree.tree_flatten(pipe.folded)
    rng = np.random.default_rng(3)
    bumped = [w.clone().add_(torch.from_numpy(rng.normal(0, 0.01, tuple(w.shape))
                                              .astype(np.float32))) for w in flat]
    update_weights(tmp_path, torch.utils._pytree.tree_unflatten(bumped, spec))
    assert {p.name: p.read_bytes() for p in tmp_path.glob("*.pt2")} == programs

    served = load_serving(tmp_path, device="cpu")
    image = _images(3, SHAPES[1:])[0]
    out = served.run_device(image)
    assert torch.isfinite(out["bbox"]).all()
    # the program consumed the new weights: its boxes differ from the live pipeline's
    assert not torch.equal(pipe.run_device(image)["bbox"], out["bbox"])
    # and they are a pipeline's on those weights
    swapped = InferencePipeline(pipe.model, pipe.transform, pipe.postprocess,
                                compute_dtype="float32", device="cpu")
    swapped.folded = torch.utils._pytree.tree_unflatten(bumped, spec)
    _assert_same(swapped.run_device(image), out)

    wrong = list(bumped)
    wrong[0] = torch.zeros(tuple(wrong[0].shape[:-1]) + (7,))
    with pytest.raises(ValueError, match="different[ \n]+model variant"):
        update_weights(tmp_path, torch.utils._pytree.tree_unflatten(wrong, spec))
    wrong[0] = bumped[0].double()
    with pytest.raises(ValueError, match="dtype"):
        update_weights(tmp_path, torch.utils._pytree.tree_unflatten(wrong, spec))


def test_artifact_integrity_checks(artifacts, tmp_path):
    """A raw weights.npz overwrite, a truncated blob set and a non-uint8
    image fail loudly."""
    shutil.copytree(artifacts[1], tmp_path, dirs_exist_ok=True)
    manifest = json.loads((tmp_path / MANIFEST).read_text())
    assert manifest["format_version"] >= 2
    assert len(manifest["weight_digests"]) == manifest["n_weights"]
    assert len(manifest["weight_strides"]) == manifest["n_weights"]
    assert len(manifest["arch_fingerprint"]) == 64

    blob = dict(np.load(tmp_path / WEIGHTS))
    k0 = "w%05d" % 0
    tampered = dict(blob)
    t = tampered[k0].copy()
    t.flat[0] += 1
    tampered[k0] = t
    np.savez(tmp_path / WEIGHTS, **tampered)
    with pytest.raises(ValueError, match="checksum mismatch"):
        load_serving(tmp_path, device="cpu")

    np.savez(tmp_path / WEIGHTS, **{k0: blob[k0]})
    with pytest.raises(ValueError, match="does not belong"):
        load_serving(tmp_path, device="cpu")

    np.savez(tmp_path / WEIGHTS, **blob)
    served = load_serving(tmp_path, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        served.run_device(np.zeros(SHAPES[0], np.float32))
    with pytest.raises(TypeError, match="uint8"):
        served.run_device(torch.zeros(SHAPES[0]))


def test_platforms_and_device_are_checked(models, artifacts, tmp_path):
    """A platform the port cannot export is refused naming it; ``cuda``
    without a card raises (``tests/test_torch_platforms.py`` holds the
    exports for several platforms)."""
    _, pipe = models
    with pytest.raises(ValueError, match="'tpu'"):
        export_pipeline(pipe, SHAPES[:1], tmp_path, platforms=["tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_pipeline(pipe, SHAPES[:1], tmp_path, platforms=["cuda", "cpu"])
    manifest = json.loads((artifacts[1] / MANIFEST).read_text())
    shutil.copytree(artifacts[1], tmp_path, dirs_exist_ok=True)
    (tmp_path / MANIFEST).write_text(json.dumps(dict(manifest, platforms=["cuda"])))
    with pytest.raises(ValueError, match="runs on"):
        load_serving(tmp_path, device="cpu")


def test_int8_round_trip(models, tmp_path):
    """A quantized pipeline exports and loads with its int8 leaves in the
    shared npz, bit-identical to the live program at both shapes."""
    _, pipe = models
    qpipe = InferencePipeline(pipe.model, pipe.transform, pipe.postprocess,
                              compute_dtype="float32", device="cpu")
    qpipe.quantize_int8(_images(5, [(1, 96, 96, 3)])[0])
    manifest = export_pipeline(qpipe, SHAPES, tmp_path)
    assert "int8" in manifest["weight_dtypes"] and "bfloat16" not in manifest["weight_dtypes"]
    served = load_serving(tmp_path, device="cpu")
    for image in _images(6):
        want = qpipe.run_device(image)
        _assert_same(want, served.run_device(image))
        assert want["valid"].any()


def test_bf16_leaves_round_trip(models, tmp_path):
    """bf16 leaves are stored as uint16 views and come back by bits."""
    _, pipe = models
    bpipe = InferencePipeline(pipe.model, pipe.transform, pipe.postprocess,
                              compute_dtype="bfloat16", device="cpu")
    shape = (1, 96, 96, 3)
    manifest = export_pipeline(bpipe, [shape], tmp_path)
    assert manifest["weight_dtypes"].count("bfloat16") > 50
    assert np.load(tmp_path / WEIGHTS)["w00000"].dtype == np.uint16
    served = load_serving(tmp_path, device="cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(bpipe.folded), served.weights):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16))
    image = _images(4, [shape])[0]
    _assert_same(bpipe.run_device(image), served.run_device(image))


def test_artifact_runs_without_the_model_code(models, artifacts, tmp_path):
    """A fresh process loads and runs the artifact with
    ``orienmask_tpu_torch.models``, JAX and the JAX package unimportable."""
    _, pipe = models
    image = _images(10, SHAPES[1:])[0]
    np.save(tmp_path / "image.npy", image)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'orienmask_tpu', 'orienmask_tpu_torch.models'): "
            "sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from orienmask_tpu_torch.serving import load_serving\n"
            "served = load_serving(sys.argv[1], device='cpu')\n"
            "out = served.run_device(np.load(sys.argv[2]))\n"
            "np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})\n"
            "loaded = [m for m, v in sys.modules.items() if v is not None]\n"
            "assert not any(m.startswith('orienmask_tpu_torch.models') for m in loaded)\n"
            "assert not any(m.split('.')[0] in ('jax', 'orienmask_tpu') for m in loaded)\n")
    out = tmp_path / "out.npz"
    proc = subprocess.run([sys.executable, "-c", code, str(artifacts[1]),
                           str(tmp_path / "image.npy"), str(out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    got = dict(np.load(out))
    want = pipe.run_device(image)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].numpy(), err_msg=key)


def _topk_args():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32))
    return x, 7


def _mask_args(valid, coord_h):
    rng = np.random.default_rng(1)
    b, a, h, w, k = 2, 3, 8, 16, 5
    field = torch.from_numpy(rng.standard_normal((b, a, 2, h, w)).astype(np.float32))
    boxes = torch.from_numpy(rng.uniform(0.1, 0.9, (b, k, 4)).astype(np.float32))
    anchor_idx = torch.from_numpy(rng.integers(0, a, (b, k)).astype(np.int32))
    table = torch.from_numpy(rng.uniform(0.1, 0.5, (a, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, k)) < 0.7) if valid else None
    return field, boxes, anchor_idx, table, 0.3, coord_h, 0, valid


@pytest.mark.parametrize("args", [_topk_args(), _mask_args(True, None), _mask_args(False, 12)],
                         ids=["exact_topk", "assemble_masks_packed valid",
                              "assemble_masks_packed coord_h"])
def test_opcheck(args):
    op = (torch.ops.omt.exact_topk.default if len(args) == 2
          else torch.ops.omt.assemble_masks_packed.default)
    torch.library.opcheck(op, args)


def test_ops_are_the_plain_versions_on_the_cpu():
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain

    x, k = _topk_args()
    for got, want in zip(exact_topk(x, k), exact_topk_plain(x, k)):
        assert torch.equal(got, want)
    field, boxes, anchor_idx, table, t, coord_h, row0, valid = _mask_args(True, 12)
    assert torch.equal(
        assemble_masks_packed(field, boxes, anchor_idx, table, t, coord_h, row0, valid),
        assemble_masks_packed_plain(field, boxes, anchor_idx, table, t, coord_h, row0, valid))


def _chain(n, rng):
    """``n`` boxes in descending score order, each overlapping the next
    with IoU 0.58 and the one after with IoU 0.30: the greedy kept set
    alternates, and the fixpoint needs about n rounds."""
    cx = 0.1 + 0.08 * np.arange(n)
    boxes = np.stack([cx, np.full(n, 0.5), np.full(n, 0.3), np.full(n, 0.3)], -1)
    scores = np.sort(rng.uniform(0.1, 1.0, n))[::-1]
    return boxes.astype(np.float32), scores.astype(np.float32)


def test_fixpoint_matches_jax_eager_and_exported():
    """The ``while_loop`` fixpoint, eager and exported, equals JAX
    ``greedy_nms_fixpoint`` on a suppression chain several chunks deep and
    on random boxes."""
    rng = np.random.default_rng(2)
    n, n_keep = 5 * ROUND_CHUNK + 3, 30
    chain = _chain(n, rng)
    rand = (np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))], -1)
            .astype(np.float32), np.sort(rng.uniform(0.1, 1.0, n))[::-1].astype(np.float32))
    boxes = np.stack([chain[0], rand[0]])
    scores = np.stack([chain[1], rand[1]])
    scores[1, -5:] = -1e30  # invalid candidates
    want = [jax_greedy_nms_fixpoint(boxes[b], scores[b], n_keep, 0.5, presorted=True)
            for b in range(2)]
    want_idx = np.stack([np.asarray(w[0]) for w in want])
    want_valid = np.stack([np.asarray(w[1]) for w in want])
    assert want_valid[0].sum() == (n + 1) // 2  # the chain's alternate boxes

    class Nms(torch.nn.Module):
        def forward(self, boxes, scores):
            return greedy_nms_fixpoint(boxes, scores, n_keep, 0.5)

    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    program = torch.export.export(Nms(), args)
    assert any("while_loop" in str(node.target).lower() for node in program.graph.nodes)
    for idx, valid in (Nms()(*args), program.module()(*args)):
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(valid.numpy(), want_valid)


def test_export_cli_in_process(tmp_path, capsys):
    """``python -m orienmask_tpu_torch.export_serving`` on a ``.json``
    config: exports, loads and verifies bit for bit."""
    config = json.loads(json.dumps(cfg))
    config["model"]["backbone_stage_blocks"] = list(SLIM)
    config["compute_dtype"] = "float32"
    config["transform"]["pipeline"][0]["size"] = [SIZE, SIZE]
    config["postprocess"].update(_postprocess_kwargs())
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    out = tmp_path / "artifact"
    assert export_serving.main(["-c", str(path), "-o", str(out), "--shape", "2,96,96",
                                "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "[verify] (2, 96, 96, 3) bit-exact" in printed and "[export] OK" in printed
    assert sorted(p.name for p in out.iterdir()) == [MANIFEST, "program_2x96x96x3_cpu.pt2", WEIGHTS]
