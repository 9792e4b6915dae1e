"""Serving artifacts for several platforms (``orienmask_tpu_torch/serving.py``
``export_pipeline(..., platforms=)``, JAX ``orienmask_tpu/serving.py:60-118``)
and the data-parallel backend rule (``parallel/mesh.py::choose_backend``)
on the CPU.

The slim port model (``backbone_stage_blocks=(1, 1, 1, 1, 1)``) at 64², f32,
seeded random weights: served equals live by bits.  The tests run without
a card, so a ``cuda`` program is listed in a manifest but never loaded."""

import json
import shutil

import numpy as np
import pytest
import torch

from orienmask_tpu_torch import export_serving
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
from orienmask_tpu_torch.data import FastCOCOTransform
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, init_random
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.parallel import mesh
from orienmask_tpu_torch.pipeline import InferencePipeline
from orienmask_tpu_torch.serving import MANIFEST, export_pipeline, load_serving

SIZE = 64
SHAPES = [(2, 48, 80, 3)]


@pytest.fixture(scope="module")
def pipe():
    torch.set_num_threads(1)
    model = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=(1, 1, 1, 1, 1))
    init_random(model, seed=0)
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    kw.update(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
              image_size=[SIZE, SIZE])
    transform = FastCOCOTransform([dict(type="Resize", size=(SIZE, SIZE)),
                                   dict(type="Normalize", mean=(0, 0, 0),
                                        std=(255, 255, 255))])
    return InferencePipeline(model, transform, OrienMaskYOLOPostProcess(**kw, device="cpu"),
                             compute_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def artifact(pipe, tmp_path_factory):
    out = tmp_path_factory.mktemp("platforms")
    return out, export_pipeline(pipe, SHAPES, str(out), platforms=["cpu"])


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, shape, np.uint8) for shape in SHAPES]


def _assert_served_is_live(pipe, served, seed):
    for image in _images(seed):
        want, got = pipe.run_device(image), served.run_device(image)
        assert sorted(want) == sorted(got)
        for key in want:
            assert want[key].dtype == got[key].dtype and torch.equal(want[key], got[key]), key


def test_cpu_export_lists_its_programs_and_loads_equal_to_live(pipe, artifact):
    out, manifest = artifact
    assert manifest["format_version"] == 3 and manifest["platforms"] == ["cpu"]
    names = manifest["programs_by_platform"]["cpu"]
    assert names == ["program_2x48x80x3_cpu.pt2"]
    assert all(manifest["programs"][n]["platform"] == "cpu" for n in names)
    assert sorted(p.name for p in out.glob("*.pt2")) == names
    _assert_served_is_live(pipe, load_serving(out, device="cpu"), 1)


def test_a_manifest_of_cuda_and_cpu_loads_its_cpu_programs_on_the_cpu(pipe, artifact,
                                                                        tmp_path):
    """An artifact exported on the card for ["cuda", "cpu"]: a CPU host
    loads the ``cpu`` programs and never opens the ``cuda`` files."""
    out, manifest = artifact
    programs, by_platform = {}, {"cuda": [], "cpu": []}
    for name, meta in manifest["programs"].items():
        for platform in ("cuda", "cpu"):
            renamed = name.replace("_cpu.pt2", f"_{platform}.pt2")
            programs[renamed] = dict(meta, platform=platform)
            by_platform[platform].append(renamed)
            if platform == "cpu":
                shutil.copy(out / name, tmp_path / renamed)
            else:  # a file the CPU load must not read
                (tmp_path / renamed).write_bytes(b"not a CPU program")
    shutil.copy(out / "weights.npz", tmp_path / "weights.npz")
    (tmp_path / MANIFEST).write_text(json.dumps(dict(
        manifest, platforms=["cuda", "cpu"], programs=programs,
        programs_by_platform=by_platform)))
    served = load_serving(tmp_path, device="cpu")
    assert served.input_shapes == SHAPES
    _assert_served_is_live(pipe, served, 2)


def test_a_version_2_artifact_still_loads(pipe, artifact, tmp_path):
    """The parent's format: one platform, programs listed without one."""
    out, manifest = artifact
    shutil.copytree(out, tmp_path, dirs_exist_ok=True)
    v2 = {k: v for k, v in manifest.items() if k != "programs_by_platform"}
    v2.update(format_version=2, programs={n: {"input_shape": m["input_shape"]}
                                          for n, m in manifest["programs"].items()})
    (tmp_path / MANIFEST).write_text(json.dumps(v2))
    _assert_served_is_live(pipe, load_serving(tmp_path, device="cpu"), 3)


@pytest.mark.parametrize("platforms", [["tpu"], ["cpu", "tpu"], ["cuda"], ["cuda", "cpu"]])
def test_platforms_the_port_cannot_export_raise(pipe, tmp_path, monkeypatch, platforms):
    """``tpu`` is refused naming it and JAX's StableHLO artifacts; ``cuda``
    with no card raises: an export never falls back to another platform."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if "tpu" in platforms:
        with pytest.raises(ValueError, match="'tpu'.*StableHLO"):
            export_pipeline(pipe, SHAPES, tmp_path, platforms=platforms)
    else:
        with pytest.raises(RuntimeError, match="'cuda'.*no CUDA device"):
            export_pipeline(pipe, SHAPES, tmp_path, platforms=platforms)
    assert not list(tmp_path.iterdir())


def test_loading_on_a_platform_the_artifact_lacks_names_the_ones_it_has(artifact, tmp_path):
    out, manifest = artifact
    shutil.copytree(out, tmp_path, dirs_exist_ok=True)
    (tmp_path / MANIFEST).write_text(json.dumps(dict(manifest, platforms=["cuda"])))
    with pytest.raises(ValueError, match=r"runs on \['cuda'\], not on cpu"):
        load_serving(tmp_path, device="cpu")


def test_pipeline_to_its_own_device_is_itself_and_moves_nothing(pipe):
    assert pipe.to("cpu") is pipe
    post = pipe.postprocess.to("cpu")
    assert post is not pipe.postprocess and torch.equal(post.det_grid_x,
                                                        pipe.postprocess.det_grid_x)


def test_export_cli_takes_platforms(tmp_path, capsys):
    out = tmp_path / "art"
    assert export_serving.main(["-c", str(_tiny_config(tmp_path)), "-o", str(out),
                                "--shape", "1,64,64", "--device", "cpu",
                                "--platforms", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "platforms=['cpu']" in printed
    assert "[verify] (1, 64, 64, 3) bit-exact vs live pipeline on cpu" in printed
    manifest = json.loads((out / MANIFEST).read_text())
    assert manifest["programs_by_platform"] == {"cpu": ["program_1x64x64x3_cpu.pt2"]}


def _tiny_config(tmp_path):
    config = json.loads(json.dumps(cfg))
    config["model"]["backbone_stage_blocks"] = [1, 1, 1, 1, 1]
    config["model"]["pretrained"] = None
    config["transform"]["pipeline"][0]["size"] = [SIZE, SIZE]
    config["postprocess"].update(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2,
                                            [SIZE // 8] * 2], image_size=[SIZE, SIZE])
    config["compute_dtype"] = "float32"
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    return path


@pytest.mark.parametrize("local, count, ranks, want", [
    ("8", 8, 16, "nccl"),   # two hosts of 8 cards, 8 ranks each
    ("2", 1, 2, "gloo"),    # two ranks sharing the one card
    ("4", 8, 8, "nccl"),    # 4 ranks a host on hosts of 8 cards
    ("16", 8, 16, "gloo"),  # 16 ranks on one host of 8 cards
    (None, 8, 16, "gloo"),  # no launcher's variable: all ranks on this host
    (None, 8, 8, "nccl"),
    (None, 1, 2, "gloo"),
])
def test_backend_follows_the_local_world_size(monkeypatch, local, count, ranks, want):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert mesh.choose_backend(torch.device("cuda", 0), ranks) == want
    assert mesh.choose_backend(torch.device("cpu"), ranks) == "gloo"
