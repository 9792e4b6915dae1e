"""The port's infer CLI (``python -m orienmask_tpu_torch.infer``) against the
JAX package's ``infer.py``, and its own behaviour.

One ``.ckpt`` from JAX variables (the bbox heads' logits spread as in
``test_torch_pipeline.py``), a JSON config of the slim model at 128², f32,
and four 96x128 PNGs: both CLIs run in subprocesses with the same arguments
(``-w -c -d -j -o``; the port's with ``--device cpu``) and dump the same
image ids and categories, boxes and scores to 1e-4 pixels and 1e-6
(measured 9.5e-7 pixels and 5.4e-7 over 400 detections), and segm RLEs
whose masks agree on at least 99.9% of the pixels (the port resizes masks
with torch's bilinear resize, JAX with OpenCV's: measured 100% here)."""

import json
import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from orienmask_tpu.eval import rle
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.utils.envs import cpu_subprocess_env
from orienmask_tpu_torch import infer
from test_torch_pipeline import SLIM, TRANSFORM, _postprocess_kwargs, _variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    pp = dict(_postprocess_kwargs(), type="OrienMaskYOLOPostProcess")
    pp.pop("pack_masks")
    return {
        "n_device": 1,
        "compute_dtype": "float32",
        "stream_depth": 2,
        "model": {"type": "OrienMaskYOLOFPNPlus", "num_anchors": 3, "num_classes": 80,
                  "pretrained": None, "freeze_backbone": False,
                  "backbone_batchnorm_eval": False, "backbone_stage_blocks": list(SLIM)},
        "transform": {"type": "FastCOCOTransform", "pipeline": TRANSFORM},
        "postprocess": pp,
    }


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    v = _variables(JaxModel(3, 80, backbone_stage_blocks=SLIM))
    with open(root / "weights.ckpt", "wb") as fh:
        pickle.dump({"epoch": 0, "params": v["params"], "batch_stats": v["batch_stats"],
                     "config": _config()}, fh)
    (root / "config.json").write_text(json.dumps(_config()))
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(7)
    entries = []
    for i in range(4):
        cv2.imwrite(str(images / f"im{i}.png"),
                    rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
        entries.append({"file_name": f"im{i}.png", "height": 96, "width": 128, "id": 10 + i})
    (root / "images.json").write_text(json.dumps({"images": entries}))
    return root


def _args(root, out):
    return ["-w", str(root / "weights.ckpt"), "-c", str(root / "config.json"),
            "-d", str(root / "images"), "-j", str(root / "images.json"), "-o", str(out)]


def _run(cmd):
    proc = subprocess.run(cmd, cwd=REPO, env=cpu_subprocess_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


@pytest.fixture(scope="module")
def dumps(inputs):
    out = {}
    for name, cmd in (("jax", [sys.executable, "infer.py"]),
                      ("port", [sys.executable, "-m", "orienmask_tpu_torch.infer",
                                "--device", "cpu"])):
        stdout = _run(cmd + _args(inputs, inputs / name))
        assert "The average inference time is" in stdout
        out[name] = {kind: json.loads((inputs / name / f"{kind}_prediction.json").read_text())
                     for kind in ("bbox", "segm")}
    return out


def test_cli_dumps_the_same_detections_as_the_jax_cli(dumps):
    want, got = dumps["jax"]["bbox"], dumps["port"]["bbox"]
    assert len(got) == len(want) > 0
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    np.testing.assert_allclose([d["bbox"] for d in got], [d["bbox"] for d in want],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want],
                               rtol=0, atol=1e-6)
    assert {d["image_id"] for d in got} == {10, 11, 12, 13}


def test_cli_segm_agrees_with_the_jax_cli(dumps):
    want, got = dumps["jax"]["segm"], dumps["port"]["segm"]
    assert len(got) == len(want) == len(dumps["port"]["bbox"])
    same = total = 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        mg, mw = rle.decode(g["segmentation"]), rle.decode(w["segmentation"])
        assert mg.shape == mw.shape == (96, 128)
        same += int((mg == mw).sum())
        total += mg.size
    assert same / total >= 0.999, same / total


@pytest.fixture
def frames(tmp_path):
    from orienmask_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(8)
    for i in range(3):
        write_png(tmp_path / f"f{i:03d}.png", rng.integers(0, 256, (96, 128, 3), np.uint8))
    return tmp_path


def test_video_over_a_frame_directory_prints_the_streaming_report(inputs, frames, capsys):
    torch.set_num_threads(1)
    assert infer.main(["--device", "cpu", "-c", str(inputs / "config.json"), "-w",
                       str(inputs / "weights.ckpt"), "--video", str(frames),
                       "--stream-depth", "1"]) == 0
    out = capsys.readouterr().out
    assert "Streamed 3 frames (depth=1)" in out and "fps)" in out


def test_image_mode_prints_the_timer_report(inputs, capsys):
    torch.set_num_threads(1)
    assert infer.main(["--device", "cpu", "-c", str(inputs / "config.json"), "-w",
                       str(inputs / "weights.ckpt"), "-i",
                       str(inputs / "images" / "im0.png")]) == 0
    out = capsys.readouterr().out
    assert "The inference takes" in out
    assert "Forward & Postprocess: " in out and "ms (" in out


@pytest.mark.parametrize("extra,message", [
    (["--video", "clip.mp4"], "cv2.VideoCapture"),
    (["--video", "frames", "-o", "out.mp4"], "cv2.VideoWriter"),
])
def test_refused_flags_exit_with_their_message(inputs, extra, message):
    torch.set_num_threads(1)
    with pytest.raises(SystemExit) as err:
        infer.main(["--device", "cpu", "-c", str(inputs / "config.json"),
                    "--random-weights", "-i", "x.png"] + extra)
    assert message in str(err.value.code)


def test_video_output_implies_visualize_then_refuses(inputs, capsys):
    """As the JAX CLI does, ``--video -o`` turns on the visualizer; a video
    file for the output is then refused (cv2.VideoWriter is not ported)."""
    with pytest.raises(SystemExit) as err:
        infer.main(["--device", "cpu", "-c", str(inputs / "config.json"),
                    "--random-weights", "--video", "frames", "-o", "out.avi"])
    assert "--output implies --visualize" in capsys.readouterr().out
    assert "cv2.VideoWriter" in str(err.value.code)
    assert "frame_%06d.jpg" in str(err.value.code)
    assert "ROADMAP Queue 1 item 1" in str(err.value.code)


def test_jpeg_input_exits_with_the_formats_read(inputs, tmp_path):
    """A JPEG form the decoder refuses (4-component, as PIL writes CMYK)
    exits naming the form and what is read."""
    from PIL import Image

    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("CMYK").save(tmp_path / "a.jpg")
    proc = subprocess.run(
        [sys.executable, "-m", "orienmask_tpu_torch.infer", "--device", "cpu", "-c",
         str(inputs / "config.json"), "--random-weights", "-i", str(tmp_path / "a.jpg")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "4-component JPEG" in proc.stderr and "reads PNG (every colour type" in proc.stderr


def _run_main(argv):
    torch.set_num_threads(1)
    assert infer.main(["--device", "cpu"] + argv) == 0


@pytest.fixture(scope="module")
def no_flag_dump(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("no_flag")
    _run_main(["-c", str(inputs / "config.json"), "--random-weights", "-d",
               str(inputs / "images"), "-j", str(inputs / "images.json"), "-o", str(out)])
    return out


@pytest.mark.parametrize("spatial", ["0", "1"])
def test_spatial_0_and_1_dump_what_no_flag_dumps(inputs, no_flag_dump, tmp_path, spatial):
    """The JAX CLI builds a mesh only for --spatial N > 1 (infer.py:93), so
    0 and 1 run the plain pipeline: the same JSON files, byte for byte."""
    _run_main(["-c", str(inputs / "config.json"), "--random-weights", "-d",
               str(inputs / "images"), "-j", str(inputs / "images.json"), "-o",
               str(tmp_path), "--spatial", spatial])
    for kind in ("bbox", "segm"):
        name = f"{kind}_prediction.json"
        assert (tmp_path / name).read_bytes() == (no_flag_dump / name).read_bytes()
    assert json.loads((tmp_path / "bbox_prediction.json").read_text())


def test_spatial_2_dumps_what_no_flag_dumps(inputs, tmp_path, capfd):
    """--spatial 2 shards each image's rows over two spawned ranks (gloo on
    the CPU), on the spread-logit weights: rank 0 alone prints and writes,
    and its JSON files hold no flag's detections in no flag's order, boxes
    to 1e-4 pixels and scores to 1e-6, as against the JAX CLI (measured 0
    and 3.0e-7 over 400 detections: the row-sharded forward's heads differ
    from the whole image's in the last bits), and the same masks' RLEs."""
    dumps = {}
    for name, extra in (("no_flag", []), ("spatial", ["--spatial", "2"])):
        _run_main(_args(inputs, tmp_path / name) + extra)
        dumps[name] = {kind: json.loads((tmp_path / name / f"{kind}_prediction.json").read_text())
                       for kind in ("bbox", "segm")}
    out = capfd.readouterr().out
    assert out.count("The inference takes") == 2 and "2 ranks over gloo on the CPU" in out
    assert sorted(p.name for p in (tmp_path / "spatial").iterdir()) == [
        "bbox_prediction.json", "segm_prediction.json"]
    want, got = dumps["no_flag"]["bbox"], dumps["spatial"]["bbox"]
    assert len(got) == len(want) > 0
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    np.testing.assert_allclose([d["bbox"] for d in got], [d["bbox"] for d in want],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want],
                               rtol=0, atol=1e-6)
    assert [d["segmentation"] for d in dumps["spatial"]["segm"]] == \
        [d["segmentation"] for d in dumps["no_flag"]["segm"]]


def test_spatial_2_without_a_card_raises_before_spawning(inputs, monkeypatch):
    """No fallback: --spatial 2 on the default device, with no card, raises
    in this process before a rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["-c", str(inputs / "config.json"), "--random-weights", "-i", "x.png",
                    "--spatial", "2"])


def test_spatial_2_streams_a_frame_directory(inputs, frames, capfd):
    """--video under --spatial 2: both ranks run the stream's loop, rank 0
    alone reports."""
    _run_main(["-c", str(inputs / "config.json"), "-w", str(inputs / "weights.ckpt"),
               "--video", str(frames), "--stream-depth", "1", "--spatial", "2"])
    out = capfd.readouterr().out
    assert out.count("Streamed 3 frames (depth=1)") == 1


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """Three JPEGs at 4:2:0, 4:4:4 and progressive, and a JSON config whose
    visualizer block is the published one."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(9)
    for i, params in enumerate(([], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
        cv2.imwrite(str(root / f"im{i}.jpg"), rng.integers(0, 256, (96, 128, 3), np.uint8),
                    params)
    return root


def _config_with_visualizer(inputs, conf_thresh=0.3):
    from orienmask_tpu_torch.config import coco_visualizer

    config = dict(_config(), visualizer=dict(coco_visualizer, conf_thresh=conf_thresh))
    path = inputs / f"config_vis_{conf_thresh}.json"
    path.write_text(json.dumps(config))
    return path


def test_visualize_over_a_jpeg_directory_writes_one_png_each(inputs, jpeg_dir, tmp_path,
                                                             capsys):
    """-d <JPEGs> -v -o: one JPEG per image under the image's own name, as
    the JAX CLI's cv2.imwrite writes it: byte for byte cv2's JPEG of the
    JAX visualizer's drawing of the port's detections on cv2's decode of
    the input (conf_thresh 0 draws every box, label and mask), and
    Visualize in the timer report."""
    import random

    from orienmask_tpu.utils.visualizer import InferenceVisualizer as JaxVisualizer
    from orienmask_tpu_torch.data.image_io import read_image
    from orienmask_tpu_torch.pipeline import InferencePipeline

    drawn = []
    run = InferencePipeline.run_device

    def keep(pipe, image):
        out = run(pipe, image)
        drawn.append((image[0].copy(), pipe.postprocess.to_host_list(out)[0], pipe.pad_info))
        return out

    random.seed(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(InferencePipeline, "run_device", keep)
        _run_main(["-c", str(_config_with_visualizer(inputs, 0.0)), "-w",
                   str(inputs / "weights.ckpt"), "-d", str(jpeg_dir), "-v", "-o", str(tmp_path)])
    assert "Visualize: " in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["im0.jpg", "im1.jpg", "im2.jpg"]
    from orienmask_tpu_torch.config import coco_visualizer

    ref = JaxVisualizer(**{k: v for k, v in dict(coco_visualizer, conf_thresh=0.0).items()
                           if k != "type"})
    random.seed(5)
    for i, (image, detections, pad_info) in enumerate(drawn):
        src = cv2.cvtColor(cv2.imread(str(jpeg_dir / f"im{i}.jpg")), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(np.asarray(image), src)
        assert len(detections["bbox"]) > 0
        want = ref(detections, src.astype(np.float32), pad_info)
        written = tmp_path / f"im{i}.jpg"
        assert written.read_bytes() == cv2.imencode(".jpg", cv2.cvtColor(want, cv2.COLOR_RGB2BGR))[
            1].tobytes()
        np.testing.assert_array_equal(read_image(written),
                                      cv2.cvtColor(cv2.imread(str(written)), cv2.COLOR_BGR2RGB))


def test_video_output_writes_a_png_frame_each(inputs, jpeg_dir, tmp_path, capsys):
    """--video <JPEG frames> -o <dir>: frame_%06d.jpg, one JPEG a frame, as
    the JAX CLI writes them."""
    _run_main(["-c", str(_config_with_visualizer(inputs)), "--random-weights", "--video",
               str(jpeg_dir), "-o", str(tmp_path), "--stream-depth", "2"])
    assert "Streamed 3 frames (depth=2)" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"frame_{i:06d}.jpg" for i in range(3)]
    for path in tmp_path.iterdir():
        assert path.read_bytes()[:4] == b"\xff\xd8\xff\xe0"
        assert cv2.imread(str(path)).shape == (96, 128, 3)


def test_visualize_writes_each_input_name_in_its_format(inputs, tmp_path):
    """-v -o over .jpg, .bmp, .tif, .png and .npy inputs (96x128, the slim
    model, on the CPU): each drawing under its input's own name, in that
    name's format, the bytes cv2.imwrite writes for the drawing (JPEG, BMP,
    PNG's pixels; TIFF read back to them by cv2 and the port); an .npy
    input, the port's own form, drawn to .png."""
    from orienmask_tpu_torch.data.image_io import read_image

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(10)
    for name in ("a.jpg", "b.bmp", "c.tif", "d.png"):
        cv2.imwrite(str(images / name), rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    np.save(images / "e.npy", rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    written = []
    real = infer.write_image

    def keep(path, image):
        written.append((os.path.basename(path), image.copy()))
        real(path, image)

    out = tmp_path / "out"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(infer, "write_image", keep)
        _run_main(["-c", str(_config_with_visualizer(inputs, 0.0)), "--random-weights", "-d",
                   str(images), "-v", "-o", str(out)])
    names = ["a.jpg", "b.bmp", "c.tif", "d.png", "e.png"]
    assert sorted(p.name for p in out.iterdir()) == names == [n for n, _ in written]
    for name, drawing in written:
        bgr = cv2.cvtColor(drawing, cv2.COLOR_RGB2BGR)
        data = (out / name).read_bytes()
        if name.endswith((".jpg", ".bmp")):
            assert data == cv2.imencode(os.path.splitext(name)[1], bgr)[1].tobytes(), name
        else:
            np.testing.assert_array_equal(cv2.imread(str(out / name)), bgr)
            np.testing.assert_array_equal(read_image(out / name), drawing)
    assert (out / "c.tif").read_bytes()[:4] == b"II*\x00"


def test_show_without_matplotlib_exits_with_its_message(inputs, monkeypatch):
    """-v -s where matplotlib is missing (the card's machine): the exit
    names it, before any model is built."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(SystemExit) as err:
        infer.main(["--device", "cpu", "-c", str(inputs / "config.json"), "--random-weights",
                    "-i", "x.png", "-v", "-s"])
    assert "matplotlib" in str(err.value.code)


def test_json_without_output_warns(inputs, capsys, tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.chdir(tmp_path)  # the empty dumps go to the working directory
    infer.main(["--device", "cpu", "-c", str(inputs / "config.json"), "--random-weights",
                "-d", str(inputs / "images"), "-j", str(inputs / "images.json"), "-n", "1"])
    assert "WARNING: -j without -o" in capsys.readouterr().out
    assert json.loads((tmp_path / "bbox_prediction.json").read_text()) == []


def test_class_tables_match_jax():
    from orienmask_tpu.data.dataset import COCODataset as JaxCOCO
    from orienmask_tpu.data.dataset import VOCDataset as JaxVOC
    from orienmask_tpu_torch.data.dataset import COCODataset, VOCDataset

    for port, ref in ((COCODataset, JaxCOCO), (VOCDataset, JaxVOC)):
        assert port.CAT2LABEL == ref.CAT2LABEL and port.CLASSES == ref.CLASSES


def test_profile_writes_a_trace_of_the_main_loop(inputs, tmp_path, capsys):
    torch.set_num_threads(1)
    infer.main(["--device", "cpu", "-c", str(inputs / "config.json"), "--random-weights",
                "-i", str(inputs / "images" / "im0.png"), "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    assert "Self CPU" in (tmp_path / "prof" / "ops.txt").read_text()
