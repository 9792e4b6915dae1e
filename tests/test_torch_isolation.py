"""The port stands alone: no JAX and nothing of orienmask_tpu in its sources
or in chip_smoke.py, none of the host packages the card's machine lacks
(cv2, PIL, tabulate, tqdm; pycocotools and tensorboardX only inside a
guarded function), it imports with JAX, cv2, PIL and matplotlib made
unimportable (the JPEG decoder, the visualizer, the native host library's
bindings, the mask recovery, the data path and the trainer among it), and
it never moves to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orienmask_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "orienmask_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(nodes):
    """(node, module name) of every absolute import among ``nodes``."""
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from ((node, alias.name) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module


def _imported_modules(path):
    return [name for _, name in _imports(ast.walk(ast.parse(path.read_text(),
                                                            filename=str(path))))]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_neither_jax_nor_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "orienmask_tpu"), f"{path.name} imports {name}"


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_no_host_package_the_card_machine_lacks(path):
    """cv2, PIL, tabulate and tqdm nowhere; pycocotools and tensorboardX only
    inside functions, one of which imports each inside a ``try``
    (``coco_eval._try_pycocotools``, ``trainer/base.py::tensorboard_writer``)."""
    for name in _imported_modules(path):
        assert name.split(".")[0] not in ("cv2", "PIL", "tabulate", "tqdm"), \
            f"{path.name} imports {name}"
    tree = ast.parse(path.read_text(), filename=str(path))
    in_functions = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                    for n in ast.walk(f)}
    in_try = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try) for n in ast.walk(t)}
    for package in ("pycocotools", "tensorboardX"):
        nodes = [node for node, name in _imports(ast.walk(tree)) if name.startswith(package)]
        assert all(id(n) in in_functions for n in nodes), f"{path.name}: {package} at module level"
        assert not nodes or any(id(n) in in_try for n in nodes), \
            f"{path.name}: unguarded {package}"


def test_pipeline_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['orienmask_tpu'] = None\n"
            "for m in ('cv2', 'PIL', 'tabulate', 'tqdm', 'pycocotools', 'matplotlib'): "
            "sys.modules[m] = None\n"
            "import orienmask_tpu_torch.pipeline, orienmask_tpu_torch.ops, "
            "orienmask_tpu_torch.models, orienmask_tpu_torch.data, "
            "orienmask_tpu_torch.optim, orienmask_tpu_torch.trainer, "
            "orienmask_tpu_torch.eval, orienmask_tpu_torch.utils.timer, "
            "orienmask_tpu_torch.infer, orienmask_tpu_torch.stream, "
            "orienmask_tpu_torch.utils.profiler, orienmask_tpu_torch.data.image_io, "
            "orienmask_tpu_torch.data.jpeg, orienmask_tpu_torch.utils.visualizer, "
            "orienmask_tpu_torch.native, orienmask_tpu_torch.ops.recover, "
            "orienmask_tpu_torch.ops.resize, orienmask_tpu_torch.ops.int8_conv, "
            "orienmask_tpu_torch.models.quantize, orienmask_tpu_torch.optim.param_groups, "
            "orienmask_tpu_torch.models.resnet, orienmask_tpu_torch.parallel.spatial\n"
            "from orienmask_tpu_torch.utils.visualizer import InferenceVisualizer\n"
            "InferenceVisualizer('COCO')\n"
            "assert not any(m.split('.')[0] in ('jax', 'orienmask_tpu') "
            "for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_modules_import_with_jax_and_host_packages_blocked():
    """The file-backed data path, the trainer, its checkpoints and the train
    and test CLIs import with JAX, orienmask_tpu, cv2, PIL, tabulate, tqdm
    and tensorboardX unimportable, and the trainer then logs no scalars."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'orienmask_tpu', 'cv2', 'PIL', 'tabulate', 'tqdm', "
            "'tensorboardX', 'pycocotools'): sys.modules[m] = None\n"
            "import orienmask_tpu_torch.data.transform, orienmask_tpu_torch.data.dataset, "
            "orienmask_tpu_torch.data.dataloader, orienmask_tpu_torch.eval.counter, "
            "orienmask_tpu_torch.trainer.base, orienmask_tpu_torch.trainer.trainer, "
            "orienmask_tpu_torch.trainer.builder, orienmask_tpu_torch.trainer.checkpoint, "
            "orienmask_tpu_torch.utils.prepare_dataset, orienmask_tpu_torch.utils.mini_dataset, "
            "orienmask_tpu_torch.train, orienmask_tpu_torch.test\n"
            "from orienmask_tpu_torch.trainer.base import tensorboard_writer\n"
            "assert tensorboard_writer('.') is None\n"
            "assert not any(m.split('.')[0] in ('jax', 'orienmask_tpu') "
            "for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_postprocess_and_pipeline_default_to_the_card(monkeypatch):
    """Entry points built without ``device`` ask for the card and raise here."""
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OrienMaskYOLOPostProcess(**kw)


def test_infer_cli_and_stream_default_to_the_card(monkeypatch):
    """The CLI's ``--device`` defaults to ``cuda`` and raises here before
    anything is built; ``InferencePipeline`` and ``StreamingPipeline``
    without ``device`` ask for the card too."""
    from orienmask_tpu_torch import infer
    from orienmask_tpu_torch.pipeline import InferencePipeline
    from orienmask_tpu_torch.stream import StreamingPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["-c", "orienmask_yolo_coco_544_anchor4_fpn_plus_infer",
                    "--random-weights", "-i", "x.png"])

    class OnTheCpu:
        device = torch.device("cpu")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingPipeline(OnTheCpu())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferencePipeline(None, None, OnTheCpu())


def test_loss_and_train_step_default_to_the_card(monkeypatch):
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as cfg
    from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus
    from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
    from orienmask_tpu_torch.optim import SGD
    from orienmask_tpu_torch.trainer import make_eval_step, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {k: v for k, v in cfg["loss"].items() if k != "type"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OrienMaskYOLOMultiScaleLoss(**kw)
    loss = OrienMaskYOLOMultiScaleLoss(**kw, device="cpu")
    model = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=(1, 1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, loss, SGD(model.parameters(), 1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(model, loss)


def test_wrappers_refuse_other_devices():
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks,
        assemble_masks_bitpacked,
        assemble_masks_packed,
    )
    from orienmask_tpu_torch.ops.paint import paint_orientation
    from orienmask_tpu_torch.ops.topk import exact_topk

    x = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exact_topk(x, 4)
    field = torch.zeros(1, 1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        assemble_masks_packed(field, torch.zeros(1, 1, 4), torch.zeros(1, 1, dtype=torch.int32),
                              torch.zeros(1, 2))
    for fn in (assemble_masks, assemble_masks_bitpacked):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(field, torch.zeros(1, 1, 4), torch.zeros(1, 1, 2),
               torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        paint_orientation(torch.zeros(1, 2, 10, device="meta"),
                          torch.zeros(1, dtype=torch.int32, device="meta"),
                          torch.zeros(1, 2, 8, 1, dtype=torch.uint8, device="meta"),
                          [[4, 6]], (8, 8))


def test_serving_imports_without_model_code():
    """A serving host loads ``serving.py`` and the operator library with
    JAX, the JAX package, ``orienmask_tpu_torch.models`` and the host
    packages the card's machine lacks unimportable; the export CLI imports
    with JAX blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'orienmask_tpu', 'orienmask_tpu_torch.models', 'cv2', "
            "'PIL', 'tabulate', 'tqdm', 'pycocotools', 'matplotlib'): sys.modules[m] = None\n"
            "import orienmask_tpu_torch.serving, orienmask_tpu_torch.kernels.ops, "
            "orienmask_tpu_torch.ops.topk, orienmask_tpu_torch.ops.masks, "
            "orienmask_tpu_torch.ops.nms\n"
            "loaded = [m for m, v in sys.modules.items() if v is not None]\n"
            "assert not any(m.startswith(('orienmask_tpu_torch.models', "
            "'orienmask_tpu_torch.pipeline')) for m in loaded), loaded\n"
            "del sys.modules['orienmask_tpu_torch.models']\n"
            "import orienmask_tpu_torch.export_serving, orienmask_tpu_torch.models.summary, "
            "orienmask_tpu_torch.utils.debug\n"
            "from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess\n"
            "assert not any(m.split('.')[0] in ('jax', 'orienmask_tpu') "
            "for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serving_defaults_to_the_card(monkeypatch, tmp_path):
    from orienmask_tpu_torch import export_serving
    from orienmask_tpu_torch.serving import ServingModel, load_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (ServingModel, load_serving):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving.main(["-c", "orienmask_yolo_coco_544_anchor4_fpn_plus_infer"])
