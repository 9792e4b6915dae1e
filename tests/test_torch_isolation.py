"""The port stands alone: no JAX and nothing of orienmask_tpu in its sources
or in chip_smoke.py, it imports with JAX made unimportable, and it never
moves to the CPU on its own."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orienmask_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "orienmask_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_neither_jax_nor_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "orienmask_tpu"), f"{path.name} imports {name}"


def test_pipeline_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['orienmask_tpu'] = None\n"
            "import orienmask_tpu_torch.pipeline, orienmask_tpu_torch.ops, "
            "orienmask_tpu_torch.models, orienmask_tpu_torch.data, "
            "orienmask_tpu_torch.optim, orienmask_tpu_torch.trainer\n"
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
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed
    from orienmask_tpu_torch.ops.paint import paint_orientation
    from orienmask_tpu_torch.ops.topk import exact_topk

    x = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exact_topk(x, 4)
    field = torch.zeros(1, 1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        assemble_masks_packed(field, torch.zeros(1, 1, 4), torch.zeros(1, 1, dtype=torch.int32),
                              torch.zeros(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        paint_orientation(torch.zeros(1, 2, 10, device="meta"),
                          torch.zeros(1, dtype=torch.int32, device="meta"),
                          torch.zeros(1, 2, 8, 1, dtype=torch.uint8, device="meta"),
                          [[4, 6]], (8, 8))
