"""The port's Tester (orienmask_tpu_torch/trainer/tester.py) against
orienmask_tpu's on the same batches and weights, and the port's checkpoint
reader against files the JAX package and the reference layout write.

Slim depth (stage blocks (1, 1, 1, 1, 1)) at the published widths, 160²,
B = 2, f32, the test config's exact selection.  The bbox heads' final convs
are scaled by 1e5 with N(0, 1) biases, so the logits spread over about one
unit across positions instead of 1e-5: otherwise the scores tie to 1e-7 and
their order is f32 rounding.  JAX's masks go through the anchor-resident
Pallas kernel in interpret mode, as the port's do through its plain
version.  The ground truth is built from the port's own detections
(boxes and masks moved by one pixel), so the AP is neither 0 nor 1."""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.convert import variables_to_torch
from orienmask_tpu.models.layers import default_ctx
from orienmask_tpu.ops import pallas_masks
from orienmask_tpu.ops.postprocess import OrienMaskYOLOPostProcess as JaxPostProcess
from orienmask_tpu.optim import SGD as JaxSGD
from orienmask_tpu.trainer.checkpoint import save_checkpoint
from orienmask_tpu.trainer.tester import Tester as JaxTester
from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_test as cfg
from orienmask_tpu_torch.data import ArrayDataset, ArrayLoader, make_scenes
from orienmask_tpu_torch.eval import rle
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, variables_from_jax
from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
from orienmask_tpu_torch.trainer import Tester as PortTester  # not a test class
from orienmask_tpu_torch.trainer import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
SLIM = (1, 1, 1, 1, 1)
SIZE, B, N_IMAGES = 160, 2, 5  # the last batch is wrap-padded


def _postprocess_kwargs():
    kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    kw.update(grid_size=[[SIZE // 32] * 2, [SIZE // 16] * 2, [SIZE // 8] * 2],
              image_size=[SIZE, SIZE])
    return kw


def _jax_variables(jm, seed):
    """Seeded JAX init with the bbox heads' logits spread; numpy leaves."""
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bbox_head8", "bbox_head16", "bbox_head32"):
        conv = v["params"][name][1]
        conv["kernel"] = conv["kernel"] * np.float32(1e5)
        conv["bias"] = rng.standard_normal(conv["bias"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    variables = _jax_variables(jm, 0)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    images, infos, _ = make_scenes(np.random.default_rng(1), N_IMAGES, SIZE)
    dataset = ArrayDataset([f"class{c}" for c in range(80)], list(range(1, 81)))
    return jm, variables, pm, images, infos, dataset


def _ground_truth(pm, images, infos, dataset, path):
    """A COCO file of the port's first detections per image, each box and
    mask moved one pixel right."""
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    tester = PortTester(pm, None, pp, ArrayLoader(images, infos, B, dataset), ".", None,
                    device="cpu")
    anns = []
    for i in range(len(infos)):
        det = pp.to_host_list(pp.apply_device(tester.forward(torch.from_numpy(images[i:i + 1]))))[0]
        for box, m, c in list(zip(det["bbox"], det["mask"], det["cls"]))[:8]:
            x, y, w, h = (box[:4] * SIZE).tolist()
            m = np.roll(m, 1, axis=1).astype(np.uint8)
            if not m.any():
                continue
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": int(c) + 1,
                         "bbox": [x - w / 2 + 1, y - h / 2, w, h], "area": float(m.sum()),
                         "iscrowd": 0, "segmentation": rle.encode(m)})
    path.write_text(json.dumps({
        "images": [{"id": i["id"], "height": SIZE, "width": SIZE} for i in infos],
        "categories": [{"id": c} for c in range(1, 81)], "annotations": anns}))
    return len(anns)


def test_tester_matches_jax_tester(setup, tmp_path, capsys):
    jm, variables, pm, images, infos, dataset = setup
    gt_file = tmp_path / "gt.json"
    n_gt = _ground_truth(pm, images, infos, dataset, gt_file)
    assert n_gt >= 10

    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_masks, "assemble_masks_packed", functools.partial(
        pallas_masks.assemble_masks_anchor_resident, interpret=True))
    try:
        jpp = JaxPostProcess(**_postprocess_kwargs(), pack_masks=True)
        jpp.use_pallas_masks = True
        (tmp_path / "jax").mkdir()
        want = JaxTester(jm, variables, jpp, ArrayLoader(images, infos, B, dataset),
                         str(tmp_path / "jax"), str(gt_file))
        want.test()
    finally:
        mp.undo()
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    (tmp_path / "port").mkdir()
    got = PortTester(pm, None, pp, ArrayLoader(images, infos, B, dataset), str(tmp_path / "port"),
                 str(gt_file), device="cpu")
    got.test()
    out = capsys.readouterr().out
    for text in ("COCO eval bbox", "COCO eval segm", "Per-category segm AP",
                 "Speed Statistics (batch size = 2)", "Network Forward", "Postprocess",
                 "Convert Format", "To Host List", "COCO Boxes", "Mask Resize", "RLE Encode"):
        assert text in out, text

    gm, wm = got.coco_metrics, want.coco_metrics
    assert len(gm.bbox_results) == len(wm.bbox_results) > n_gt  # the _pad sample skipped
    assert {r["image_id"] for r in gm.bbox_results} == set(range(N_IMAGES))
    for key in ("bbox", "segm"):
        g = np.asarray(getattr(gm, f"{key}_eval_stats"))
        w = np.asarray(getattr(wm, f"{key}_eval_stats"))
        assert g.shape == (12,) and 0.2 < g[0] < 1.0, (key, g)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=key)
    assert got.coco_eval_seconds > 0
    assert (tmp_path / "port" / "segm_prediction.json").exists()


def test_jax_ckpt_loads_into_the_port(setup, tmp_path):
    """A .ckpt written by the JAX package's save_checkpoint (params, batch
    statistics, SGD state, config) loads into the port; the f32 folded
    forward then matches JAX's to 1e-4."""
    jm, variables, _, images, infos, dataset = setup
    path = str(tmp_path / "weights.ckpt")
    save_checkpoint(path, {"epoch": 3, "params": variables["params"],
                           "batch_stats": variables["batch_stats"],
                           "opt_state": JaxSGD(lr=1e-3, momentum=0.9).init(variables["params"]),
                           "monitor_best": 0.25, "config": {"name": "x"}})
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    meta = load_checkpoint(path, pm)
    assert meta["epoch"] == 3 and meta["config"] == {"name": "x"} and "params" not in meta

    x = images[:2].astype(np.float32) / np.float32(255.0)
    want = jax.jit(lambda f, x: jm.apply_folded(f, x, default_ctx(dtype=jnp.float32)))(
        jm.fold(variables), jnp.asarray(x))
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    tester = PortTester(pm, None, pp, ArrayLoader(images, infos, B, dataset), ".", None,
                    device="cpu")
    got = tester.forward(torch.from_numpy(images[:2]))
    for (wb, wo), (gb, go) in zip(want, got):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-4, atol=1e-4)

    # unpickling needs nothing of JAX: read it with jax made unimportable
    code = ("import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
            "sys.modules['orienmask_tpu'] = None\n"
            "from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus\n"
            "from orienmask_tpu_torch.trainer import load_checkpoint\n"
            "m = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=(1, 1, 1, 1, 1))\n"
            f"print(load_checkpoint({path!r}, m)['epoch'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "3", proc.stderr


def test_reference_pth_loads_into_the_port(setup, tmp_path):
    """A reference-layout .pth (JAX's variables_to_torch, under
    ``state_dict`` with epoch and config beside it, and bare) loads into
    the same weights as variables_from_jax."""
    jm, variables, pm, _, _, _ = setup
    sd = {k: torch.tensor(np.asarray(v)) for k, v in variables_to_torch(jm, variables).items()}
    wrapped, bare = tmp_path / "wrapped.pth", tmp_path / "bare.pth"
    torch.save({"state_dict": sd, "epoch": 7, "config": {"name": "y"}}, wrapped)
    torch.save(sd, bare)
    for path, meta_want in ((wrapped, {"epoch": 7, "config": {"name": "y"}}), (bare, {})):
        other = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
        assert load_checkpoint(path, other) == meta_want
        a, b = pm.state_dict(), other.state_dict()
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_tester_defaults_to_the_card(setup, monkeypatch):
    _, _, pm, images, infos, dataset = setup
    pp = OrienMaskYOLOPostProcess(**_postprocess_kwargs(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortTester(pm, None, pp, ArrayLoader(images, infos, B, dataset), ".", None)
