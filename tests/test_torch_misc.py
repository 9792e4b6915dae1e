"""The port's small leftovers against orienmask_tpu's: ``models/summary.py``
(parameter counts, BatchNorm statistics and output shapes, printed alike),
``utils/debug.py`` (finite checks; torch's anomaly mode stands in for
``jax_debug_nans``) and ``data/collate.py::collate_plus``, also as the
builder's collate."""

import copy

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.data.collate import collate_plus as jax_collate_plus
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.summary import model_summary as jax_model_summary
from orienmask_tpu.trainer.builder import build_dataloader as jax_build_dataloader
from orienmask_tpu.utils.debug import assert_finite_tree as jax_assert_finite_tree
from orienmask_tpu_torch.data import collate_plus
from orienmask_tpu_torch.models import OrienMaskYOLOFPNPlus, init_random
from orienmask_tpu_torch.models.summary import model_summary
from orienmask_tpu_torch.trainer.builder import build_dataloader
from orienmask_tpu_torch.utils.debug import assert_finite_tree, checked, enable_nan_debugging
from orienmask_tpu_torch.utils.mini_dataset import mini_config, write_mini_dataset

SLIM = (1, 1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _summaries(port_model, jax_model, shape):
    lines = {"port": [], "jax": []}
    got = model_summary(port_model, shape, print_fn=lines["port"].append)
    want = jax_model_summary(jax_model, shape, print_fn=lines["jax"].append)
    return got, want, lines


def test_model_summary_matches_jax_on_the_slim_model():
    got, want, lines = _summaries(OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM),
                                  JaxModel(num_anchors=3, num_classes=80,
                                           backbone_stage_blocks=SLIM), (2, 128, 160, 3))
    assert got["params"] == want["params"] and got["batch_stats"] == want["batch_stats"]
    assert got["outputs"] == jax.tree_util.tree_map(tuple, want["outputs"],
                                                    is_leaf=lambda x: isinstance(x, tuple)
                                                    and all(isinstance(v, int) for v in x))
    assert got["outputs"][0] == ((2, 4, 5, 255), (2, 32, 40, 6))
    assert lines["port"] == lines["jax"]  # per-module counts, totals, shapes


def test_model_summary_full_width(capsys):
    """The published model at 544² (``tests/test_misc.py``'s case), shapes
    only: the forward runs on the meta device."""
    model = init_random(OrienMaskYOLOFPNPlus(3, 80), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    info = model_summary(model, (1, 544, 544, 3))
    out = capsys.readouterr().out
    assert "backbone" in out and "orien_head" in out
    assert info["params"] > 40_000_000
    assert info["outputs"][0][0] == (1, 17, 17, 255)
    assert info["outputs"][2][1] == (1, 136, 136, 6)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) and after[k].device.type == "cpu"
               for k in before)


def test_assert_finite_tree_matches_jax():
    assert_finite_tree({"a": np.ones(3), "b": [torch.ones(2, dtype=torch.bfloat16)]})
    bad = {"a": np.ones(3), "b": np.array([1.0, np.nan, np.inf, np.inf], np.float32)}
    with pytest.raises(FloatingPointError) as want:
        jax_assert_finite_tree(bad, "params")
    with pytest.raises(FloatingPointError) as got:
        assert_finite_tree(bad, "params")
    assert str(got.value) == str(want.value) == \
        "params: leaf 1 contains non-finite values (nan=1, inf=2)"
    with pytest.raises(FloatingPointError, match="leaf 0"):
        assert_finite_tree([torch.tensor([float("nan")], dtype=torch.bfloat16)])


def test_checked_reports_non_finite_outputs():
    def step(x):
        return {"loss": x.log(), "count": torch.tensor(3)}

    error, out = checked(step)(torch.tensor([1.0, 2.0]))
    assert error.get() is None and torch.equal(out["count"], torch.tensor(3))
    error.throw()  # nothing to raise

    error, out = checked(step)(torch.tensor([0.0, -1.0]))
    assert out["loss"].isinf().any() and out["loss"].isnan().any()
    assert error.get() == "step: non-finite values in output leaf 0 (nan=1, inf=1)"
    with pytest.raises(FloatingPointError, match="output leaf 0"):
        error.throw()


def test_nan_debugging_raises_at_the_backward():
    enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        y = torch.sqrt(x)
        with pytest.raises(RuntimeError, match="returned nan"):
            y.sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def _batch():
    """``tests/test_misc.py::test_collate_plus_pads_batch``'s batch."""
    rng = np.random.default_rng(0)
    batch = []
    for h, w in [(60, 90), (100, 40)]:
        batch.append({
            "image": rng.standard_normal((h, w, 3)).astype(np.float32),
            "bbox": np.array([[0.5, 0.5, 0.5, 0.5]], np.float32),
            "cls": np.array([1]),
            "mask": np.ones((1, h, w), bool),
            "info": {"id": 0, "height": h, "width": w},
        })
    return batch


@pytest.mark.parametrize("pack_masks", [False, True])
def test_collate_plus_matches_jax(pack_masks):
    batch = _batch()
    got = collate_plus(copy.deepcopy(batch), max_instances=4, pack_masks=pack_masks,
                       size_divisor=32)
    want = jax_collate_plus(copy.deepcopy(batch), max_instances=4, pack_masks=pack_masks,
                            size_divisor=32)
    assert got.keys() == want.keys()
    for key in got:
        if key == "info":
            assert got[key] == want[key]
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["image"].shape == (2, 128, 96, 3)
    assert [i["collate_pad"] for i in got["info"]] == [(3, 3, 34, 34, 128, 96),
                                                       (28, 28, 14, 14, 128, 96)]
    assert got["bbox"][got["valid"]].max() <= 1.0


@pytest.fixture(scope="module")
def loader_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini")
    paths = write_mini_dataset(root, 6, ((48, 64), (43, 61)), seed=0)
    loader = {"batch_size": 3, "num_workers": 0, "max_instances": 6}
    cfg = mini_config(paths, root / "runs", size=64, val_loader=loader)["val_loader"]
    return dict(cfg, collate={"type": "collate_plus", "size_divisor": 32})


def test_builder_builds_collate_plus(loader_config):
    got, want = list(build_dataloader(loader_config)), list(jax_build_dataloader(loader_config))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["info"] == w["info"] and all("collate_pad" in i for i in g["info"])
        np.testing.assert_allclose(g["image"], w["image"], rtol=0, atol=1e-6)
        for key in ("bbox", "cls", "valid", "mask"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_builder_refuses_image_transport_with_collate_plus(loader_config):
    cfg = dict(loader_config, image_transport="uint8")
    with pytest.raises(ValueError, match="requires collate type 'collate'") as want:
        jax_build_dataloader(cfg)
    with pytest.raises(ValueError, match="requires collate type 'collate'") as got:
        build_dataloader(cfg)
    assert str(got.value) == str(want.value)
