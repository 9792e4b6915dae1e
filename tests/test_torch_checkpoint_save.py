"""The save side of the port's checkpoints (orienmask_tpu_torch/trainer/
checkpoint.py, models/convert.py::variables_to_jax) and the pretrained
backbone load (models/convert.py::load_pretrained_backbone) against
orienmask_tpu's, at the slim depth (stage blocks (1, 1, 1, 1, 1)).

* A ``.ckpt`` the port writes is, read by the JAX package's
  ``load_checkpoint``, a pytree of the JAX init's structure, dtypes and
  shapes holding the port's values; one the JAX package writes loads into
  the port's model and SGD equal by bits.  Resuming and the next step's
  loss across the packages are in ``test_torch_trainer.py``.
* ``CheckpointManager`` names and links files as the JAX one does, writes
  the same bytes asynchronously, and re-raises a failed write.
* ``load_pretrained_backbone``: the same parameters and statistics as
  JAX's from a ``.pth`` the test writes (bare, under ``state_dict``, keys
  with ``backbone.``), the same messages for a missing file or key; a key
  of another shape raises.  The builder's ``build_model`` reads
  ``pretrained``."""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel
from orienmask_tpu.models.convert import load_pretrained_backbone as jax_load_pretrained
from orienmask_tpu.models.convert import variables_to_torch
from orienmask_tpu.optim import SGD as JaxSGD
from orienmask_tpu.trainer.checkpoint import load_checkpoint as jax_load_checkpoint
from orienmask_tpu.trainer.checkpoint import save_checkpoint as jax_save_checkpoint
from orienmask_tpu_torch.models import (
    OrienMaskYOLOFPNPlus,
    load_pretrained_backbone,
    variables_from_jax,
    variables_to_jax,
)
from orienmask_tpu_torch.optim import SGD
from orienmask_tpu_torch.trainer import builder
from orienmask_tpu_torch.trainer.checkpoint import (
    CheckpointManager,
    checkpoint_state,
    load_checkpoint,
    load_optimizer_state,
    save_checkpoint,
)

SLIM = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX slim model, its seeded variables and SGD state (numpy)."""
    torch.set_num_threads(1)
    jm = JaxModel(num_anchors=3, num_classes=80, backbone_stage_blocks=SLIM)
    v = jax.tree_util.tree_map(np.asarray, jm.init_variables(jax.random.PRNGKey(0)))
    opt = jax.tree_util.tree_map(np.asarray, JaxSGD(lr=1e-3, momentum=0.9).init(v["params"]))
    return jm, v, opt


@pytest.fixture(autouse=True)
def _remove_files(tmp_path):
    """A checkpoint of the published widths takes about 280 MB: each test's
    files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _port(variables=None):
    torch.set_num_threads(1)
    pm = OrienMaskYOLOFPNPlus(3, 80, backbone_stage_blocks=SLIM)
    if variables is not None:
        pm.load_state_dict(variables_from_jax(pm, variables), strict=True)
    return pm, SGD(pm.parameters(), lr=1e-3, momentum=0.9, weight_decay=5e-4)


def _numbered(tree, seed):
    """``tree`` with every float leaf replaced by seeded values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype)
        if a.dtype == np.float32 else a, tree)


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_variables_to_jax_is_the_inverse(jax_init):
    _, v, _ = jax_init
    v = _numbered(v, 1)
    pm, _ = _port(v)
    _assert_trees_equal(jax.tree_util.tree_map(lambda t: t.numpy(), variables_to_jax(pm)), v)


def test_port_checkpoint_reads_as_a_jax_one(jax_init, tmp_path):
    """Written after one update (momentum and counter set), read by JAX."""
    _, v, opt = jax_init
    pm, sgd = _port(_numbered(v, 2))
    sgd.apply([torch.randn_like(p) for p in sgd.params], 1e-3)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, dict(checkpoint_state(pm, sgd), epoch=3, monitor_best=0.5,
                               config={"name": "x"}))
    got = jax_load_checkpoint(path)
    assert (got["epoch"], got["monitor_best"], got["config"]) == (3, 0.5, {"name": "x"})
    want = jax.tree_util.tree_map(lambda t: t.numpy(), checkpoint_state(pm, sgd))
    _assert_trees_equal({k: got[k] for k in want}, want)
    _assert_trees_equal(jax.tree_util.tree_map(lambda a: np.zeros_like(a), got["opt_state"]),
                        jax.tree_util.tree_map(lambda a: np.zeros_like(a), opt))
    _assert_trees_equal(jax.tree_util.tree_map(np.zeros_like, got["params"]),
                        jax.tree_util.tree_map(np.zeros_like, v["params"]))
    assert int(got["opt_state"]["step"]) == 1 and got["opt_state"]["step"].dtype == np.int32


def test_jax_checkpoint_loads_into_the_port(jax_init, tmp_path):
    _, v, opt = jax_init
    v, opt = _numbered(v, 3), dict(_numbered(opt, 4), step=np.asarray(7, np.int32))
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, {"epoch": 2, "params": v["params"], "batch_stats": v["batch_stats"],
                               "opt_state": opt, "monitor_best": 0.25, "config": {"n": 1}})
    pm, sgd = _port()
    meta = load_checkpoint(path, pm)
    load_optimizer_state(pm, sgd, meta["opt_state"])
    assert meta["epoch"] == 2 and meta["monitor_best"] == 0.25
    state = jax.tree_util.tree_map(lambda t: t.numpy(), checkpoint_state(pm, sgd))
    _assert_trees_equal(state, {"params": v["params"], "batch_stats": v["batch_stats"],
                                "opt_state": opt})


def _state(value):
    return {"params": {"w": torch.full((2, 3), float(value))},
            "opt_state": {"step": torch.tensor(value, dtype=torch.int32)}, "epoch": value}


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_names_files_as_jax_does(tmp_path, async_save):
    manager = CheckpointManager(str(tmp_path), save_freq=2, async_save=async_save)
    manager.save(1, _state(1))  # not a save epoch: nothing
    manager.save(2, _state(2))
    manager.save(3, _state(3), save_best=True)
    manager.save(4, _state(4), save_best=True)  # removes best_epoch3
    manager.save(5, _state(5), temp=True)
    manager.wait()
    assert sorted(os.listdir(tmp_path)) == ["best_epoch4.ckpt", "best_model.ckpt",
                                            "epoch2.ckpt", "epoch4.ckpt", "temp.ckpt"]
    assert os.readlink(tmp_path / "best_model.ckpt") == "best_epoch4.ckpt"
    for name, epoch in (("epoch2.ckpt", 2), ("best_model.ckpt", 4), ("temp.ckpt", 5)):
        with open(tmp_path / name, "rb") as fh:
            got = pickle.load(fh)
        assert got["epoch"] == epoch and got["params"]["w"].dtype == np.float32
        np.testing.assert_array_equal(got["params"]["w"], np.full((2, 3), epoch, np.float32))
        assert got["opt_state"]["step"].dtype == np.int32


def test_async_save_writes_what_sync_writes_and_reraises(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    for sub, async_save in (("a", False), ("b", True)):
        manager = CheckpointManager(str(tmp_path / sub), 1, async_save=async_save)
        manager.save(1, _state(1))
        manager.wait()
    assert (tmp_path / "a" / "epoch1.ckpt").read_bytes() == \
        (tmp_path / "b" / "epoch1.ckpt").read_bytes()
    manager = CheckpointManager(str(tmp_path / "missing"), 1, async_save=True)
    manager.save(1, _state(1))
    with pytest.raises(FileNotFoundError):
        manager.wait()


def _pretrained_files(jm, v, tmp_path):
    """The backbone's weights as .pth files: bare, under ``state_dict`` and
    with ``backbone.`` keys (a whole model's state dict)."""
    full = {k: torch.tensor(np.asarray(a)) for k, a in variables_to_torch(jm, v).items()}
    bare = {k[len("backbone."):]: t for k, t in full.items() if k.startswith("backbone.")}
    files = {"bare": bare, "wrapped": {"state_dict": bare}, "prefixed": full}
    for name, sd in files.items():
        torch.save(sd, tmp_path / f"{name}.pth")
    return files


@pytest.mark.parametrize("form", ["bare", "wrapped", "prefixed"])
def test_pretrained_backbone_matches_jax(jax_init, tmp_path, form, capsys):
    jm, v, _ = jax_init
    _pretrained_files(jm, _numbered(v, 5), tmp_path)
    path = str(tmp_path / f"{form}.pth")
    params, stats = jax_load_pretrained(jm, v["params"], v["batch_stats"], path)
    want_msg = capsys.readouterr().out
    pm, _ = _port(v)
    load_pretrained_backbone(pm, path)
    assert capsys.readouterr().out == want_msg == \
        f"[DarkNet53] loaded pretrained backbone from {path}\n"
    got = jax.tree_util.tree_map(lambda t: t.numpy(), variables_to_jax(pm))
    _assert_trees_equal(got, jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}))


def test_pretrained_missing_file_and_key_skip_as_jax_does(jax_init, tmp_path, capsys):
    jm, v, _ = jax_init
    files = _pretrained_files(jm, v, tmp_path)
    partial = dict(files["bare"])
    del partial["conv3.0.conv_block.1.running_var"]
    torch.save(partial, tmp_path / "partial.pth")
    pm, _ = _port(_numbered(v, 6))
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    for name in ("absent.pth", "partial.pth"):
        path = str(tmp_path / name)
        jax_load_pretrained(jm, v["params"], v["batch_stats"], path)
        want = capsys.readouterr().out
        load_pretrained_backbone(pm, path)
        assert capsys.readouterr().out == want and "skipping" in want
    for k, t in pm.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_pretrained_key_of_another_shape_raises(jax_init, tmp_path):
    jm, v, _ = jax_init
    sd = dict(_pretrained_files(jm, v, tmp_path)["bare"])
    sd["conv1.conv_block.0.weight"] = torch.zeros(32, 3, 1, 1)
    torch.save(sd, tmp_path / "shape.pth")
    pm, _ = _port()
    with pytest.raises(ValueError, match="conv1.conv_block.0.weight has shape"):
        load_pretrained_backbone(pm, str(tmp_path / "shape.pth"))


def test_builder_reads_pretrained(jax_init, tmp_path, capsys):
    jm, v, _ = jax_init
    _pretrained_files(jm, _numbered(v, 7), tmp_path)
    cfg = {"type": "OrienMaskYOLOFPNPlus", "num_anchors": 3, "num_classes": 80,
           "backbone_stage_blocks": list(SLIM), "pretrained": str(tmp_path / "bare.pth")}
    model = builder.build_model(cfg)
    want = torch.load(tmp_path / "bare.pth")
    for k, t in model.backbone.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(t, want[k]), k
    seeded = builder.build_model(cfg, ignore_pretrained=True)
    assert not torch.equal(seeded.backbone.conv1.conv_block[0].weight,
                           want["conv1.conv_block.0.weight"])
    builder.build_model(dict(cfg, pretrained=str(tmp_path / "absent.pth")))
    assert "pretrained file not found, skipping" in capsys.readouterr().out
