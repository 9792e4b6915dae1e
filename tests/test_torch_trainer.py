"""The port's Trainer (orienmask_tpu_torch/trainer/{base,trainer,builder}.py)
against orienmask_tpu's, from files, and checkpoints across the packages.

The port's mini dataset (8 seeded scenes at 48x64 and 43x61) and the
published train config at 64², slim depth (stage blocks (1, 1, 1, 1, 1)),
f32, B = 4: one epoch of 2 steps and a val epoch (2 batches, the last
wrap-padded), monitor "off" (no best checkpoint).  Both trainers start
from one seeded JAX init saved as a ``.ckpt`` (``-w``); JAX runs its master
stem, the port's.  The JAX Trainer
runs on a one-device mesh; its train step is the one JAX train-step compile
of the new test files.

* The first step's loss agrees to 1e-5.  Each step starts from the same
  state (the port takes JAX's state after step 1, as in
  ``test_torch_train_step.py``).  Both steps' logs, the epoch's train logs
  and the val epoch's losses and metrics agree to 2e-4 of their value (the
  train-step test's stated figure) or 2e-6 of the loss they add into.  At
  64² the deepest BatchNorms see 16 values a channel (64 at the train-step
  test's 128²) and amplify rounding more: the losses agree to 1.5e-5
  (measured 5.0e-6 at step 1, 1.46e-5 at step 2), but the wh terms, about
  1e-4 of the loss, differ by up to 1.6e-3 of themselves (S08_loss_wh
  0.0869, 2.8e-5 apart at step 1, 1.5e-4 at step 2).
* JAX-saved -> port-resumed: the port resumes JAX's ``epoch1.ckpt``
  (parameters, statistics, momentum and counter equal by bits; epoch and
  monitor's best) and its next train step's loss agrees with JAX's from
  the same state to 1e-5 (measured 3.2e-6).
* The val epoch on one JAX checkpoint whose objectness and class logits
  are spread (``_spread``; random weights tie the scores at f32
  rounding), resumed by each package: the COCO entries (ids, categories
  and RLE strings identical; boxes and scores to 1e-5), the 12-stat
  vectors (to 1e-12) and the val logs (as above).
* Port-saved -> JAX-resumed: JAX resumes the port's ``.ckpt`` with its
  state equal by bits to the port's, and the next step's losses agree to
  1e-5 (measured 7.1e-7)."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from orienmask_tpu.parallel.mesh import data_mesh, shard_batch
from orienmask_tpu.trainer import builder as jax_builder
from orienmask_tpu.trainer.checkpoint import save_checkpoint as jax_save_checkpoint
from orienmask_tpu.trainer.trainer import Trainer as JaxTrainer
from orienmask_tpu_torch.trainer.builder import build_dataloader, build_trainer
from orienmask_tpu_torch.trainer.checkpoint import (
    checkpoint_state,
    load_optimizer_state,
    load_state,
    read_checkpoint,
    save_checkpoint,
)
from orienmask_tpu_torch.utils.mini_dataset import mini_config, write_mini_dataset

SLIM = [1, 1, 1, 1, 1]
LOSS_RTOL, LOG_RTOL, LOG_ATOL_OF_LOSS = 1e-5, 2e-4, 2e-6


def _config(paths, log_dir):
    loader = {"batch_size": 4, "num_workers": 0, "max_instances": 8}
    # monitor "off": no best_epoch1.ckpt (at the published widths a checkpoint
    # takes about 280 MB; the train CLI tests check the best's naming)
    return mini_config(paths, log_dir, size=64, n_device=1, epochs=1, val_freq=1, save_freq=1,
                       log_freq=1, compute_dtype="float32", train_loader=loader,
                       val_loader=loader, monitor_mode="off",
                       model={"pretrained": None, "backbone_stage_blocks": SLIM})


def _spread(path, out):
    """The checkpoint at ``path`` with its objectness and class logits spread
    over about 0.01 across positions (x1e3) around N(0, 1) biases, so that
    the detections' scores do not tie at f32 rounding; written to ``out``."""
    ckpt = read_checkpoint(path)
    rng = np.random.default_rng(0)
    for name in ("bbox_head8", "bbox_head16", "bbox_head32"):
        conv = ckpt["params"][name][1]
        scores = np.arange(conv["bias"].shape[0]) % 85 >= 4
        conv["kernel"] = np.where(scores, conv["kernel"] * np.float32(1e3), conv["kernel"])
        conv["bias"] = np.where(scores, rng.standard_normal(conv["bias"].shape),
                                conv["bias"]).astype(np.float32)
    jax_save_checkpoint(out, ckpt)
    return out


def _jax_trainer(cfg, weights):
    """The JAX Trainer of ``cfg`` on a one-device mesh, its seeded init
    written to ``weights`` and loaded from there."""
    b = jax_builder
    train_loader = b.build_dataloader(dict(cfg["train_loader"], drop_last=True), seed=cfg["seed"])
    val_loader = b.build_dataloader(dict(cfg["val_loader"], pad_last=True), seed=cfg["seed"])
    model, variables = b.build_model(cfg["model"], True, seed=cfg["seed"])
    model.backbone.s2d_stem = False  # the port's stem
    jax_save_checkpoint(weights, jax.tree_util.tree_map(np.asarray, variables))
    return JaxTrainer(model, b.build(cfg["loss"], b.loss_module),
                      b.build_optimizer(cfg["optimizer"], model, variables["params"]),
                      b.build_lr_scheduler(cfg["lr_scheduler"], cfg["optimizer"]["lr"]),
                      cfg, train_loader, val_loader, b.build_postprocess(cfg["postprocess"]),
                      data_mesh(n_devices=1), variables, weights=weights)


def _host_state(state):
    return jax.tree_util.tree_map(
        np.asarray, {k: state[k] for k in ("params", "batch_stats", "opt_state")})


def _record_jax(jt):
    """Wrap JAX's train step and epoch: their logs, and the state after
    each step."""
    steps, states, epochs = [], [], []
    step, epoch = jt.train_step, jt._train_epoch

    def train_step(*args):
        state, log = step(*args)
        steps.append({k: float(np.asarray(v)) for k, v in log.items()})
        states.append(_host_state(state))
        return state, log

    def train_epoch(e):
        epochs.append(epoch(e))
        return epochs[-1]

    jt.train_step, jt._train_epoch = train_step, train_epoch
    return steps, states, epochs


def _record_port(trainer, jax_states):
    """Wrap the port's train step and epoch: each step after the first
    starts from JAX's state after the step before, as in
    ``test_torch_train_step.py`` (a step's rounding would otherwise carry
    into the next, amplified by the update)."""
    steps, epochs = [], []
    step, epoch = trainer.train_step, trainer._train_epoch

    def train_step(*args):
        if steps:
            state = jax_states[len(steps) - 1]
            load_state(trainer.model, state)
            load_optimizer_state(trainer.model, trainer.optimizer, state["opt_state"])
        steps.append({k: float(v) for k, v in step(*args).items()})
        return steps[-1]

    def train_epoch(e):
        epochs.append(epoch(e))
        return epochs[-1]

    trainer.train_step, trainer._train_epoch = train_step, train_epoch
    return steps, epochs


def _jax_step(jt, batch, lr):
    sharded = shard_batch(batch, jt.mesh)
    sharded.pop("info", None)
    jt.state, log = jt.train_step(jt.state, sharded, lr, True)
    return float(np.asarray(log["loss"]))


def _port_jax_state(trainer):
    """The port's train state in the JAX layout, numpy leaves."""
    return jax.tree_util.tree_map(lambda t: t.numpy(),
                                  checkpoint_state(trainer.model, trainer.optimizer))


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = np.ascontiguousarray(g), np.ascontiguousarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def _coco(trainer):
    m = trainer.coco_metrics
    return ({k: list(getattr(m, f"{k}_results")) for k in ("bbox", "segm")},
            {k: np.asarray(getattr(m, f"{k}_eval_stats")) for k in ("bbox", "segm")})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both trainers' epoch, then the cross-package resumptions, in order;
    each checkpoint is removed once read, the rest at the end."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("trainer")
    yield _scenario(root)
    shutil.rmtree(root, ignore_errors=True)


def _scenario(root):
    paths = write_mini_dataset(root, 8, ((48, 64), (43, 61)), seed=0)
    weights = str(root / "init.ckpt")
    out = {}

    jt = _jax_trainer(_config(paths, root / "jax_runs"), weights)
    out["jax_steps"], jax_states, out["jax_epochs"] = _record_jax(jt)
    jt.train()
    jax_ckpt = os.path.join(jt.checkpoint_dir, "epoch1.ckpt")
    out["jax_state"] = _host_state(jt.state)
    out["jax_best"] = jt.monitor_best

    port = build_trainer(_config(paths, root / "port_runs"), weights=weights, device="cpu")
    os.remove(weights)
    out["port_steps"], out["port_epochs"] = _record_port(port, jax_states)
    port.train()
    out["port_names"] = set(os.listdir(port.checkpoint_dir))
    out["port_log"] = open(os.path.join(port.checkpoint_dir, "train.log")).read()
    os.remove(os.path.join(port.checkpoint_dir, "epoch1.ckpt"))

    # JAX-saved -> port-resumed: the state, then the next step on one batch
    resumed = build_trainer(_config(paths, root / "port_runs"), resume=jax_ckpt, device="cpu")
    out["resumed_epoch"], out["resumed_best"] = resumed.start_epoch, resumed.monitor_best
    out["resumed_state"] = _port_jax_state(resumed)
    loader = build_dataloader(dict(resumed.config["train_loader"], drop_last=True))
    loader.set_epoch(2)
    batch_x, batch_y = list(loader)
    lr = resumed.lr_scheduler(3)
    out["next"] = (float(resumed.train_step(batch_x, lr)["loss"]), _jax_step(jt, batch_x, lr))

    # port-saved -> JAX-resumed
    path = str(root / "port.ckpt")
    save_checkpoint(path, resumed._checkpoint_state(1))
    jt._resume_checkpoint(path)
    os.remove(path)
    out["jax_resumed_state"] = _host_state(jt.state)
    out["port_state_saved"] = _port_jax_state(resumed)
    lr = resumed.lr_scheduler(4)
    out["after"] = (float(resumed.train_step(batch_y, lr)["loss"]), _jax_step(jt, batch_y, lr))

    # the val epoch of each package on one JAX checkpoint with spread scores
    spread = _spread(jax_ckpt, str(root / "spread.ckpt"))
    os.remove(jax_ckpt)
    jt._resume_checkpoint(spread)
    out["jax_val"] = jt._val_epoch(1)
    out["jax_coco"] = _coco(jt)
    port_val = build_trainer(_config(paths, root / "port_runs"), resume=spread, device="cpu")
    out["port_val"] = port_val._val_epoch(1)
    out["port_coco"] = _coco(port_val)
    os.remove(spread)
    return out


def _assert_logs_close(got, want, loss_key, keys=None):
    """Each log within LOG_RTOL of its value or LOG_ATOL_OF_LOSS of the loss
    it adds into."""
    assert got.keys() == want.keys()
    atol = LOG_ATOL_OF_LOSS * abs(want[loss_key])
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOG_RTOL, atol=atol, err_msg=k)


def test_first_step_loss_matches_jax(run):
    got, want = run["port_steps"], run["jax_steps"][:2]  # then come the resumed steps
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("step", [0, 1])
def test_step_logs_match_jax(run, step):
    _assert_logs_close(run["port_steps"][step], run["jax_steps"][step], "loss")


def test_epoch_logs_match_jax(run):
    """The epoch's train logs (the mean of its steps) and the val losses and
    metrics, each package's on its own weights after the 2 steps."""
    (got,), (want,) = run["port_epochs"], run["jax_epochs"]
    _assert_logs_close(got, want, "train_loss", [k for k in want if k.startswith("train_")])
    _assert_logs_close(got, want, "val_loss", [k for k in want if k.startswith("val_")
                                               and "AP" not in k and "AR" not in k])


def test_run_directory_and_checkpoints(run):
    assert {"config.json", "train.log", "epoch1.ckpt", "bbox_prediction.json",
            "segm_prediction.json"} <= run["port_names"]
    assert not any(n.startswith("best") for n in run["port_names"])  # monitor "off"
    assert "[EPOCH 1]" in run["port_log"] and "| TRAIN" in run["port_log"]


def test_port_resumes_a_jax_checkpoint(run):
    assert run["resumed_epoch"] == 2 and run["resumed_best"] == run["jax_best"]
    _assert_trees_equal(run["resumed_state"], run["jax_state"])


def test_val_epoch_matches_jax(run):
    (got_results, got_stats), (want_results, want_stats) = run["port_coco"], run["jax_coco"]
    for kind in ("bbox", "segm"):
        assert got_stats[kind].shape == (12,) and got_stats[kind][0] > 0, got_stats[kind]
        np.testing.assert_allclose(got_stats[kind], want_stats[kind], rtol=0, atol=1e-12)
        got, want = got_results[kind], want_results[kind]
        assert len(got) == len(want) > 0
        key = "bbox" if kind == "bbox" else "segmentation"
        for g, w in zip(got, want):
            assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
            if kind == "segm":
                assert json.dumps(g[key]) == json.dumps(w[key])
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)
    _assert_logs_close(run["port_val"], run["jax_val"], "val_loss")


def test_next_step_from_a_jax_checkpoint_matches_jax(run):
    got, want = run["next"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_jax_resumes_a_port_checkpoint(run):
    _assert_trees_equal(run["jax_resumed_state"], run["port_state_saved"])
    got, want = run["after"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
