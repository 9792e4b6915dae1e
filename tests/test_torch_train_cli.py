"""The port's train and test CLIs (orienmask_tpu_torch/train.py, test.py)
end to end on the CPU, in-process through ``main(argv)``, on the port's
mini dataset: 8 seeded scenes, the published config at 64², slim depth,
B = 4 (2 steps an epoch).

* ``train -c`` writes the run directory and the JAX-named checkpoints;
  ``test -c -w`` on the best one gives the 12-stat vectors of an in-process
  ``Tester`` on the same checkpoint; ``-r`` resumes at the next epoch and
  ``-w`` starts from a checkpoint's weights.
* A launch that cannot form a process group and every unported option
  exit or raise with their messages (``--num-processes 1`` trains as one
  process); ``remat``, ``param_groups`` and ``freeze_backbone`` build a
  trainer that honours them; the default device raises without a card; the ``n_device``
  check against the group's size and its ``ORIENMASK_ANY_DEVICES`` opt-out; a non-finite loss exits 1 and
  ``max_iter`` exits 0 after its checkpoint.
* One subprocess, ``python -m orienmask_tpu_torch.train``, one epoch of 2
  steps, one thread."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orienmask_tpu.utils.envs import cpu_subprocess_env
from orienmask_tpu_torch import test as test_cli
from orienmask_tpu_torch import train as train_cli
from orienmask_tpu_torch.trainer import builder
from orienmask_tpu_torch.trainer.checkpoint import read_checkpoint
from orienmask_tpu_torch.utils.mini_dataset import (
    main as mini_main,
    mini_config,
    mini_test_config,
    write_mini_dataset,
)

ROOT = Path(__file__).resolve().parent.parent
SLIM = [1, 1, 1, 1, 1]


def _config(paths, log_dir, **updates):
    loader = {"batch_size": 4, "num_workers": 0, "max_instances": 8}
    base = dict(n_device=1, epochs=1, val_freq=1, save_freq=1, log_freq=1,
                compute_dtype="float32", train_loader=loader, val_loader=loader,
                model={"pretrained": os.path.join(os.path.dirname(paths["anno_file"]),
                                                  "absent.pth"),
                       "backbone_stage_blocks": SLIM})
    return mini_config(paths, log_dir, size=64, **dict(base, **updates))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One ``train -c`` run: (root, dataset paths, config file, run dir).
    A checkpoint of the published widths takes about 280 MB: the files go
    when the module ends, and each test's own when it ends."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("cli")
    paths = write_mini_dataset(root, 8, ((48, 64), (43, 61)), seed=0)
    cfg_file = root / "config.json"
    cfg_file.write_text(json.dumps(_config(paths, str(root / "runs"))))
    assert train_cli.main(["-c", str(cfg_file), "--device", "cpu"]) == 0
    (run_dir,) = (root / "runs").iterdir()
    yield root, paths, cfg_file, run_dir
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _remove_files(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _json(path):
    return json.loads(Path(path).read_text())


def test_train_writes_the_run_directory(trained):
    _, _, cfg_file, run_dir = trained
    names = set(os.listdir(run_dir))
    assert {"config.json", "train.log", "epoch1.ckpt", "best_epoch1.ckpt", "best_model.ckpt",
            "bbox_prediction.json", "segm_prediction.json"} <= names
    assert _json(run_dir / "config.json") == _json(cfg_file)
    ckpt = read_checkpoint(run_dir / "epoch1.ckpt")
    assert ckpt.keys() == {"epoch", "params", "batch_stats", "opt_state", "monitor_best",
                           "config"}
    assert ckpt["epoch"] == 1 and int(ckpt["opt_state"]["step"]) == 2
    assert ckpt["config"] == _json(cfg_file)
    log = (run_dir / "train.log").read_text()
    assert "[EPOCH 1]" in log and "Saving current best" in log


def test_test_cli_matches_an_in_process_tester(trained, capsys):
    root, _, cfg_file, run_dir = trained
    test_cfg = root / "test_config.json"
    test_cfg.write_text(json.dumps(mini_test_config(_json(cfg_file), batch_size=3)))
    ckpt = str(run_dir / "best_model.ckpt")
    testers = []
    build = test_cli.build_tester

    def recording(*args, **kw):
        testers.append(build(*args, **kw))
        return testers[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(test_cli, "build_tester", recording)
    try:
        assert test_cli.main(["-c", str(test_cfg), "-w", ckpt, "--device", "cpu"]) == 0
    finally:
        mp.undo()
    out = capsys.readouterr().out
    for text in ("COCO eval bbox", "COCO eval segm", "Speed Statistics (batch size = 3)"):
        assert text in out
    want = builder.build_tester(_json(test_cfg), ckpt, device="cpu")
    want.test()
    for kind in ("bbox", "segm"):
        got = np.asarray(getattr(testers[0].coco_metrics, f"{kind}_eval_stats"))
        assert got.shape == (12,)
        np.testing.assert_array_equal(
            got, np.asarray(getattr(want.coco_metrics, f"{kind}_eval_stats")))


def test_resume_trains_the_next_epoch(trained, tmp_path):
    _, paths, _, run_dir = trained
    cfg_file = tmp_path / "config.json"
    cfg_file.write_text(json.dumps(_config(paths, str(tmp_path / "runs"), epochs=2,
                                           save_freq=2)))
    ckpt = tmp_path / "epoch1.ckpt"
    ckpt.write_bytes((run_dir / "epoch1.ckpt").read_bytes())
    # the checkpoint's config differs in epochs and save_freq only: resumable
    assert train_cli.main(["-c", str(cfg_file), "-r", str(ckpt), "--device", "cpu"]) == 0
    resumed = read_checkpoint(tmp_path / "epoch2.ckpt")
    assert resumed["epoch"] == 2 and int(resumed["opt_state"]["step"]) == 4
    assert not (tmp_path / "runs").exists()  # -r reuses the checkpoint's run directory


def test_weights_start_a_new_run(trained, tmp_path):
    _, paths, _, run_dir = trained
    cfg = _config(paths, str(tmp_path / "runs"))
    trainer = builder.build_trainer(cfg, weights=str(run_dir / "epoch1.ckpt"), device="cpu")
    want = read_checkpoint(run_dir / "epoch1.ckpt")
    got = trainer._checkpoint_state(0)
    np.testing.assert_array_equal(got["params"]["backbone"]["conv1"]["kernel"].numpy(),
                                  want["params"]["backbone"]["conv1"]["kernel"])
    assert int(got["opt_state"]["step"]) == 0 and trainer.start_epoch == 1


@pytest.mark.parametrize("flags,message", [
    (["--num-processes", "2"], "--num-processes 2 needs --coordinator host:port"),
    (["--coordinator", "localhost:1234", "--num-processes", "2", "--process-id", "2"],
     r"--process-id 2 is out of range for --num-processes 2 \(0 \.\. 1\)"),
    (["--num-processes", "1"], None),
])
def test_multi_process_flags_are_refused(flags, message, trained, tmp_path):
    """A launch that cannot form a process group exits with its message;
    ``--num-processes 1`` trains in one process, with no group."""
    _, paths, _, _ = trained
    cfg_file = tmp_path / "config.json"
    cfg_file.write_text(json.dumps(_config(paths, str(tmp_path / "runs"))))
    argv = ["-c", str(cfg_file), *flags, "--device", "cpu"]
    if message is not None:
        with pytest.raises(SystemExit, match=message):
            train_cli.main(argv)
        assert not (tmp_path / "runs").exists()
        return
    assert train_cli.main(argv) == 0
    (run_dir,) = (tmp_path / "runs").iterdir()
    assert read_checkpoint(run_dir / "epoch1.ckpt")["epoch"] == 1
    assert not torch.distributed.is_initialized()


def test_train_needs_a_config():
    with pytest.raises(SystemExit, match="Configuration file need to be specified"):
        train_cli.main(["--device", "cpu"])


def test_clis_default_to_the_card(trained, monkeypatch):
    _, _, cfg_file, run_dir = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-c", str(cfg_file)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(["-c", str(cfg_file), "-w", str(run_dir / "epoch1.ckpt")])


@pytest.mark.parametrize("updates,message", [
    ({"n_device": 2}, r"config n_device=2 but the process group spans 1 device\(s\)"),
    ({"n_space": 2}, "spatial training"),
])
def test_unported_options_are_refused(trained, tmp_path, updates, message):
    _, paths, _, _ = trained
    with pytest.raises(ValueError, match=message):
        builder.build_trainer(_config(paths, str(tmp_path), **updates), device="cpu")


@pytest.mark.parametrize("updates", [
    {"remat": True},
    {"optimizer": {"param_groups": {"bias_lr_factor": 2}}},
    {"model": {"freeze_backbone": 2}},
], ids=["remat", "param_groups", "freeze_backbone"])
def test_trainer_options_are_honoured(trained, tmp_path, monkeypatch, updates):
    """The keys the port refused until it ported them build a trainer that
    honours them: the train step rematerializes, SGD holds the param
    groups' factors, the frozen stages' mask and eval-mode BatchNorms."""
    from orienmask_tpu_torch.models.layers import Conv
    from orienmask_tpu_torch.trainer import trainer as trainer_module

    _, paths, _, _ = trained
    steps = []
    make = trainer_module.make_train_step
    monkeypatch.setattr(trainer_module, "make_train_step",
                        lambda *a, **kw: steps.append(kw) or make(*a, **kw))
    trainer = builder.build_trainer(_config(paths, str(tmp_path), **updates), device="cpu")
    model, opt = trainer.model, trainer.optimizer
    assert steps[0]["remat"] is ("remat" in updates)
    conv_biases = {id(m.bias) for m in model.modules() if isinstance(m, Conv)}
    want_lr = [2.0 if id(p) in conv_biases and "optimizer" in updates else 1.0
               for p in model.parameters()]
    assert opt.lr_factors == want_lr
    frozen = {id(p) for name in ("conv1", "conv2")
              for p in getattr(model.backbone, name).parameters()} if "model" in updates else set()
    assert opt.freeze_mask == [id(p) in frozen for p in model.parameters()]
    model.train()
    for name in model.backbone.stage_names:
        bns = [m for m in getattr(model.backbone, name).modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
        assert all(bn.training is not ("model" in updates and name in ("conv1", "conv2"))
                   for bn in bns), name
    batch, _ = list(trainer.train_loader)[:2]
    assert np.isfinite(float(trainer.train_step(batch, 1e-4)["loss"]))


def test_any_devices_trains_one_devices_share(trained, tmp_path, monkeypatch):
    _, paths, _, _ = trained
    monkeypatch.setenv("ORIENMASK_ANY_DEVICES", "1")
    trainer = builder.build_trainer(_config(paths, str(tmp_path), n_device=2), device="cpu")
    assert trainer.train_loader.batch_size == 4 and trainer.train_loader.drop_last
    assert trainer.val_loader.pad_last


def test_nan_loss_exits_1(trained, tmp_path):
    _, paths, _, _ = trained
    trainer = builder.build_trainer(_config(paths, str(tmp_path)), device="cpu")
    step = trainer.train_step
    trainer.train_step = lambda *a: dict(step(*a), loss=torch.tensor(float("nan")))
    with pytest.raises(SystemExit) as stop:
        trainer.train()
    assert stop.value.code == 1
    log = (Path(trainer.checkpoint_dir) / "train.log").read_text()
    assert "nan or inf found. Training stops at epoch 1 batch 1" in log


def test_max_iter_saves_and_exits_0(trained, tmp_path):
    _, paths, _, _ = trained
    cfg = _config(paths, str(tmp_path), epochs=3)
    cfg["lr_scheduler"] = {"type": "PolyLR", "max_iter": 1}
    trainer = builder.build_trainer(cfg, device="cpu")
    with pytest.raises(SystemExit) as stop:
        trainer.train()
    assert stop.value.code == 0
    assert read_checkpoint(Path(trainer.checkpoint_dir) / "batch_1.ckpt")["epoch"] == 1


def test_mini_dataset_cli_writes_train_and_test_configs(tmp_path):
    assert mini_main([str(tmp_path), "--n-images", "2", "--sizes", "40x48", "--size", "64",
                      "--stage-blocks", "1,1,1,1,1", "--batch-size", "2"]) == 0
    cfg, test_cfg = _json(tmp_path / "config.json"), _json(tmp_path / "test_config.json")
    assert cfg["n_device"] == 1 and cfg["model"]["backbone_stage_blocks"] == SLIM
    assert cfg["loss"]["grid_size"] == [[2, 2], [4, 4], [8, 8]]
    assert test_cfg["gt_file"] == cfg["val_gt_file"] and len(os.listdir(tmp_path / "images")) == 2


def test_train_module_runs_as_a_program(trained, tmp_path):
    """``python -m orienmask_tpu_torch.train``: one epoch of 2 steps, one
    thread."""
    _, paths, _, _ = trained
    cfg_file = tmp_path / "config.json"
    cfg_file.write_text(json.dumps(_config(paths, str(tmp_path / "runs"))))
    env = dict(cpu_subprocess_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "orienmask_tpu_torch.train", "-c",
                           str(cfg_file), "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (run_dir,) = (tmp_path / "runs").iterdir()
    assert (run_dir / "best_model.ckpt").exists()
    assert "[DarkNet53] pretrained file not found, skipping" in proc.stdout
