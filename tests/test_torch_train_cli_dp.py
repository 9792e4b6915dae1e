"""The port's train and test CLIs as two CPU ranks over gloo
(``--coordinator localhost:<free port> --num-processes 2 --process-id R
--device cpu``).  Each rank is a subprocess (``python
tests/test_torch_train_cli_dp.py MODE RANK PORT OUT -- ARGV``: one thread,
its own deadline) that runs the CLI's ``main(argv)`` and records what the
rank did.  The data: the port's mini dataset, 9 seeded scenes, a set that
is no multiple of the world size, so the rank split wraps; the published
config at 64², slim depth, ``n_device=2`` with B = 2 a device.

* train, 2 epochs of 2 steps, each validated: one run directory; only rank
  0 saves checkpoints; rank 0's merged COCO results hold both ranks'
  detections and no shard file is left; both ranks end with the same
  parameters, BatchNorm buffers and momentum by bits and log the same
  losses.  Against one process at B = 4 on the same global batches: the
  first step's loss to 5e-5 of itself (measured 1.4e-5), epoch 1's (the
  mean of two steps' global losses) to 5e-3, the figure
  ``tests/test_cli_multiprocess.py`` states for the JAX package (measured
  2.3e-3: the second step starts from states that differ by the first
  step's rounding, amplified by random weights, as the train-step test
  states).
* test, on the best checkpoint: ``n_device=2`` as two ranks against
  ``n_device=1`` in this process: the 12-stat bbox and segm vectors to
  atol 1e-6, and rank 0 holds as many results as one process (the
  wrapped-in repeats are not scored).
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orienmask_tpu_torch import test as test_cli
from orienmask_tpu_torch import train as train_cli
from orienmask_tpu_torch.trainer import builder
from orienmask_tpu_torch.utils.mini_dataset import mini_config, mini_test_config, write_mini_dataset

ROOT = Path(__file__).resolve().parent.parent
SLIM = [1, 1, 1, 1, 1]
N_IMAGES = 9
RANK_DEADLINE_S = 300
STEP_RTOL, EPOCH_RTOL = 5e-5, 5e-3


def _config(paths, log_dir, n_device, batch_size, **updates):
    loader = {"batch_size": batch_size, "num_workers": 0, "max_instances": 8}
    base = dict(n_device=n_device, epochs=2, val_freq=1, save_freq=2, log_freq=1,
                compute_dtype="float32", train_loader=loader, val_loader=loader,
                model={"pretrained": None, "backbone_stage_blocks": SLIM})
    return mini_config(paths, log_dir, size=64, **dict(base, **updates))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(mode, argv, workdir):
    """Both ranks of ``mode`` ("train" or "test") on ``argv``; their
    records, rank 0's output among them."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    outs = [workdir / f"{mode}_rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(port), str(outs[r]),
                               "--", *argv], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for r, p in enumerate(procs):
            texts.append(p.communicate(timeout=RANK_DEADLINE_S)[0])
            assert p.returncode == 0, f"{mode} rank {r} exited {p.returncode}:\n{texts[-1][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    records = [json.loads(o.read_text()) for o in outs]
    records[0]["output"] = texts[0]
    return records


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The two-rank train CLI, then the two-rank test CLI on its best
    checkpoint: (root, dataset paths, train records, run dir, test records,
    test config)."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("dp")
    paths = write_mini_dataset(root, N_IMAGES, ((48, 64), (43, 61)), seed=0)
    cfg_file = root / "config.json"
    cfg_file.write_text(json.dumps(_config(paths, str(root / "runs"), 2, 2)))
    train = _run_ranks("train", ["-c", str(cfg_file)], root)
    (run_dir,) = (root / "runs").iterdir()
    test_cfg = mini_test_config(json.loads(cfg_file.read_text()), batch_size=4)
    test_file = root / "test_config.json"
    test_file.write_text(json.dumps(dict(test_cfg, n_device=2)))
    test = _run_ranks("test", ["-c", str(test_file), "-w", str(run_dir / "best_model.ckpt")],
                      root)
    yield root, paths, train, run_dir, test, test_cfg
    shutil.rmtree(root, ignore_errors=True)


def test_ranks_share_one_run_directory_and_rank_0_saves(dp_run):
    _, _, train, run_dir, _, _ = dp_run
    names = set(os.listdir(run_dir))
    assert {"config.json", "train.log", "epoch2.ckpt", "best_model.ckpt",
            "bbox_prediction.json", "segm_prediction.json"} <= names
    assert not [n for n in names if n.startswith("_coco_shard")]
    assert [rec["saves"] for rec in train] == [2, 0]
    assert "[parallel] 2 ranks over gloo on the CPU" in train[0]["output"]
    # rank 1 logs at ERROR only
    log = (run_dir / "train.log").read_text()
    assert log.count("[EPOCH 1]") == 1 and log.count("[EPOCH 2]") == 1


def test_ranks_end_equal_and_log_the_same_losses(dp_run):
    _, _, train, _, _, _ = dp_run
    assert train[0]["digest"] == train[1]["digest"]
    for key in ("train_loss", "val_loss"):
        got = [[e[key] for e in rec["epochs"]] for rec in train]
        assert got[0] == got[1] and np.isfinite(got[0]).all(), key


def test_rank_0_merges_both_ranks_detections(dp_run):
    _, _, train, run_dir, _, _ = dp_run
    for own0, merged, own1 in zip(*[[m[k] for m in train[0]["merges"]] for k in ("own", "all")],
                                  [m["own"] for m in train[1]["merges"]]):
        assert own0 > 0 and own1 > 0 and merged == own0 + own1
    assert [m["all"] for m in train[1]["merges"]] == [m["own"] for m in train[1]["merges"]]


def test_first_epoch_loss_matches_one_process(dp_run, tmp_path):
    """One process with B = 4 takes the same global batches: the rank split
    of the shuffled order pairs positions (0, 2), (1, 3) into one batch."""
    _, paths, train, _, _, _ = dp_run
    cfg = _config(paths, str(tmp_path), 1, 4, val_freq=2)
    trainer = builder.build_trainer(cfg, device="cpu")
    step, step_losses = trainer.train_step, []

    def recording(*args):
        logs = step(*args)
        step_losses.append(float(logs["loss"]))
        return logs

    trainer.train_step = recording
    want = trainer._train_epoch(1)["train_loss"]
    np.testing.assert_allclose(train[0]["step_losses"][0], step_losses[0], rtol=STEP_RTOL)
    np.testing.assert_allclose(train[0]["epochs"][0]["train_loss"], want, rtol=EPOCH_RTOL)


def test_two_rank_test_cli_matches_one_device(dp_run, capsys):
    root, _, _, run_dir, test, test_cfg = dp_run
    one_file = root / "test_config_1.json"
    one_file.write_text(json.dumps(test_cfg))
    testers = []
    build = test_cli.build_tester

    def recording(*args, **kw):
        testers.append(build(*args, **kw))
        return testers[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(test_cli, "build_tester", recording)
    try:
        assert test_cli.main(["-c", str(one_file), "-w", str(run_dir / "best_model.ckpt"),
                              "--device", "cpu"]) == 0
    finally:
        mp.undo()
    capsys.readouterr()
    want = testers[0].coco_metrics
    assert test[0]["results"] == len(want.bbox_results) and test[1]["stats"] is None
    assert test[0]["results"] > test[1]["results"] > 0
    for kind in ("bbox", "segm"):
        got = np.asarray(test[0]["stats"][kind])
        assert got.shape == (12,)
        np.testing.assert_allclose(got, np.asarray(getattr(want, f"{kind}_eval_stats")),
                                   rtol=0, atol=1e-6, err_msg=kind)


# --------------------------------------------------------------- the ranks

def _digest(trainer):
    h = hashlib.sha256()
    tensors = [*trainer.model.state_dict().values(), *trainer.optimizer.buffers,
               trainer.optimizer.step]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_main(mode, rank, port, out, argv):
    from unittest import mock

    from orienmask_tpu_torch.eval.coco_eval import COCOMetrics
    from orienmask_tpu_torch.trainer.base import BaseTrainer
    from orienmask_tpu_torch.trainer.checkpoint import CheckpointManager
    from orienmask_tpu_torch.trainer import trainer as trainer_module
    from orienmask_tpu_torch.trainer.trainer import Trainer

    torch.set_num_threads(1)
    rec = {"epochs": [], "step_losses": [], "saves": 0, "merges": [], "digest": None}
    train_epoch, train, save = Trainer._train_epoch, BaseTrainer.train, CheckpointManager.save
    merge_ranks, make_train_step = COCOMetrics.merge_ranks, trainer_module.make_train_step
    testers = []

    def recording_make_train_step(*args, **kw):
        step = make_train_step(*args, **kw)

        def train_step(*a):
            logs = step(*a)
            rec["step_losses"].append(float(logs["loss"]))
            return logs

        return train_step

    def recording_epoch(self, epoch):
        rec["epochs"].append(train_epoch(self, epoch))
        return rec["epochs"][-1]

    def recording_train(self):
        train(self)
        rec["digest"] = _digest(self)

    def recording_save(self, *args, **kw):
        rec["saves"] += 1
        return save(self, *args, **kw)

    def recording_merge(self, directory):
        own = len(self.bbox_results)
        merge_ranks(self, directory)
        rec["merges"].append({"own": own, "all": len(self.bbox_results)})

    def recording_build_tester(*args, **kw):
        testers.append(builder.build_tester(*args, **kw))
        return testers[-1]

    flags = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(rank), "--device", "cpu"]
    with mock.patch.object(trainer_module, "make_train_step", recording_make_train_step), \
            mock.patch.object(Trainer, "_train_epoch", recording_epoch), \
            mock.patch.object(BaseTrainer, "train", recording_train), \
            mock.patch.object(CheckpointManager, "save", recording_save), \
            mock.patch.object(COCOMetrics, "merge_ranks", recording_merge), \
            mock.patch.object(test_cli, "build_tester", recording_build_tester):
        rc = (train_cli if mode == "train" else test_cli).main([*argv, *flags])
    if rc != 0:
        raise SystemExit(rc)
    if testers:
        metrics = testers[0].coco_metrics
        rec["results"] = len(metrics.bbox_results)
        rec["stats"] = None if rank else {k: list(map(float, getattr(metrics, f"{k}_eval_stats")))
                                          for k in ("bbox", "segm")}
    Path(out).write_text(json.dumps(rec))


if __name__ == "__main__":
    sep = sys.argv.index("--")
    mode, rank, port, out = sys.argv[1:sep]
    rank_main(mode, int(rank), int(port), out, sys.argv[sep + 1:])
