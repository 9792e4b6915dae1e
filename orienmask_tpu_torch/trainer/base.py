"""Run directory, logging, the epoch loop, checkpoints and resumption
(counterpart of ``orienmask_tpu/trainer/base.py``).

One process a device; under a process group the ranks share one run
directory: rank 0's stamp names it, rank 0 creates it and writes
``config.json`` while the others wait at a barrier.  The log goes to
``<run dir>/train.log`` and to stderr through a logger of the trainer's own
(the root logger is left as it is), at INFO on rank 0 and ERROR on the
others; tensorboardX writes rank 0's scalars there too where it is
importable.  Rank 0 alone logs the epochs' results, follows the monitor and
saves checkpoints; every rank leaves ``train()`` together.
"""

import datetime
import json
import logging
import math
import os

from ..utils.envs import barrier, broadcast_str, get_device_rank
from .checkpoint import CheckpointManager, read_checkpoint


def tensorboard_writer(log_dir):
    """A tensorboardX ``SummaryWriter`` when tensorboardX is importable, else
    None (the card's machine has none)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class BaseTrainer:
    def __init__(self, config, resume=None, weights=None):
        self.config = config
        self.device_rank = get_device_rank()
        if resume is not None:
            self.checkpoint_dir = os.path.dirname(resume)
        else:
            stamp = broadcast_str(datetime.datetime.now().strftime("%m%d_%H%M%S"))
            self.checkpoint_dir = os.path.join(config["log_dir"], config["name"] + "_" + stamp)
            if self.device_rank == 0:
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                with open(os.path.join(self.checkpoint_dir, "config.json"), "w") as fh:
                    json.dump(config, fh, indent=4)
            barrier()  # rank 0's run directory exists before anyone logs into it

        self.logger = logging.getLogger(f"{__name__}.{type(self).__name__}")
        self._close_log()
        self.logger.setLevel(logging.INFO if self.device_rank == 0 else logging.ERROR)
        self.logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(message)s")
        for handler in (logging.FileHandler(os.path.join(self.checkpoint_dir, "train.log")),
                        logging.StreamHandler()):
            handler.setFormatter(fmt)
            self.logger.addHandler(handler)

        self.accumulate = config.get("accumulate", 1)
        self.epochs = config["epochs"]
        self.val_freq = config.get("val_freq", 1)
        self.save_freq = config.get("save_freq", 1)
        self.temp_save_freq = config.get("temp_save_freq", 1)
        self.monitor = "val_" + config["monitor"]
        self.monitor_mode = config["monitor_mode"]
        if self.monitor_mode not in ("min", "max", "off"):
            raise ValueError(f"monitor_mode {self.monitor_mode!r} is not min, max or off")
        self.monitor_best = math.inf if self.monitor_mode == "min" else -math.inf
        self.start_epoch = 1
        self.writer_freq = config.get("log_freq", 50) * self.accumulate
        self.tensorboard = tensorboard_writer(self.checkpoint_dir) \
            if self.device_rank == 0 else None
        self.ckpt_manager = CheckpointManager(self.checkpoint_dir, self.save_freq, self.logger,
                                              async_save=config.get("async_checkpoint", False))
        self._resume_path = resume
        self._weights_path = weights

    def _close_log(self):
        for handler in list(self.logger.handlers):
            self.logger.removeHandler(handler)
            handler.close()

    def _restore_if_needed(self):
        """Subclasses call it once the model and optimizer exist."""
        if self._resume_path is not None:
            self._resume_checkpoint(self._resume_path)
        elif self._weights_path is not None:
            self._set_weights(self._weights_path)

    def train(self):
        for epoch in range(self.start_epoch, self.epochs + 1):
            self.logger.info("\n" + "-" * 68)
            self.logger.info("[EPOCH %d]" % epoch)
            start = datetime.datetime.now()
            result = self._train_epoch(epoch)
            self.logger.info("Finish at {}, Runtime: {}".format(
                datetime.datetime.now(), datetime.datetime.now() - start))
            if self.device_rank != 0:
                continue
            self._log_result(result)
            if epoch % self.val_freq == 0:
                best = False
                if self.monitor_mode != "off":
                    if self.monitor not in result:
                        raise KeyError(f"Can't recognize monitor item named {self.monitor}")
                    value = result[self.monitor]
                    improved = (value < self.monitor_best if self.monitor_mode == "min"
                                else value > self.monitor_best)
                    if improved:
                        self.logger.info("Monitor is improved from %f to %f"
                                         % (self.monitor_best, value))
                        self.monitor_best = value
                        best = True
                    else:
                        self.logger.info("Monitor is not improved from %f" % self.monitor_best)
                self.ckpt_manager.save(epoch, self._checkpoint_state(epoch), save_best=best)
            elif epoch % self.temp_save_freq == 0:
                self.ckpt_manager.save(epoch, self._checkpoint_state(epoch), temp=True)
        self.ckpt_manager.wait()
        # rank 0 trails the others by COCO scoring and checkpoint writing
        # each epoch: every rank leaves together
        barrier()
        if self.tensorboard is not None:
            self.tensorboard.close()
        self._close_log()

    def _train_epoch(self, epoch):
        raise NotImplementedError

    def _checkpoint_state(self, epoch):
        raise NotImplementedError

    def _log_result(self, result):
        for k, v in result.items():
            self.logger.info(f"{k}: {v}")

    def _resume_checkpoint(self, path):
        self.logger.info(f"Loading checkpoint: {path}")
        ckpt = read_checkpoint(path)
        self.start_epoch = ckpt.get("epoch", 0) + 1
        self.monitor_best = ckpt.get("monitor_best", self.monitor_best)
        if "config" in ckpt:
            for key in ("model", "optimizer", "lr_scheduler"):
                if ckpt["config"].get(key) != self.config.get(key):
                    raise ValueError(f"{key} configuration differs from the checkpoint's")
        self._load_state(ckpt, strict=True)
        self.logger.info(f"Checkpoint '{path}' (epoch {self.start_epoch - 1}) loaded")

    def _set_weights(self, path):
        self.logger.info(f"Loading weights: {path}")
        self._load_state(path, strict=False)

    def _load_state(self, ckpt, strict):
        """``ckpt``: a read ``.ckpt`` dict, or the path of weights."""
        raise NotImplementedError

