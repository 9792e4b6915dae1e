"""The train and validation epochs (counterpart of
``orienmask_tpu/trainer/trainer.py``).

Under a process group each rank trains on its loader's share of every
global batch (``make_train_step`` sums over the ranks); the ranks start
from rank 0's state (``replicate_global``) and their steps keep them equal.

Train epoch: each batch goes through ``make_train_step`` at the scheduled
lr (kernel 5 paints the orientation targets on the card); the step's logs
stay on the device and are fetched every ``log_freq`` steps (one copy a
step), so the card is not waited for after every step.  A non-finite loss
stops training with exit code 1 within that window, on every rank (the
logs are the global batch's everywhere); the step's own NaN guard has kept
the state finite, so the last checkpoint resumes.  A finite loss with
non-finite gradients is logged as a skipped update.  With ``max_iter`` in
the schedule, rank 0 saves ``batch_<step>.ckpt`` and every rank exits 0
when the raw batch counter reaches it (the JAX package's quirk with
``accumulate > 1`` kept).

Validation epoch: ``make_eval_step`` (running statistics, the loss and its
metrics summed over the ranks, wrap-padded samples weighted 0), then the
postprocess on this rank's heads (kernels 1 and 2 on the card) and
``COCOMetrics.to_coco_format_device`` on its rows (kernel 6 recovers the
masks where they lie); the other ranks' results reach rank 0 through JSON
files after a barrier, and rank 0 scores them (``coco_eval``).
"""

import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..eval.coco_eval import COCOMetrics
from ..eval.counter import EvalCounter
from ..parallel.mesh import replicate_global
from .base import BaseTrainer
from .checkpoint import (
    checkpoint_state,
    load_checkpoint,
    load_optimizer_state,
    load_state,
    save_checkpoint,
)
from .tester import _pipe_table
from .train_state import make_eval_step, make_train_step


def _host(logs):
    """A dict of scalars (0-d tensors on one device, or numbers) -> Python
    floats, in one copy."""
    keys = list(logs)
    device = next((v.device for v in logs.values() if isinstance(v, torch.Tensor)), None)
    values = torch.stack([torch.as_tensor(logs[k], dtype=torch.float32, device=device).reshape(())
                          for k in keys]).tolist()
    return dict(zip(keys, values))


class Trainer(BaseTrainer):
    def __init__(self, model, loss, optimizer, lr_scheduler, config, train_loader, val_loader,
                 postprocess, device=None, resume=None, weights=None):
        super().__init__(config, resume, weights)
        self.device = resolve_device(device)
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.postprocess = postprocess
        dtype = config.get("compute_dtype", "float32")
        self.train_step = make_train_step(model, loss, optimizer, accumulate=self.accumulate,
                                          compute_dtype=dtype, device=self.device,
                                          remat=bool(config.get("remat", False)))
        self.eval_step = make_eval_step(model, loss, dtype, self.device)
        self.coco_metrics = None
        if val_loader is not None and config.get("val_gt_file"):
            self.coco_metrics = COCOMetrics(
                gt_file=config["val_gt_file"], cat2label=val_loader.dataset.CAT2LABEL,
                with_mask=getattr(val_loader.dataset, "with_mask", True),
                save_dir=self.checkpoint_dir)
        self._restore_if_needed()
        sgd_state = [] if optimizer.buffers is None else [*optimizer.buffers, optimizer.step]
        replicate_global([*model.parameters(), *model.buffers(), *sgd_state])

    def train(self):
        """The epochs (``BaseTrainer.train``); the loaders' worker processes
        are stopped at the end, as they are when it raises."""
        try:
            super().train()
        finally:
            for loader in (self.train_loader, self.val_loader):
                if loader is not None:
                    loader.shutdown()

    # ------------------------------------------------------------- state

    def _checkpoint_state(self, epoch):
        return dict(checkpoint_state(self.model, self.optimizer), epoch=epoch,
                    monitor_best=self.monitor_best, config=self.config)

    def _load_state(self, ckpt, strict):
        if not isinstance(ckpt, dict):  # weights: parameters and statistics only
            load_checkpoint(ckpt, self.model)
            return
        load_state(self.model, ckpt)
        if strict and "opt_state" in ckpt:
            load_optimizer_state(self.model, self.optimizer, ckpt["opt_state"])

    # ------------------------------------------------------- train epoch

    def _train_epoch(self, epoch):
        self.logger.info("Train on epoch %d" % epoch)
        self.train_loader.set_epoch(epoch)
        counter = EvalCounter()
        n_iter = len(self.train_loader)
        pending = []  # (batch index, device logs) not yet fetched

        def drain():
            for step_idx, log in pending:
                host = _host(log)
                if host.get("skipped", 0) > 0 and np.isfinite(host["loss"]):
                    self.logger.warning(f"non-finite gradients at batch {step_idx}: "
                                        "update skipped by the NaN guard")
                if not np.isfinite(host["loss"]):
                    self.logger.error("Error: nan or inf found. Training stops at epoch "
                                      f"{epoch} batch {step_idx}.")
                    for k, v in host.items():
                        self.logger.error(f"{k}: {v}")
                    sys.exit(1)
                counter.update("loss", host.pop("loss"))
                for k, v in host.items():
                    counter.update(k, v)
            pending.clear()

        for batch_idx, batch in enumerate(self.train_loader, 1):
            step = (epoch - 1) * n_iter + batch_idx
            actual_step = step // self.accumulate
            lr = self.lr_scheduler(actual_step)
            do_step = (batch_idx % self.accumulate == 0) or (batch_idx == n_iter)
            pending.append((batch_idx, self.train_step(batch, lr, do_step)))

            if step % self.writer_freq == 0:
                drain()
                if self.tensorboard is not None:
                    self.tensorboard.add_scalar("lr", lr, actual_step)
                    self.tensorboard.add_scalar("train/loss", counter.average("loss"),
                                                actual_step)
                    for key in self.loss.loss_id:
                        self.tensorboard.add_scalar(f"train/{key}", counter.average(key),
                                                    actual_step)
                self.logger.info(f"epoch {epoch} batch {batch_idx}/{n_iter}: lr {lr:.2e} "
                                 f"loss {counter.average('loss'):.4f}")
                counter.reset()

            # the raw batch counter against max_iter, while the schedule takes
            # step // accumulate: with accumulate > 1 this stops after
            # max_iter / accumulate updates (the JAX package's quirk)
            if step == getattr(self.lr_scheduler, "max_iter", None):
                drain()
                if self.device_rank == 0:
                    path = os.path.join(self.checkpoint_dir, f"batch_{step}.ckpt")
                    save_checkpoint(path, self._checkpoint_state(epoch))
                    self.logger.info(f"Saving checkpoint at {path}")
                sys.exit(0)

        drain()
        train_log = {"train_loss": counter.average_epoch("loss")}
        for key in self.loss.loss_id:
            train_log[f"train_{key}"] = counter.average_epoch(key)
        counter.reset_epoch()
        if self.val_loader is not None and epoch % self.val_freq == 0:
            train_log.update(self._val_epoch(epoch))
        return train_log

    # --------------------------------------------------------- val epoch

    def _val_epoch(self, epoch):
        self.logger.info("Validate after epoch %d" % epoch)
        if self.coco_metrics is not None:
            self.coco_metrics.reset()
        counter = EvalCounter()
        for batch in self.val_loader:
            info = batch.get("info")
            # wrap-padded samples (pad_last) weigh 0 in the loss and metrics;
            # the COCO conversion skips them
            if info is not None:
                batch = dict(batch, sample_weight=np.asarray(
                    [0.0 if i.get("_pad") else 1.0 for i in info], np.float32))
            out, loss_log, metric_log = self.eval_step(batch)
            host = _host(dict(loss_log, **{f"{k}/{j}": v[j] for k, v in metric_log.items()
                                           for j in (0, 1)}))
            counter.update("loss", host.pop("loss"))
            for k in loss_log:
                if k != "loss":
                    counter.update(k, host[k])
            for k in metric_log:
                counter.update(k, (host[f"{k}/0"], host[f"{k}/1"]))
            if self.coco_metrics is not None and info is not None:
                device_out = self.postprocess.apply_device(out)
                self.coco_metrics.update_results(self.coco_metrics.to_coco_format_device(
                    info, device_out, self.postprocess.image_w))

        # the loss and metric counters are the global batch's already (the
        # eval step sums them); the detections are each rank's own
        if self.coco_metrics is not None:
            self.coco_metrics.merge_ranks(self.checkpoint_dir)
        coco_log = self.coco_metrics.coco_eval() \
            if self.coco_metrics is not None and self.device_rank == 0 else {}
        if self.tensorboard is not None:
            self.tensorboard.add_scalar("val/loss", counter.average("loss"), epoch)
            for key in self.loss.loss_id:
                self.tensorboard.add_scalar(f"val/{key}", counter.average(key), epoch)
            for key, value in coco_log.items():
                self.tensorboard.add_scalar(f"val/{key}", value, epoch)
        val_log = {"val_loss": counter.average_epoch("loss")}
        for key in list(self.loss.loss_id) + list(self.loss.metric_id):
            val_log[f"val_{key}"] = counter.average_epoch(key)
        for key, value in coco_log.items():
            val_log[f"val_{key}"] = value
        counter.reset_epoch()
        return val_log

    # ----------------------------------------------------------- logging

    def _log_result(self, result):
        rows = []
        for loss_id in self.loss.loss_suffix:
            key = "train_{}_" + loss_id
            rows.append([loss_id] + [result.get(key.format(s), "")
                                     for s in self.loss.scales_prefix]
                        + [result.get(key.format("cross_scale"), "")])
        self.logger.info("\n" + _pipe_table(["TRAIN", *self.loss.scales_prefix, "ALL"], rows))

        first_val = "val_{}_{}".format(self.loss.scales_prefix[0], self.loss.loss_suffix[0])
        if first_val in result:
            rows = []
            for item in list(self.loss.loss_suffix) + list(self.loss.metric_suffix):
                key = "val_{}_" + item
                rows.append([item] + [result.get(key.format(s), "")
                                      for s in self.loss.scales_prefix]
                            + [result.get(key.format("cross_scale"), "")])
            self.logger.info("\n" + _pipe_table(["VAL", *self.loss.scales_prefix, "ALL"],
                                                rows))
            if self.coco_metrics is not None and len(self.coco_metrics.bbox_eval_stats):
                self.logger.info("BBOX " + " ".join(
                    "%.3f" % k for k in self.coco_metrics.bbox_eval_stats))
                if self.coco_metrics.with_mask:
                    self.logger.info("SEGM " + " ".join(
                        "%.3f" % k for k in self.coco_metrics.segm_eval_stats))
