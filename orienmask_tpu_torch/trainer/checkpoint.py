"""Checkpoints, read and written (counterpart of
``orienmask_tpu/trainer/checkpoint.py``).

* ``.ckpt``: the JAX package's checkpoint, a pickle of host numpy pytrees
  ``{epoch, params, batch_stats, opt_state, monitor_best, config}``, read
  and written in its layout (``models/convert.py::variables_from_jax`` and
  ``variables_to_jax``; ``opt_state`` is ``{"momentum": a params tree,
  "step": int32}``), so each package loads and resumes the other's.  Plain
  ``pickle`` reads it: it holds numpy arrays, dicts, lists and scalars,
  nothing of JAX.
* ``.pth``: a reference-layout state dict, bare or under ``state_dict``
  (with ``config`` and ``epoch`` beside it), through
  ``load_reference_state_dict``.

``CheckpointManager`` writes as the JAX one does: ``epoch<N>.ckpt`` every
``save_freq`` epochs, ``best_epoch<N>.ckpt`` and the ``best_model.ckpt``
link to it when the monitor improves (the previous best removed), and
``temp.ckpt`` on the epochs that are not validated; each file is written
to ``<name>.tmp`` and renamed.  With ``async_save`` the copy to the host
and the write run in a thread while training goes on: ``save`` takes its
snapshot on the device first (``checkpoint_state`` copies), so the next
steps' in-place updates cannot reach it.
"""

import os
import pickle
import threading

import numpy as np
import torch

from ..models.convert import load_reference_state_dict, variables_from_jax, variables_to_jax


def read_checkpoint(path):
    """The dict a ``.ckpt`` file holds (numpy leaves)."""
    with open(path, "rb") as fh:
        return pickle.load(fh)


def load_state(model, state):
    """Load a ``.ckpt`` dict's ``params`` and ``batch_stats`` into ``model``
    (strict) and return its other entries."""
    model.load_state_dict(variables_from_jax(model, state), strict=True)
    return {k: v for k, v in state.items() if k not in ("params", "batch_stats")}


def load_checkpoint(path, model):
    """Load the weights of checkpoint ``path`` into ``model`` (strict) and
    return the checkpoint's other entries (``epoch``, ``config``,
    ``opt_state``, ...)."""
    path = str(path)
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        load_reference_state_dict(model, ckpt)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            return {k: v for k, v in ckpt.items() if k != "state_dict"}
        return {}
    return load_state(model, read_checkpoint(path))


def checkpoint_state(model, optimizer):
    """``{"params", "batch_stats", "opt_state"}`` of a model and its ``SGD``
    in the JAX layout, as copies on the model's device (zero momentum
    before the first update)."""
    variables = variables_to_jax(model)
    names = [name for name, _ in model.named_parameters()]
    buffers = optimizer.buffers or [torch.zeros_like(p) for p in optimizer.params]
    momentum = dict(model.state_dict(), **dict(zip(names, buffers)))
    step = optimizer.step if optimizer.step is not None else torch.zeros((), dtype=torch.int32)
    return dict(variables, opt_state={"momentum": variables_to_jax(model, momentum)["params"],
                                      "step": step.detach().clone()})


def load_optimizer_state(model, optimizer, opt_state):
    """A JAX-layout ``opt_state`` into ``optimizer`` (an ``SGD`` over
    ``model.parameters()``)."""
    momentum = variables_from_jax(model, {"params": opt_state["momentum"], "batch_stats": None})
    optimizer.load_state([momentum[name] for name, _ in model.named_parameters()],
                         int(np.asarray(opt_state["step"])))


def _to_host(tree):
    """Tensors -> contiguous numpy copies (an int32 counter stays a 0-d
    array, as JAX writes it); everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path, state):
    """Write ``state`` (tensors or numpy leaves) as a ``.ckpt`` pickle,
    through ``<path>.tmp`` so that a crash leaves no truncated file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(_to_host(state), fh, protocol=4)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, checkpoint_dir, save_freq, logger=None, async_save=False):
        self.dir = checkpoint_dir
        self.save_freq = save_freq
        self.logger = logger
        self.async_save = async_save
        self._worker = None
        self._worker_error = None

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def wait(self):
        """Join the save in flight (nothing when idle or synchronous) and
        raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def save(self, epoch, state, save_best=False, temp=False):
        """``state``'s tensors must be copies (``checkpoint_state``): with
        ``async_save`` they are written after this returns."""
        if not (epoch % self.save_freq == 0 or save_best or temp):
            return
        if not self.async_save:
            self._save_now(epoch, _to_host(state), save_best, temp)
            return
        self.wait()  # one in flight: keeps the order of the files, surfaces errors

        def run():
            try:
                self._save_now(epoch, _to_host(state), save_best, temp)
            except BaseException as e:  # raised again by the next save() or wait()
                self._worker_error = e

        self._worker = threading.Thread(target=run, name="ckpt-save", daemon=True)
        self._worker.start()

    def _save_now(self, epoch, state, save_best, temp):
        if epoch % self.save_freq == 0:
            path = os.path.join(self.dir, f"epoch{epoch}.ckpt")
            save_checkpoint(path, state)
            self._log(f"Saving checkpoint at {path}")
        if save_best:
            rel = f"best_epoch{epoch}.ckpt"
            path = os.path.join(self.dir, rel)
            save_checkpoint(path, state)
            link = os.path.join(self.dir, "best_model.ckpt")
            if os.path.islink(link):
                stale = os.path.join(self.dir, os.readlink(link))
                if os.path.exists(stale):
                    os.remove(stale)
                os.remove(link)
            os.symlink(rel, link)
            self._log(f"Saving current best at {path}")
        if temp:
            path = os.path.join(self.dir, "temp.ckpt")
            save_checkpoint(path, state)
            self._log(f"Saving temp checkpoint at {path}")
