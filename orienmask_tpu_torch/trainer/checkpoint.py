"""Checkpoint reading (the read side of
``orienmask_tpu/trainer/checkpoint.py::load_checkpoint``).

* ``.ckpt``: the JAX package's checkpoint, a pickle of host numpy pytrees
  ``{epoch, params, batch_stats, opt_state, monitor_best, config}``; its
  ``params`` and ``batch_stats`` go through ``variables_from_jax``.  Plain
  ``pickle`` reads it: the pickle holds numpy arrays, dicts, lists and
  scalars, nothing of JAX.
* ``.pth``: a reference-layout state dict, bare or under ``state_dict``
  (with ``config`` and ``epoch`` beside it), through
  ``load_reference_state_dict``.
"""

import pickle

import torch

from ..models.convert import load_reference_state_dict, variables_from_jax


def load_checkpoint(path, model):
    """Load the weights of checkpoint ``path`` into ``model`` (strict) and
    return the checkpoint's other entries (``epoch``, ``config``, ...)."""
    path = str(path)
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        load_reference_state_dict(model, ckpt)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            return {k: v for k, v in ckpt.items() if k != "state_dict"}
        return {}
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    model.load_state_dict(variables_from_jax(model, state), strict=True)
    return {k: v for k, v in state.items() if k not in ("params", "batch_stats")}
