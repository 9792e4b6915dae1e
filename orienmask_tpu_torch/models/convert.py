"""Weight bridge and seeded init (counterpart of ``orienmask_tpu/models/convert.py``).

* ``variables_from_jax``: the JAX ``{"params", "batch_stats"}`` pytree, as
  numpy arrays (HWIO kernels; ``scale``/``bias``/``mean``/``var``), to the
  port's state dict.  The port's own copy of the mapping.
* ``load_reference_state_dict``: a reference-layout ``.pth`` state dict
  (OIHW kernels, ``conv_block.{0,1}`` keys), loaded with ``strict=True``.
* ``init_random``: seeded random weights from a ``torch.Generator``, the
  JAX init's distributions (torch's kaiming-uniform(a=sqrt(5)) bound
  1/sqrt(fan_in), BN at identity); no weights file is needed.
"""

import math

import numpy as np
import torch

from .darknet import DarkNet53, DarkNetBlock
from .layers import Conv, ConvBNLeaky, NearestUpsample, Sequential


def _oihw(kernel):
    """HWIO -> OIHW."""
    return torch.tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def _t(a):
    return torch.tensor(np.asarray(a))


def _module_from_jax(module, params, stats, prefix, out):
    if isinstance(module, ConvBNLeaky):
        out[f"{prefix}.conv_block.0.weight"] = _oihw(params["kernel"])
        out[f"{prefix}.conv_block.1.weight"] = _t(params["scale"])
        out[f"{prefix}.conv_block.1.bias"] = _t(params["bias"])
        out[f"{prefix}.conv_block.1.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.conv_block.1.running_var"] = _t(stats["var"])
        out[f"{prefix}.conv_block.1.num_batches_tracked"] = torch.tensor(0)
    elif isinstance(module, Conv):
        out[f"{prefix}.weight"] = _oihw(params["kernel"])
        out[f"{prefix}.bias"] = _t(params["bias"])
    elif isinstance(module, NearestUpsample):
        pass
    elif isinstance(module, Sequential):
        for i, m in enumerate(module):
            _module_from_jax(m, params[i], stats[i], f"{prefix}.{i}", out)
    elif isinstance(module, DarkNetBlock):
        _module_from_jax(module.conv, params, stats, f"{prefix}.conv", out)
    elif isinstance(module, DarkNet53):
        for name in module.stage_names:
            _module_from_jax(getattr(module, name), params[name], stats[name],
                             f"{prefix}.{name}", out)
    else:
        raise TypeError(f"no JAX mapping for {type(module).__name__}")


def variables_from_jax(model, variables):
    """JAX ``{"params", "batch_stats"}`` (numpy leaves) -> the port's state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {}
    for name in model.module_names():
        _module_from_jax(getattr(model, name), params[name], stats[name], name, out)
    return out


def load_reference_state_dict(model, state_dict):
    """Load a reference-layout state dict (tensors or numpy arrays, optionally
    wrapped as ``{"state_dict": ...}``) with ``strict=True``."""
    if "state_dict" in state_dict and not hasattr(state_dict["state_dict"], "shape"):
        state_dict = state_dict["state_dict"]
    sd = {k: v if isinstance(v, torch.Tensor) else _t(v) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def init_random(model, seed=0):
    """Seeded random weights: every conv kernel (and head bias) uniform in
    +-1/sqrt(fan_in); BatchNorm at scale 1, bias 0, mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, ConvBNLeaky):
            conv, bn = m.conv_block
            w = conv.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            w.uniform_(-bound, bound, generator=gen)
            bn.reset_parameters()
        elif isinstance(m, Conv):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=gen)
            m.bias.uniform_(-bound, bound, generator=gen)
    return model
