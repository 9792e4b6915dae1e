"""Weight bridge and seeded init (counterpart of ``orienmask_tpu/models/convert.py``).

* ``variables_from_jax``: the JAX ``{"params", "batch_stats"}`` pytree, as
  numpy arrays (HWIO kernels; ``scale``/``bias``/``mean``/``var``), to the
  port's state dict.  The port's own copy of the mapping.
* ``variables_to_jax``: its inverse, the port's state dict to the JAX
  pytree (lists for ``Sequential``s, ``{}`` where a module holds nothing),
  which checkpoints are written in.
* ``folded_from_jax``: a JAX ``fold``/``quantize_folded`` tree (numpy
  leaves, HWIO kernels, int8 leaves) to the port's folded tree, so that
  both packages run the same folded or int8 weights.
* ``load_pretrained_backbone``: a DarkNet-53 ``.pth`` into the backbone,
  with the JAX package's key handling and messages.
* ``load_reference_state_dict``: a reference-layout ``.pth`` state dict
  (OIHW kernels, ``conv_block.{0,1}`` keys), loaded with ``strict=True``.
* ``resnet_from_jax``: a JAX ResNet's (params, stats) to the port's
  ResNet state dict (torchvision's keys).
* ``init_random``: seeded random weights from a ``torch.Generator``, the
  JAX init's distributions (torch's kaiming-uniform(a=sqrt(5)) bound
  1/sqrt(fan_in), BN at identity); no weights file is needed.
"""

import math
import os

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
    """``stats`` None: the parameters alone."""
    if isinstance(module, ConvBNLeaky):
        out[f"{prefix}.conv_block.0.weight"] = _oihw(params["kernel"])
        out[f"{prefix}.conv_block.1.weight"] = _t(params["scale"])
        out[f"{prefix}.conv_block.1.bias"] = _t(params["bias"])
        if stats is not None:
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
            _module_from_jax(m, params[i], None if stats is None else stats[i],
                             f"{prefix}.{i}", out)
    elif isinstance(module, DarkNetBlock):
        _module_from_jax(module.conv, params, stats, f"{prefix}.conv", out)
    elif isinstance(module, DarkNet53):
        for name in module.stage_names:
            _module_from_jax(getattr(module, name), params[name],
                             None if stats is None else stats[name], f"{prefix}.{name}", out)
    else:
        raise TypeError(f"no JAX mapping for {type(module).__name__}")


def variables_from_jax(model, variables):
    """JAX ``{"params", "batch_stats"}`` (numpy leaves) -> the port's state
    dict; ``batch_stats`` None gives the parameters alone (an SGD momentum
    tree, say)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = {}
    for name in model.module_names():
        _module_from_jax(getattr(model, name), params[name],
                         None if stats is None else stats[name], name, out)
    return out


def _copy(t):
    return t.detach().clone(memory_format=torch.contiguous_format)


def _module_to_jax(module, sd, prefix):
    """(params, stats) of ``module`` in the JAX layout from state dict ``sd``."""
    if isinstance(module, ConvBNLeaky):
        return ({"kernel": _copy(sd[f"{prefix}.conv_block.0.weight"].permute(2, 3, 1, 0)),
                 "scale": _copy(sd[f"{prefix}.conv_block.1.weight"]),
                 "bias": _copy(sd[f"{prefix}.conv_block.1.bias"])},
                {"mean": _copy(sd[f"{prefix}.conv_block.1.running_mean"]),
                 "var": _copy(sd[f"{prefix}.conv_block.1.running_var"])})
    if isinstance(module, Conv):
        return ({"kernel": _copy(sd[f"{prefix}.weight"].permute(2, 3, 1, 0)),
                 "bias": _copy(sd[f"{prefix}.bias"])}, {})
    if isinstance(module, NearestUpsample):
        return {}, {}
    if isinstance(module, Sequential):
        pairs = [_module_to_jax(m, sd, f"{prefix}.{i}") for i, m in enumerate(module)]
        return [p for p, _ in pairs], [s for _, s in pairs]
    if isinstance(module, DarkNetBlock):
        return _module_to_jax(module.conv, sd, f"{prefix}.conv")
    if isinstance(module, DarkNet53):
        params, stats = {}, {}
        for name in module.stage_names:
            params[name], stats[name] = _module_to_jax(getattr(module, name), sd,
                                                       f"{prefix}.{name}")
        return params, stats
    raise TypeError(f"no JAX mapping for {type(module).__name__}")


def variables_to_jax(model, state_dict=None):
    """The port's state dict (``model.state_dict()`` by default) -> the JAX
    ``{"params", "batch_stats"}`` pytree, HWIO kernels; the leaves are
    contiguous copies, on the state dict's device."""
    sd = model.state_dict() if state_dict is None else state_dict
    params, stats = {}, {}
    for name in model.module_names():
        params[name], stats[name] = _module_to_jax(getattr(model, name), sd, name)
    return {"params": params, "batch_stats": stats}


def _folded_from_jax(module, tree):
    if isinstance(module, ConvBNLeaky):
        if "qkernel" in tree:
            return {"qkernel": _oihw(tree["qkernel"]),
                    **{k: torch.tensor(np.asarray(tree[k], np.float32))
                       for k in ("in_inv", "oscale", "bias")}}
        return {"weight": _oihw(np.asarray(tree["kernel"], np.float32)),
                "bias": torch.tensor(np.asarray(tree["bias"], np.float32))}
    if isinstance(module, Conv):
        return {"weight": _oihw(np.asarray(tree["kernel"], np.float32)),
                "bias_f32": torch.tensor(np.asarray(tree["bias"], np.float32))}
    if isinstance(module, NearestUpsample):
        return {}
    if isinstance(module, Sequential):
        return [_folded_from_jax(m, t) for m, t in zip(module, tree)]
    if isinstance(module, DarkNetBlock):
        return _folded_from_jax(module.conv, tree)
    if isinstance(module, DarkNet53):
        return {name: _folded_from_jax(getattr(module, name), tree[name])
                for name in module.stage_names}
    raise TypeError(f"no JAX mapping for {type(module).__name__}")


def folded_from_jax(model, tree):
    """A JAX folded tree (``model.fold``, a pipeline's ``folded`` or
    ``quantize_folded``'s; numpy leaves) -> the port's ``model.fold()``
    tree, host tensors: float kernels f32 (a bf16 kernel's values exact),
    biases f32, int8 leaves as ``models/quantize.py`` makes them.  Keys
    the port does not use (the phase stem's derived kernels) are left
    out."""
    return {name: _folded_from_jax(getattr(model, name), tree[name])
            for name in model.module_names()}


def _convbn_from_jax(params, stats, conv, bn, out):
    out[f"{conv}.weight"] = _oihw(params["kernel"])
    out[f"{bn}.weight"] = _t(params["scale"])
    out[f"{bn}.bias"] = _t(params["bias"])
    out[f"{bn}.running_mean"] = _t(stats["mean"])
    out[f"{bn}.running_var"] = _t(stats["var"])
    out[f"{bn}.num_batches_tracked"] = torch.tensor(0)


def resnet_from_jax(params, stats):
    """A JAX ``ResNet``'s (params, stats) (numpy leaves: ``stem`` and
    ``layer{i}`` lists of blocks, HWIO kernels) -> the port's ResNet state
    dict, torchvision's keys (the inverse of JAX ``resnet_from_torch``)."""
    out = {}
    _convbn_from_jax(params["stem"], stats["stem"], "conv1", "bn1", out)
    for i in range(1, 5):
        for j, (bp, bs) in enumerate(zip(params[f"layer{i}"], stats[f"layer{i}"])):
            prefix = f"layer{i}.{j}"
            for name in sorted(k for k in bp if k.startswith("conv")):
                k = name[len("conv"):]
                _convbn_from_jax(bp[name], bs[name], f"{prefix}.conv{k}", f"{prefix}.bn{k}", out)
            if "downsample" in bp:
                _convbn_from_jax(bp["downsample"], bs["downsample"], f"{prefix}.downsample.0",
                                 f"{prefix}.downsample.1", out)
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


def load_pretrained_backbone(model, path):
    """DarkNet-53 weights from a ``.pth`` state dict (bare or under
    ``state_dict``; keys with or without ``backbone.``) into
    ``model.backbone``, parameters and running statistics.  A missing file
    or key is skipped with the JAX package's message, the backbone kept as
    it was; a key of another shape raises."""
    if not os.path.exists(path):
        print(f"[DarkNet53] pretrained file not found, skipping: {path}")
        return model
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()}
    own = model.backbone.state_dict()
    wanted = [k for k in own if not k.endswith("num_batches_tracked")]
    missing = [k for k in wanted if k not in sd]
    if missing:
        print(f"[DarkNet53] pretrained load failed (missing key {missing[0]!r}), skipping")
        return model
    loaded = dict(own)
    for k in wanted:
        value = sd[k] if isinstance(sd[k], torch.Tensor) else _t(sd[k])
        if tuple(value.shape) != tuple(own[k].shape):
            raise ValueError(f"[DarkNet53] pretrained {path}: {k} has shape "
                             f"{tuple(value.shape)}, the backbone's is {tuple(own[k].shape)}")
        loaded[k] = value
    model.backbone.load_state_dict(loaded, strict=True)
    print(f"[DarkNet53] loaded pretrained backbone from {path}")
    return model
