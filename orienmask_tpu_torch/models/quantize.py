"""Post-training int8 quantization of the folded inference path
(counterpart of ``orienmask_tpu/models/quantize.py``).

The scheme is JAX's, symmetric:

- weights int8 per output channel, ``wscale[c] = max|K[c]| / 127``;
- activations int8 per tensor, with a static scale from a calibration pass
  (``calibrate_folded``: each quantized conv's input absmax over a few
  images);
- each quantized ``ConvBNLeaky`` computes ``q = sat_i8(round(x * in_inv))``,
  ``y = conv_i8i8_i32(q, qkernel)``, ``leaky(y * oscale + bias)`` in f32,
  cast to the compute dtype, with ``oscale = in_scale * wscale``
  (``layers.ConvBNLeaky.apply_folded``, ``ops/int8_conv.py``);
- the prediction heads' logit ``Conv``s stay float; ``exclude_stem`` keeps
  conv1, conv2 and conv3[0] float.

The scales are computed in numpy as JAX computes them (``wscale`` float32,
``in_scale`` a Python float, ``in_inv = f32(1 / in_scale)``, ``oscale =
f32(in_scale * wscale)``), so that given the same folded weights and
activation scales ``qkernel``, ``in_inv`` and ``oscale`` are JAX's bit for
bit.  JAX calibrates through its space-to-depth stem on the CPU; the port
through its plain convolutions on the pipeline's device, so calibrated
absmaxes can differ from JAX's in their last bits.

Typical use is one call on a built pipeline::

    pipe = InferencePipeline(model, transform, postprocess)
    pipe.quantize_int8(calib_images)      # (N, H, W, 3) uint8
    dets, pad = pipe(img)                 # same contract, int8 convs
"""

import numpy as np
import torch

from .darknet import DarkNet53, DarkNetBlock
from .layers import ConvBNLeaky, Sequential

# paths (from the model root) whose convs stay float with ``exclude_stem``
_STEM_PREFIXES = (("backbone", "conv1"), ("backbone", "conv2"), ("backbone", "conv3", 0))


def _is_stem(path):
    return any(path[:len(p)] == p for p in _STEM_PREFIXES)


def iter_convbn(module, folded, path=()):
    """Yield (path, ConvBNLeaky, folded leaf) for every folded conv + BN of
    ``module``, along the ``fold()`` tree (JAX's paths: stage and module
    names, list indices; a DarkNetBlock adds none).  The heads' ``Conv``s
    and the upsamples are skipped."""
    if isinstance(module, ConvBNLeaky):
        yield path, module, folded
    elif isinstance(module, Sequential):
        for i, (m, f) in enumerate(zip(module, folded)):
            yield from iter_convbn(m, f, path + (i,))
    elif isinstance(module, DarkNetBlock):
        yield from iter_convbn(module.conv, folded, path)
    elif isinstance(module, DarkNet53):
        for name in module.stage_names:
            yield from iter_convbn(getattr(module, name), folded[name], path + (name,))
    elif hasattr(module, "module_names"):  # a model root
        for name in module.module_names():
            yield from iter_convbn(getattr(module, name), folded[name], path + (name,))


def cast_kernels(folded, dtype):
    """A copy of a ``fold()`` tree with every conv weight cast to ``dtype``
    and the biases as they are: what JAX's pipeline quantizes (its folded
    kernels in the compute dtype, its biases f32)."""
    if isinstance(folded, list):
        return [cast_kernels(f, dtype) for f in folded]
    if "weight" in folded:
        return dict(folded, weight=folded["weight"].to(dtype))
    return {k: cast_kernels(v, dtype) for k, v in folded.items()}


@torch.inference_mode()
def calibrate_folded(model, folded, images, transform=None):
    """Each ConvBNLeaky's input absmax over ``images`` -> {path: absmax}.

    Runs the folded forward in f32 on the device of ``folded`` (its kernels
    in the compute dtype's values, as the pipeline runs them) with each
    conv's observer armed.  ``images``: (N, H, W, 3) uint8 or float raw
    images, or a sequence of (H, W, 3) ones of any sizes; ``transform`` (the
    pipeline's ``FastCOCOTransform``) is applied to each when given."""
    device = folded["backbone"]["conv1"]["weight"].device
    observed = {}

    def observer(path):
        def observe(x):
            a = x.detach().abs().max().float()
            observed[path] = a if path not in observed else torch.maximum(observed[path], a)
        return observe

    convs = [(path, m) for path, m, _ in iter_convbn(model, folded)]
    for path, m in convs:
        m.observer = observer(path)
    try:
        for image in images:
            x = torch.as_tensor(image).to(device).float()[None]
            if transform is not None:
                x = transform.apply(x)
            model.apply_folded(folded, x.permute(0, 3, 1, 2), torch.float32)
    finally:
        for _, m in convs:
            m.observer = None
    return {path: float(a) for path, a in observed.items()}


def quantize_folded(model, folded, act_scales, exclude_stem=False):
    """A copy of ``folded`` (host tensors) in which every ConvBNLeaky with a
    finite, non-zero scale in ``act_scales`` ({path: input absmax}, from
    ``calibrate_folded``), outside the stem if ``exclude_stem``, is the int8
    leaf ``{qkernel int8 (O, I, kh, kw), in_inv f32, oscale (O,) f32, bias
    (O,) f32}``.  Raises when no conv was quantized."""
    def copy(node):
        if isinstance(node, list):
            return [copy(v) for v in node]
        if isinstance(node, dict) and not any(isinstance(v, torch.Tensor) for v in node.values()):
            return {k: copy(v) for k, v in node.items()}
        return node  # a leaf: its tensors are shared

    qfolded = copy(folded)
    n_q = 0
    for path, _, f in iter_convbn(model, folded):
        if exclude_stem and _is_stem(path):
            continue
        amax = act_scales.get(path)
        if not amax or not np.isfinite(amax):
            continue
        k = f["weight"].detach().float().cpu().numpy()
        wscale = np.maximum(np.abs(k).reshape(k.shape[0], -1).max(axis=1), 1e-12) / 127.0
        qk = np.clip(np.rint(k / wscale[:, None, None, None]), -127, 127).astype(np.int8)
        in_scale = float(amax) / 127.0
        node = qfolded
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = {
            "qkernel": torch.from_numpy(qk),
            "in_inv": torch.tensor(np.float32(1.0 / in_scale)),
            "oscale": torch.from_numpy(np.asarray(in_scale * wscale, np.float32)),
            "bias": f["bias"].detach().float().cpu().clone(),
        }
        n_q += 1
    if n_q == 0:
        raise ValueError("no convs were quantized: empty or mismatched calibration scales?")
    return qfolded
