"""Conv/BN/leaky building blocks (counterpart of ``orienmask_tpu/models/layers.py``).

Modules keep the reference state-dict keys: ``{prefix}.conv_block.0.weight``
and ``conv_block.1.{weight,bias,running_mean,running_var}`` for
``ConvBNLeaky``, ``{prefix}.weight``/``.bias`` for ``Conv``.  Every
convolution runs through ``conv2d`` (and the ResNet max pool through
``max_pool_3x3_s2``), which take their halo rows from the neighbours
under a space group (``parallel/spatial.py``).

Inference runs on BN-folded weights: ``fold()`` returns a nested structure of
``{"weight", "bias"}`` tensors (``{"weight", "bias_f32"}`` for ``Conv``)
mirroring the module tree (the JAX ``fold`` pytree), and
``apply_folded(folded, x, dtype)`` runs it.  Training runs the unfolded
``forward(x, dtype)`` (JAX ``apply``): BatchNorm takes the batch statistics
in train mode and the running ones in eval mode (``module.train()`` /
``.eval()``); under a process group the batch statistics are the global
batch's (``sync_batch_norm``).  Activations are NCHW (channels_last in
memory on the card); convolutions run in ``dtype`` and the prediction heads
(``Conv``) emit f32, as in JAX.

int8 (``models/quantize.py``): a ConvBNLeaky leaf ``{qkernel, in_inv,
oscale, bias}`` runs as ``quantize_i8`` of its input, an exact int8 x int8
-> int32 convolution (``ops/int8_conv.py``), ``y * oscale + bias`` in f32,
leaky, and a cast to the compute dtype.  Rematerialization
(``models/darknet.py``) reruns a stage's forward in the backward; a
``StageReplay`` makes that rerun use the batch statistics of the first pass
and leave the running buffers as the first pass left them.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from ..utils.envs import initialized

BN_EPS = 1e-5
LEAKY_SLOPE = 0.1


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def cast(x, dtype):
    """``x.to(dtype)``, left out where ``x`` has that dtype already: the same
    tensor, and no operator in a ``torch.export`` graph, where each no-op
    ``.to`` is two (an assert and the cast: 370 of the 809 operators of the
    full model's bf16 program)."""
    return x if x.dtype == dtype else x.to(dtype)


def shard_padding(x, ksize, stride, padding):
    """(input, padding) of a ``ksize`` convolution with symmetric
    ``padding``: ``x`` and ``padding`` as they are, or under an active space
    group (``parallel/spatial.py::SpaceGroup.active``), where ``x`` is a row
    shard, ``x`` with its neighbours' rows (``padding`` from above,
    ``ksize - padding - stride`` from below; the convolution's zeros at the
    image's edges) and the padding of the columns alone."""
    space = spatial.active()
    if space is None:
        return x, padding
    return space.halo(x, padding, ksize - padding - stride), (0, padding)


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """``F.conv2d`` with symmetric ``padding``, row-sharded under a space
    group (``shard_padding``): every float convolution of the port's models
    goes through here; with no space group it is the plain call."""
    x, padding = shard_padding(x, weight.shape[-2], stride, padding)
    return F.conv2d(x, weight, bias, stride, padding, 1, groups)


def max_pool_3x3_s2(x):
    """3x3 max pool, stride 2, padded with -inf (JAX ``resnet._maxpool_3x3_s2``,
    which ``F.max_pool2d``'s implicit padding is); under a space group the
    row above comes from the neighbour (-inf at the image's top)."""
    space = spatial.active()
    if space is None:
        return F.max_pool2d(x, 3, 2, 1)
    return F.max_pool2d(space.halo(x, 1, 0, fill=float("-inf")), 3, 2, (0, 1))


def quantize_i8(x, in_inv):
    """Symmetric per-tensor int8 quantization of an activation (JAX
    ``layers.quantize_i8``): ``round(x * in_inv)`` in f32, half to even,
    clamped to [-127, 127]."""
    return torch.clamp(torch.round(x.float() * in_inv), -127, 127).to(torch.int8)


class Sequential(nn.Sequential):
    """``nn.Sequential`` whose children fold and run folded in order."""

    def fold(self):
        return [m.fold() for m in self]

    def apply_folded(self, folded, x, dtype):
        for m, f in zip(self, folded):
            x = m.apply_folded(f, x, dtype)
        return x

    def forward(self, x, dtype):
        for m in self:
            x = m(x, dtype)
        return x


class ConvBNLeaky(nn.Module):
    """conv (no bias) + BatchNorm + LeakyReLU(0.1).

    ``forward``'s BatchNorm is ``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5)
    on the conv output in the compute dtype, as JAX ``bn_act``: statistics
    in f32, the biased variance for the normalisation and the unbiased one
    for the running variance.  JAX takes the variance as E[y²] - E[y]² and
    applies the affine in the compute dtype; BatchNorm2d reduces in another
    order and, under bf16, applies the affine in f32 and rounds once.
    Under a process group, train mode runs ``sync_batch_norm`` on the same
    module instead: the JAX formula over the global batch.

    ``observer`` (set by ``models/quantize.py::calibrate_folded`` while it
    runs) is called with each float folded conv's input; ``replay`` is the
    ``StageReplay`` of a rematerialized stage call while one runs."""

    observer = None
    replay = None

    def __init__(self, cin, cout, ksize, stride=1, padding=0, activation="leaky"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.activation = activation
        self.conv_block = nn.Sequential(
            nn.Conv2d(cin, cout, ksize, stride, padding, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS),
        )

    def fold(self):
        """BN folded into the conv (JAX ``ConvBNLeaky.fold``), f32."""
        conv, bn = self.conv_block
        inv = bn.weight.detach() * torch.rsqrt(bn.running_var + BN_EPS)
        weight = conv.weight.detach() * inv[:, None, None, None]
        bias = bn.bias.detach() - bn.running_mean * inv
        return {"weight": weight, "bias": bias}

    def apply_folded(self, folded, x, dtype):
        if "qkernel" in folded:
            # int8 leaf: the dequantization's multiply and add round apart,
            # as JAX's do (imported here: ``ops`` imports this module)
            from ..ops.int8_conv import conv2d_int8

            # a shard's halo rows arrive in the compute dtype, then quantize
            x, padding = shard_padding(x, folded["qkernel"].shape[-2], self.stride, self.padding)
            y = conv2d_int8(quantize_i8(x, folded["in_inv"]), folded["qkernel"], self.stride,
                            padding)
            y = y.float() * folded["oscale"][:, None, None] + folded["bias"][:, None, None]
            y = leaky_relu(y) if self.activation == "leaky" else y
            return y.to(dtype)
        if self.observer is not None:
            self.observer(x)
        # Stays in the compute dtype between folded convs; the bias is added
        # in that dtype, as JAX's apply_folded does (the pipeline has cast it).
        y = conv2d(cast(x, dtype), folded["weight"], cast(folded["bias"], dtype),
                   self.stride, self.padding)
        return leaky_relu(y) if self.activation == "leaky" else y

    def forward(self, x, dtype):
        conv, bn = self.conv_block
        y = conv2d(x.to(dtype), conv.weight.to(dtype), None, self.stride, self.padding)
        if bn.training and initialized():
            y = sync_batch_norm(y, bn, self.replay)
        elif bn.training and self.replay is not None and self.replay.replaying:
            # the call bn(y) makes, with throwaway running buffers
            y = F.batch_norm(y, bn.running_mean.clone(), bn.running_var.clone(), bn.weight,
                             bn.bias, True, bn.momentum, bn.eps)
        else:
            y = bn(y)
        return leaky_relu(y) if self.activation == "leaky" else y


class StageReplay:
    """One rematerialized stage call: the two contexts of
    ``torch.utils.checkpoint``'s ``context_fn``.  The first pass runs as
    usual (under a process group its BatchNorms' global sums are kept); the
    recompute in the backward runs each train-mode BatchNorm on the same
    batch statistics (the kept sums, with no collective) and leaves the
    running buffers and ``num_batches_tracked`` as the first pass left
    them.  JAX's ``jax.checkpoint`` needs none of this: its statistics are
    outputs, not state."""

    def __init__(self, stage):
        self.layers = [m for m in stage.modules() if isinstance(m, ConvBNLeaky)]
        self.sums = {}
        self.replaying = False

    @contextlib.contextmanager
    def _active(self, replaying):
        self.replaying = replaying
        for m in self.layers:
            m.replay = self
        try:
            yield
        finally:
            for m in self.layers:
                m.replay = None

    def contexts(self):
        return self._active(False), self._active(True)


class _GlobalSums(torch.autograd.Function):
    """(Σy, Σy², count) per channel over the global batch, in f32: one
    ``all_reduce`` of all three in the forward (the count too, since the
    ranks' shapes may differ: a space group's row shards are uneven), one
    of the sums' gradients in the backward (each rank's loss reaches the
    sums through its own outputs; the global loss is the sum of the
    ranks').  With no process group the sums are the rank's own."""

    @staticmethod
    def forward(ctx, y, kept=None):
        """``kept``: the sums of the first pass, in a rematerialized
        stage's recompute (no collective then)."""
        if kept is None:
            yf = y.float()
            count = y.new_full((1,), y.shape[0] * y.shape[2] * y.shape[3], dtype=torch.float32)
            sums = torch.cat([yf.sum((0, 2, 3)), yf.square().sum((0, 2, 3)), count])
            if initialized():
                dist.all_reduce(sums)
        else:
            sums = torch.cat(kept)
        ctx.save_for_backward(y)
        c = y.shape[1]
        return sums[:c], sums[c:2 * c], sums[2 * c]

    @staticmethod
    def backward(ctx, g_sum, g_sum_sq, g_count):
        (y,) = ctx.saved_tensors
        g = torch.stack([g_sum, g_sum_sq])
        if initialized():
            dist.all_reduce(g)
        dy = g[0][None, :, None, None] + 2.0 * y.float() * g[1][None, :, None, None]
        return dy.to(y.dtype), None


def sync_batch_norm(y, bn, replay=None):
    """Train-mode BatchNorm of ``y`` (N, C, H, W) over every rank's batch,
    with ``bn``'s affine and running buffers, as JAX ``bn_act`` computes it
    on a global batch (``orienmask_tpu/models/layers.py:170-183``): mean and
    E[y²] in f32, var = E[y²] - E[y]² to normalise, the running variance
    unbiased with the global count, the affine in ``y``'s dtype.  The count
    is summed with the sums, so ranks of different shapes (a space group's
    uneven row shards) count every pixel once.  With no process group it is
    the same formula on the rank's batch (the ResNet BatchNorm's).  Not
    ``nn.SyncBatchNorm``: it refuses CPU tensors and takes another formula.
    In a ``StageReplay``'s recompute the first pass's sums serve and the
    buffers stay as they are."""
    replaying = replay is not None and replay.replaying
    s, s_sq, count = _GlobalSums.apply(y, replay.sums[id(bn)] if replaying else None)
    if replay is not None and not replaying:
        replay.sums[id(bn)] = (s.detach(), s_sq.detach(), count.detach()[None])
    mean, mean_sq = s / count, s_sq / count
    var = mean_sq - mean.square()
    if not replaying:
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var
                                 + m * (var * (count / (count - 1).clamp_min(1))))
            bn.num_batches_tracked += 1
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * inv
    return y * inv.to(y.dtype)[None, :, None, None] + shift.to(y.dtype)[None, :, None, None]


class Conv(nn.Module):
    """Plain conv with bias (prediction heads): conv in ``dtype``, then f32
    plus the f32 bias."""

    def __init__(self, cin, cout, ksize, stride=1, padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, ksize, ksize))
        self.bias = nn.Parameter(torch.empty(cout))

    def fold(self):
        return {"weight": self.weight.detach(), "bias_f32": self.bias.detach()}

    def apply_folded(self, folded, x, dtype):
        y = conv2d(cast(x, dtype), folded["weight"], None, self.stride, self.padding)
        return y.float() + folded["bias_f32"][:, None, None]

    def forward(self, x, dtype):
        y = conv2d(x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        return y.float() + self.bias[:, None, None]


class NearestUpsample(nn.Module):
    """Nearest-neighbour x``scale`` upsample (an exact copy for integer scales)."""

    def __init__(self, scale_factor):
        super().__init__()
        self.scale = int(scale_factor)

    def fold(self):
        return {}

    def apply_folded(self, folded, x, dtype):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")

    def forward(self, x, dtype):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


def upsample_matrix(out_size, in_size, align_corners=False):
    """Dense 1-D bilinear interpolation matrix (out_size, in_size) with
    ``F.interpolate(mode='bilinear')`` source coordinates, clipped to the
    input as JAX ``layers.upsample_matrix`` does."""
    m = np.zeros((out_size, in_size), np.float32)
    if align_corners and out_size > 1:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m[np.arange(out_size), lo] += 1 - frac
    m[np.arange(out_size), hi] += frac
    return m


def resize_matrices(in_hw, out_hw, align_corners, device):
    """(mh (out_h, in_h), mw (out_w, in_w)) f32 tensors on ``device``."""
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    mh = torch.from_numpy(upsample_matrix(out_h, in_h, align_corners))
    mw = torch.from_numpy(upsample_matrix(out_w, in_w, align_corners))
    return mh.to(device), mw.to(device)


def resize_nhwc(x, mh, mw):
    """NHWC ``x`` resized by the matrices of ``resize_matrices``: along H
    first, then W, as JAX ``layers.bilinear_resize``."""
    b, in_h, in_w, c = x.shape
    y = torch.matmul(mh, x.reshape(b, in_h, in_w * c)).reshape(b, mh.shape[0], in_w, c)
    return torch.matmul(mw, y)


def bilinear_resize(x, out_h, out_w, align_corners=False):
    """Bilinear resize of NHWC f32 ``x`` to (out_h, out_w) as two matmuls.
    ``F.interpolate`` rounds differently and is not used."""
    mh, mw = resize_matrices(x.shape[1:3], (out_h, out_w), align_corners, x.device)
    return resize_nhwc(x, mh, mw)
