"""DarkNet-53 backbone (counterpart of ``orienmask_tpu/models/darknet.py``).

Stem conv + 5 stride-2 stages with (1, 2, 8, 8, 4) residual blocks; returns
the (x32, x16, x8, x4) feature pyramid with (1024, 512, 256, 128) channels.
Only the plain master convolutions are ported: the JAX space-to-depth phase
stem reformulates them for the TPU's matrix unit, and cuDNN takes the master
convolutions as they are.

``freeze_backbone`` (an int level: stages conv1..convN; ``True`` is 1) and
``batchnorm_eval`` follow JAX: a frozen stage's parameters keep their values
through the optimizer's mask (``trainer/builder.py::_freeze_mask``) and its
BatchNorms run on their running statistics without updating them; with
``batchnorm_eval`` every backbone BatchNorm does.  ``train()`` keeps those
BatchNorms in eval mode, as the reference's ``train`` override does.

``forward(..., remat=True)`` in training rematerializes each stage
(``torch.utils.checkpoint``, non-reentrant): its activations are recomputed
in the backward instead of kept, and a ``layers.StageReplay`` makes the
recompute take the first pass's batch statistics and leave the BatchNorm
buffers alone.  The JAX package puts its space-to-depth stem (conv1-conv3)
into one region; one region a stage is its counterpart here.  Values do not
change, only memory (and the forward runs twice).
"""

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import ConvBNLeaky, Sequential, StageReplay


class DarkNetBlock(nn.Module):
    """Residual 1x1 -> 3x3 block."""

    def __init__(self, channels):
        super().__init__()
        self.conv = Sequential(
            ConvBNLeaky(channels * 2, channels, 1),
            ConvBNLeaky(channels, channels * 2, 3, padding=1),
        )

    def fold(self):
        return self.conv.fold()

    def apply_folded(self, folded, x, dtype):
        return x + self.conv.apply_folded(folded, x, dtype)

    def forward(self, x, dtype):
        return x + self.conv(x, dtype)


class DarkNet53(nn.Module):
    STAGE_BLOCKS = (1, 2, 8, 8, 4)
    STAGE_CHANNELS = (32, 64, 128, 256, 512)

    def __init__(self, stage_blocks=None, freeze_backbone=False, batchnorm_eval=False):
        super().__init__()
        self.freeze_backbone = int(freeze_backbone or 0)
        self.batchnorm_eval = bool(batchnorm_eval)
        blocks = tuple(int(n) for n in (stage_blocks or self.STAGE_BLOCKS))
        self.conv1 = ConvBNLeaky(3, 32, 3, padding=1)
        for i, (c, n) in enumerate(zip(self.STAGE_CHANNELS, blocks), start=2):
            layers = [ConvBNLeaky(c, c * 2, 3, stride=2, padding=1)]
            layers += [DarkNetBlock(c) for _ in range(n)]
            setattr(self, f"conv{i}", Sequential(*layers))
        self.stage_names = [f"conv{i}" for i in range(1, 7)]

    def frozen_stages(self):
        """Names of the stages whose parameters are frozen."""
        return [f"conv{i}" for i in range(1, 7) if self.freeze_backbone >= i]

    def train(self, mode=True):
        super().train(mode)
        if mode:
            frozen = self.frozen_stages()
            for name in self.stage_names:
                if self.batchnorm_eval or name in frozen:
                    for m in getattr(self, name).modules():
                        if isinstance(m, nn.BatchNorm2d):
                            m.eval()
        return self

    def fold(self):
        return {n: getattr(self, n).fold() for n in self.stage_names}

    def apply_folded(self, folded, x, dtype):
        return self._stages(
            lambda name, x: getattr(self, name).apply_folded(folded[name], x, dtype), x)

    def forward(self, x, dtype, remat=False):
        if remat and self.training and torch.is_grad_enabled():
            return self._stages(lambda name, x: _remat_stage(getattr(self, name), x, dtype), x)
        return self._stages(lambda name, x: getattr(self, name)(x, dtype), x)

    def _stages(self, run, x):
        feats = {}
        for name in self.stage_names:
            x = run(name, x)
            feats[name] = x
        return feats["conv6"], feats["conv5"], feats["conv4"], feats["conv3"]


def _remat_stage(stage, x, dtype):
    """``stage(x, dtype)`` under ``torch.utils.checkpoint``; the stages draw
    no random numbers, so no RNG state is kept."""
    return checkpoint(stage, x, dtype, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: StageReplay(stage).contexts())
