"""DarkNet-53 backbone (counterpart of ``orienmask_tpu/models/darknet.py``).

Stem conv + 5 stride-2 stages with (1, 2, 8, 8, 4) residual blocks; returns
the (x32, x16, x8, x4) feature pyramid with (1024, 512, 256, 128) channels.
Only the plain master convolutions are ported: the JAX space-to-depth phase
stem reformulates them for the TPU's matrix unit, and cuDNN takes the master
convolutions as they are.
"""

from torch import nn

from .layers import ConvBNLeaky, Sequential


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

    def __init__(self, stage_blocks=None):
        super().__init__()
        blocks = tuple(int(n) for n in (stage_blocks or self.STAGE_BLOCKS))
        self.conv1 = ConvBNLeaky(3, 32, 3, padding=1)
        for i, (c, n) in enumerate(zip(self.STAGE_CHANNELS, blocks), start=2):
            layers = [ConvBNLeaky(c, c * 2, 3, stride=2, padding=1)]
            layers += [DarkNetBlock(c) for _ in range(n)]
            setattr(self, f"conv{i}", Sequential(*layers))
        self.stage_names = [f"conv{i}" for i in range(1, 7)]

    def fold(self):
        return {n: getattr(self, n).fold() for n in self.stage_names}

    def apply_folded(self, folded, x, dtype):
        return self._stages(
            lambda name, x: getattr(self, name).apply_folded(folded[name], x, dtype), x)

    def forward(self, x, dtype):
        return self._stages(lambda name, x: getattr(self, name)(x, dtype), x)

    def _stages(self, run, x):
        feats = {}
        for name in self.stage_names:
            x = run(name, x)
            feats[name] = x
        return feats["conv6"], feats["conv5"], feats["conv4"], feats["conv3"]
