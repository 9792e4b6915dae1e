"""ResNet backbone family (counterpart of ``orienmask_tpu/models/resnet.py``).

torchvision's ResNet, ResNeXt and WideResNet in torchvision's module layout
and names (``conv1``/``bn1``, ``layer{i}.{j}.conv{k}``/``bn{k}``,
``downsample.0``/``.1``), so a torchvision state dict loads as it is
(``load_torchvision``, the JAX ``resnet_from_torch``), returning the
(x32, x16, x8, x4) feature pyramid with (512, 256, 128, 64) x expansion
channels.  No shipped config selects it.

Every conv is followed by BatchNorm in f32 (JAX ``ConvBN``: the conv in
the compute dtype, its output cast to f32): eval mode applies
``y * inv + (bias - mean * inv)`` with ``inv = scale * rsqrt(var + eps)``;
train mode takes the batch statistics by JAX's formula (E[y²] - E[y]² in
f32, the running variance unbiased by the count) through
``layers.sync_batch_norm``, which sums over every rank under a process
group.  Convolutions and the 3x3/2 max pool (-inf padding) go through
``layers.conv2d``/``layers.max_pool_3x3_s2``, so a space group's halo
rows reach them.

``frozen_stages`` (an int: 1 freezes the stem, 2 the stem and layer1, ...)
and ``batchnorm_eval`` follow JAX: a frozen stage's BatchNorms, and with
``batchnorm_eval`` every BatchNorm, run on their running statistics in
training (``train()`` keeps them in eval mode); ``frozen_stages()`` names
the stages whose parameters the optimizer's mask holds.
"""

import os

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv2d, max_pool_3x3_s2, sync_batch_norm


def conv_bn(conv, bn, x, dtype):
    """``conv`` in ``dtype``, then ``bn`` in f32 (JAX ``ConvBN.apply``)."""
    y = conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride[0], conv.padding[0],
               conv.groups).float()
    if bn.training:
        return sync_batch_norm(y, bn)
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return y * inv[:, None, None] + (bn.bias - bn.running_mean * inv)[:, None, None]


class ConvBN(nn.Sequential):
    """conv (no bias) + BatchNorm as ``.0``/``.1`` (torchvision's
    ``downsample``)."""

    def __init__(self, cin, cout, ksize, stride=1, padding=0, groups=1):
        super().__init__(nn.Conv2d(cin, cout, ksize, stride, padding, groups=groups, bias=False),
                         nn.BatchNorm2d(cout))

    def forward(self, x, dtype):
        return conv_bn(self[0], self[1], x, dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1, base_width=64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, base_width=64")
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = ConvBN(cin, planes, 1, stride) if downsample else None

    def forward(self, x, dtype):
        y = F.relu(conv_bn(self.conv1, self.bn1, x, dtype))
        y = conv_bn(self.conv2, self.bn2, y, dtype)
        if self.downsample is not None:
            x = self.downsample(x, dtype)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = ConvBN(cin, cout, 1, stride) if downsample else None

    def forward(self, x, dtype):
        y = F.relu(conv_bn(self.conv1, self.bn1, x, dtype))
        y = F.relu(conv_bn(self.conv2, self.bn2, y, dtype))
        y = conv_bn(self.conv3, self.bn3, y, dtype)
        if self.downsample is not None:
            x = self.downsample(x, dtype)
        return F.relu(x + y)


class Stage(nn.Sequential):
    """``layer{i}``: blocks run in order."""

    def forward(self, x, dtype):
        for block in self:
            x = block(x, dtype)
        return x


class ResNet(nn.Module):
    """Backbone returning (x32, x16, x8, x4) with (512, 256, 128, 64) x
    expansion channels (JAX ``ResNet``)."""

    def __init__(self, block, layers, groups=1, width_per_group=64, pretrained=None,
                 frozen_stages=0, batchnorm_eval=False):
        super().__init__()
        self.n_frozen_stages = int(frozen_stages or 0)
        self.batchnorm_eval = bool(batchnorm_eval)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, n in enumerate(layers):
            planes = 64 * 2 ** i
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(n):
                ds = j == 0 and (stride != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, stride if j == 0 else 1, ds, groups,
                                    width_per_group))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", Stage(*blocks))
        self.out_channels = tuple(64 * 2 ** i * block.expansion for i in reversed(range(4)))
        if pretrained:
            if os.path.exists(pretrained):
                sd = torch.load(pretrained, map_location="cpu", weights_only=False)
                if isinstance(sd, dict) and "state_dict" in sd \
                        and not hasattr(sd["state_dict"], "shape"):
                    sd = sd["state_dict"]
                load_torchvision(self, sd)
            else:
                print(f"[ResNet] pretrained file not found, skipping: {pretrained}")

    def get_output_channels(self):
        return self.out_channels

    def frozen_stages(self):
        """Stage names whose parameters are frozen (JAX's names: ``stem``,
        then ``layer1`` ...), the protocol of ``DarkNet53.frozen_stages``."""
        names = ["stem"] if self.n_frozen_stages >= 1 else []
        return names + [f"layer{i - 1}" for i in range(2, self.n_frozen_stages + 1)]

    def stage_modules(self, name):
        """The modules of a stage named by ``frozen_stages``."""
        return [self.conv1, self.bn1] if name == "stem" else [getattr(self, name)]

    def stage_parameters(self, name):
        return [p for m in self.stage_modules(name) for p in m.parameters()]

    def train(self, mode=True):
        super().train(mode)
        if mode:
            frozen = self.frozen_stages()
            for name in ["stem"] + [f"layer{i}" for i in range(1, 5)]:
                if self.batchnorm_eval or name in frozen:
                    for m in self.stage_modules(name):
                        for bn in m.modules():
                            if isinstance(bn, nn.BatchNorm2d):
                                bn.eval()
        return self

    def forward(self, x, dtype=torch.float32):
        """x: (B, 3, H, W) -> (x32, x16, x8, x4), f32."""
        y = max_pool_3x3_s2(F.relu(conv_bn(self.conv1, self.bn1, x, dtype)))
        feats = []
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y, dtype)
            feats.append(y)
        x4, x8, x16, x32 = feats
        return x32, x16, x8, x4


def load_torchvision(model, state_dict):
    """A torchvision ResNet state dict (``fc.*`` and other keys the backbone
    lacks are ignored) into ``model``, parameters and running statistics.
    A missing key or a key of another shape raises."""
    own = model.state_dict()
    loaded = dict(own)
    for k, t in own.items():
        if k.endswith("num_batches_tracked") and k not in state_dict:
            continue
        if k not in state_dict:
            raise KeyError(f"[ResNet] state dict lacks {k!r}")
        value = torch.as_tensor(state_dict[k])
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"[ResNet] {k} has shape {tuple(value.shape)}, the model's is "
                             f"{tuple(t.shape)}")
        loaded[k] = value
    model.load_state_dict(loaded, strict=True)
    return model


def _factory(block, layers, **defaults):
    def make(**kwargs):
        return ResNet(block, layers, **dict(defaults, **kwargs))
    return make


resnet18 = _factory(BasicBlock, [2, 2, 2, 2])
resnet34 = _factory(BasicBlock, [3, 4, 6, 3])
resnet50 = _factory(Bottleneck, [3, 4, 6, 3])
resnet101 = _factory(Bottleneck, [3, 4, 23, 3])
resnet152 = _factory(Bottleneck, [3, 8, 36, 3])
resnext50_32x4d = _factory(Bottleneck, [3, 4, 6, 3], groups=32, width_per_group=4)
resnext101_32x8d = _factory(Bottleneck, [3, 4, 23, 3], groups=32, width_per_group=8)
wide_resnet50_2 = _factory(Bottleneck, [3, 4, 6, 3], width_per_group=128)
wide_resnet101_2 = _factory(Bottleneck, [3, 4, 23, 3], width_per_group=128)

FACTORIES = {name: globals()[name] for name in (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2")}
