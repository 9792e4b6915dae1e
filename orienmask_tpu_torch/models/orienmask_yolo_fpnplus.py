"""OrienMaskYOLOFPNPlus, the published model variant (counterpart of
``orienmask_tpu/models/orienmask_yolo_fpnplus.py``).

YOLOv3-style bbox path over three scales plus an orientation path that
gathers skip connections from all scales into a stride-4 neck feeding a
shared orientation head.  ``apply_folded`` returns three (bbox_s, orien_s)
NCHW tuples at strides 32/16/8 (channels_last in memory on the card, so
``.permute(0, 2, 3, 1)`` gives the JAX (B, H, W, C) layout as a view);
``forward``, the unfolded train/eval path, returns them in that layout.
``BaseOrienMask`` holds what the base variant (``orienmask_yolo.py``)
shares with this one.
"""

import torch
from torch import nn

from .darknet import DarkNet53
from .layers import Conv, ConvBNLeaky, NearestUpsample, Sequential


def build_neck(cin, cout):
    return Sequential(
        ConvBNLeaky(cin, cout, 1),
        ConvBNLeaky(cout, cout * 2, 3, padding=1),
        ConvBNLeaky(cout * 2, cout, 1),
        ConvBNLeaky(cout, cout * 2, 3, padding=1),
        ConvBNLeaky(cout * 2, cout, 1),
    )


def build_route(cin, cout, upsample):
    return Sequential(ConvBNLeaky(cin, cout, 1), NearestUpsample(upsample))


def build_bbox_head(cin, cout):
    return Sequential(ConvBNLeaky(cin, cin * 2, 3, padding=1), Conv(cin * 2, cout, 1))


def build_orien_head(cin, cout):
    return Sequential(
        ConvBNLeaky(cin, cin * 2, 3, padding=1),
        ConvBNLeaky(cin * 2, cin, 1),
        ConvBNLeaky(cin, cin * 2, 3, padding=1),
        ConvBNLeaky(cin * 2, cin, 1),
        ConvBNLeaky(cin, cin * 2, 3, padding=1),
        Conv(cin * 2, cout, 1),
    )


class BaseOrienMask(nn.Module):
    """What the two OrienMask variants share: the DarkNet-53 backbone, the
    YOLOv3 bbox path over three scales, and ``fold``/``apply_folded``/
    ``forward``.  A variant builds its heads in ``__init__`` in the order of
    its ``HEAD_NAMES`` (the JAX variant's module order, which ``init_random``
    draws in) and runs its orientation path in ``_orientation``."""

    HEAD_NAMES = ()

    def __init__(self, num_anchors, num_classes, backbone_stage_blocks=None,
                 freeze_backbone=False, backbone_batchnorm_eval=False):
        super().__init__()
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        self.backbone = DarkNet53(backbone_stage_blocks, freeze_backbone,
                                  backbone_batchnorm_eval)

    def module_names(self):
        return ("backbone",) + self.HEAD_NAMES

    @torch.no_grad()
    def fold(self):
        """BN-folded f32 weights for every module (JAX ``fold``)."""
        return {n: getattr(self, n).fold() for n in self.module_names()}

    def apply_folded(self, folded, x, dtype):
        """x: (B, 3, H, W) normalized image -> three (bbox, orien) NCHW pairs;
        bbox heads and the orientation head emit f32."""
        feats = self.backbone.apply_folded(folded["backbone"], x, dtype)
        return self._heads(
            lambda name, inp: getattr(self, name).apply_folded(folded[name], inp, dtype), feats)

    def forward(self, x, dtype=torch.float32, remat=False):
        """Unfolded forward (JAX ``apply``), BatchNorm by ``self.training``;
        ``remat`` rematerializes the backbone's stages in training (JAX's
        ``ctx['remat']``).  x: (B, 3, H, W) -> three (bbox, orien) pairs in
        the JAX layout (B, h, w, C) that the loss reshapes (views of
        channels_last NCHW)."""
        feats = self.backbone(x, dtype, remat)
        predict = self._heads(lambda name, inp: getattr(self, name)(inp, dtype), feats)
        return tuple((b.permute(0, 2, 3, 1), o.permute(0, 2, 3, 1)) for b, o in predict)

    def _heads(self, run, feats):
        x32, x16, x8, x4 = feats
        neck32 = run("neck32", x32)
        neck16 = run("neck16", torch.cat([run("route32", neck32), x16], dim=1))
        neck8 = run("neck8", torch.cat([run("route16", neck16), x8], dim=1))
        bbox32 = run("bbox_head32", neck32)
        bbox16 = run("bbox_head16", neck16)
        bbox8 = run("bbox_head8", neck8)
        oriens = run("orien_head", self._orientation(run, neck32, neck16, neck8, x4))
        a2 = self.num_anchors * 2
        return (
            (bbox32, oriens[:, :a2]),
            (bbox16, oriens[:, a2:2 * a2]),
            (bbox8, oriens[:, 2 * a2:]),
        )


class OrienMaskYOLOFPNPlus(BaseOrienMask):
    HEAD_NAMES = (
        "neck32", "neck16", "neck8", "neck4", "route32", "route16",
        "bbox_head8", "bbox_head16", "bbox_head32",
        "skip32", "skip16", "skip8", "skip4", "orien_head",
    )

    def __init__(self, num_anchors, num_classes, backbone_stage_blocks=None,
                 freeze_backbone=False, backbone_batchnorm_eval=False):
        super().__init__(num_anchors, num_classes, backbone_stage_blocks, freeze_backbone,
                         backbone_batchnorm_eval)
        bbox_dim = num_anchors * (5 + num_classes)
        self.neck32 = build_neck(1024, 512)
        self.neck16 = build_neck(768, 256)
        self.neck8 = build_neck(384, 128)
        self.neck4 = build_neck(256, 128)
        self.route32 = build_route(512, 256, 2)
        self.route16 = build_route(256, 128, 2)
        self.bbox_head8 = build_bbox_head(128, bbox_dim)
        self.bbox_head16 = build_bbox_head(256, bbox_dim)
        self.bbox_head32 = build_bbox_head(512, bbox_dim)
        self.skip32 = build_route(512, 64, 8)
        self.skip16 = build_route(256, 64, 4)
        self.skip8 = build_route(128, 64, 2)
        self.skip4 = ConvBNLeaky(128, 64, 1)
        self.orien_head = build_orien_head(128, num_anchors * 6)

    def _orientation(self, run, neck32, neck16, neck8, x4):
        return run("neck4", torch.cat(
            [run("skip32", neck32), run("skip16", neck16), run("skip8", neck8),
             run("skip4", x4)], dim=1))
