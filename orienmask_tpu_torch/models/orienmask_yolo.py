"""OrienMaskYOLO, the base model variant (counterpart of
``orienmask_tpu/models/orienmask_yolo.py``).

FPNPlus's bbox path; the orientation path upsamples neck8 once (``route8``:
a 1x1 ConvBNLeaky halving the channels, then nearest x2) and concatenates
it with the backbone's stride-4 feature before ``neck4`` and the shared
orientation head.  The JAX code concatenates ``[route, skip]`` on its last
(NHWC) axis, which is ``dim=1`` here.
"""

import torch

from .layers import ConvBNLeaky, NearestUpsample, Sequential
from .orienmask_yolo_fpnplus import BaseOrienMask, build_bbox_head, build_neck, build_orien_head


def build_half_route(channels):
    return Sequential(ConvBNLeaky(channels, channels // 2, 1), NearestUpsample(2))


class OrienMaskYOLO(BaseOrienMask):
    HEAD_NAMES = (
        "neck32", "neck16", "neck8", "neck4", "route32", "route16", "route8",
        "bbox_head8", "bbox_head16", "bbox_head32", "orien_head",
    )

    def __init__(self, num_anchors, num_classes, backbone_stage_blocks=None,
                 freeze_backbone=False, backbone_batchnorm_eval=False):
        super().__init__(num_anchors, num_classes, backbone_stage_blocks, freeze_backbone,
                         backbone_batchnorm_eval)
        bbox_dim = num_anchors * (5 + num_classes)
        self.neck32 = build_neck(1024, 512)
        self.neck16 = build_neck(768, 256)
        self.neck8 = build_neck(384, 128)
        self.neck4 = build_neck(192, 128)
        self.route32 = build_half_route(512)
        self.route16 = build_half_route(256)
        self.route8 = build_half_route(128)
        self.bbox_head8 = build_bbox_head(128, bbox_dim)
        self.bbox_head16 = build_bbox_head(256, bbox_dim)
        self.bbox_head32 = build_bbox_head(512, bbox_dim)
        self.orien_head = build_orien_head(128, num_anchors * 6)

    def _orientation(self, run, neck32, neck16, neck8, x4):
        return run("neck4", torch.cat([run("route8", neck8), x4], dim=1))
