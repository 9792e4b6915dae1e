"""The port's own copy of what the 544² inference config needs.

Same dicts and names as ``orienmask_tpu.config`` (``config/base.py`` and
``config/config_infer.py`` there); ``tests/test_torch_models.py`` holds the
copy equal to the original.
"""

import copy

# Per-scale anchor index groups: scale-32 owns anchors 6..8, scale-16 owns
# 3..5, scale-8 owns 0..2.
ANCHORS_MASK = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]

# Anchor priors in input-image pixels.
ANCHORS_YOLOV3 = [
    [10, 13], [16, 30], [33, 23],
    [30, 61], [62, 45], [59, 119],
    [116, 90], [156, 198], [373, 326],
]
ANCHORS_YOLOV4 = [
    [12, 16], [19, 36], [40, 28],
    [36, 75], [76, 55], [72, 146],
    [142, 110], [192, 243], [459, 401],
]

orienmask_yolo_fpn_plus_coco = dict(
    type="OrienMaskYOLOFPNPlus",
    num_anchors=3,
    num_classes=80,
    pretrained="checkpoints/pretrained/pretrained_darknet53.pth",
    freeze_backbone=False,
    backbone_batchnorm_eval=False,
)

# Resize + normalize on the device (data/transform.py FastCOCOTransform).
transform_infer_544 = dict(
    type="FastCOCOTransform",
    pipeline=[
        dict(type="Resize", size=(544, 544), interpolation="bilinear",
             align_corners=False),
        dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255)),
    ],
)

orienmask_yolo_coco_544_postprocess = dict(
    type="OrienMaskYOLOPostProcess",
    grid_size=[[17, 17], [34, 34], [68, 68]],
    image_size=[544, 544],
    anchors=ANCHORS_YOLOV3,
    anchor_mask=ANCHORS_MASK,
    num_classes=80,
    conf_thresh=0.005,
    nms=dict(type="batched_nms", threshold=0.5),
    nms_pre=400,
    nms_post=100,
    orien_thresh=0.3,
    topk_mode="exact",
)

orienmask_yolo_coco_544_anchor4_postprocess = dict(
    copy.deepcopy(orienmask_yolo_coco_544_postprocess), anchors=ANCHORS_YOLOV4)

# The published model (anchor-v4 priors + FPN-plus orientation path) with the
# twostage candidate selection of the speed-headline infer configs.
orienmask_yolo_coco_544_anchor4_fpn_plus_infer = dict(
    n_device=1,
    compute_dtype="bfloat16",
    model=orienmask_yolo_fpn_plus_coco,
    transform=transform_infer_544,
    postprocess=dict(orienmask_yolo_coco_544_anchor4_postprocess,
                     topk_mode="twostage"),
)
