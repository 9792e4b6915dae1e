"""The port's own copy of the named inference (544² and 736²), train and
test configs.

Same dicts and names as ``orienmask_tpu.config`` (``config/base.py``,
``config/config_infer.py``, ``config/config_train.py`` and
``config/config_test.py`` there); ``tests/test_torch_models.py`` holds the
copy equal to the original.
"""

import copy

# ImageNet statistics (the train transform's pad value).
MEAN = [123.675, 116.280, 103.530]

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


def construct_config(config, update=None, pop=None):
    """A copy of ``config`` with ``update`` deep-merged into it (dict values
    key by key, other values replaced) and the dotted paths of ``pop``
    removed, e.g. ``"model.pretrained"``."""
    out = copy.deepcopy(config)
    for key, value in (update or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = construct_config(out[key], update=value)
        else:
            out[key] = value
    for path in pop or ():
        node = out
        *parents, leaf = path.split(".")
        for part in parents:
            node = node[part]
        node.pop(leaf)
    return out


# The base model (models/orienmask_yolo.py).
orienmask_yolo_coco = dict(
    type="OrienMaskYOLO",
    num_anchors=3,
    num_classes=80,
    pretrained="checkpoints/pretrained/pretrained_darknet53.pth",
    freeze_backbone=False,
    backbone_batchnorm_eval=False,
)

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

# The 736² streaming/video variant: its own grid and image size.
transform_infer_736 = construct_config(
    transform_infer_544,
    update=dict(pipeline=[
        dict(type="Resize", size=(736, 736), interpolation="bilinear",
             align_corners=False),
        dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255)),
    ]),
)

orienmask_yolo_coco_736_anchor4_postprocess = construct_config(
    orienmask_yolo_coco_544_anchor4_postprocess,
    update=dict(grid_size=[[23, 23], [46, 46], [92, 92]], image_size=[736, 736]),
)

# The visualizer block: the infer CLI's -v (and --video -o) builds
# utils/visualizer.py::InferenceVisualizer from it.
coco_visualizer = dict(
    type="InferenceVisualizer",
    dataset="COCO",
    with_mask=True,
    conf_thresh=0.3,
    alpha=0.6,
    line_thickness=1,
)

# The published model (anchor-v4 priors + FPN-plus orientation path) with the
# twostage candidate selection of the speed-headline infer configs.
orienmask_yolo_coco_544_anchor4_fpn_plus_infer = dict(
    n_device=1,
    compute_dtype="bfloat16",
    model=orienmask_yolo_fpn_plus_coco,
    transform=transform_infer_544,
    postprocess=dict(orienmask_yolo_coco_544_anchor4_postprocess,
                     topk_mode="twostage"),
    visualizer=coco_visualizer,
)

# ------------------------------------------------------------------- train

coco_train_dataset = dict(
    type="COCODataset",
    list_file="coco/list/coco_train.txt",
    image_dir="coco/train2017",
    anno_file="coco/annotations/orienmask_coco_train.json",
    with_mask=True,
    with_info=False,
)

coco_val_dataset = dict(
    type="COCODataset",
    list_file="coco/list/coco_val.txt",
    image_dir="coco/val2017",
    anno_file="coco/annotations/orienmask_coco_val.json",
    with_mask=True,
    with_info=True,
)

transform_train_544 = dict(
    type="COCOTransform",
    pipeline=[
        dict(type="ColorJitter", brightness=0.2, contrast=0.5, saturation=0.5, hue=0.1),
        dict(type="RandomCrop", p=0.5, image_min_iou=0.64, bbox_min_iou=0.64),
        dict(type="Resize", size=(544, 544), pad_needed=True, warp_p=0.25, jitter=0.3,
             random_place=True, pad_p=0.75, pad_ratio=0.75, pad_value=MEAN),
        dict(type="RandomHorizontalFlip", p=0.5),
        dict(type="ToArray"),
        dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255)),
    ],
)

transform_val_544 = dict(
    type="COCOTransform",
    pipeline=[
        dict(type="Resize", size=(544, 544), pad_needed=False, warp_p=0., jitter=0.,
             random_place=False, pad_p=0., pad_ratio=0., pad_value=MEAN),
        dict(type="ToArray"),
        dict(type="Normalize", mean=(0, 0, 0), std=(255, 255, 255)),
    ],
)

# Per-device batch of 8 images, at most 100 instances each, masks bit-packed.
coco_544_train_loader = dict(
    type="DataLoader",
    dataset=coco_train_dataset,
    transform=transform_train_544,
    batch_size=8,
    num_workers=4,
    shuffle=True,
    max_instances=100,
    pack_masks=True,
    collate=dict(type="collate"),
)

coco_544_val_loader = dict(
    type="DataLoader",
    dataset=coco_val_dataset,
    transform=transform_val_544,
    batch_size=8,
    num_workers=4,
    shuffle=False,
    max_instances=100,
    pack_masks=True,
    collate=dict(type="collate"),
)

coco_val2017_gt_file = "coco/annotations/instances_val2017.json"

orienmask_yolo_coco_544_loss = dict(
    type="OrienMaskYOLOMultiScaleLoss",
    grid_size=[[17, 17], [34, 34], [68, 68]],
    image_size=[544, 544],
    anchors=ANCHORS_YOLOV3,
    anchor_mask=ANCHORS_MASK,
    num_classes=80,
    center_region=0.6,
    valid_region=0.6,
    label_smooth=False,
    obj_ignore_threshold=0.7,
    weight=[1, 1, 1, 1, 1, 20, 20],
    scales_weight=[1, 1, 1],
)

orienmask_yolo_coco_544_anchor4_loss = dict(
    copy.deepcopy(orienmask_yolo_coco_544_loss), anchors=ANCHORS_YOLOV4)

base_sgd = dict(
    type="SGD",
    lr=1e-3,
    momentum=0.9,
    weight_decay=5e-4,
)

# Milestones count optimizer iterations, not epochs.
step_lr_warmup_coco_e100 = dict(
    type="StepWarmUpLR",
    warmup_type="linear",
    warmup_iter=1000,
    warmup_ratio=0.1,
    milestones=[520000, 660000],
    gamma=0.1,
)

# The published model's train config.  Effective batch = n_device *
# batch_size * accumulate = 2 * 8 * 1 = 16; one card runs one device's share.
orienmask_yolo_coco_544_anchor4_fpn_plus = dict(
    name="OrienMaskAnchor4FPNPlus",
    n_device=2,
    epochs=100,
    accumulate=1,
    monitor="segm_AP",
    monitor_mode="max",
    log_dir="checkpoints",
    val_freq=5,
    save_freq=20,
    log_freq=50,
    seed=0,
    trainer="Trainer",
    compute_dtype="float32",
    model=orienmask_yolo_fpn_plus_coco,
    train_loader=coco_544_train_loader,
    val_loader=coco_544_val_loader,
    val_gt_file=coco_val2017_gt_file,
    loss=orienmask_yolo_coco_544_anchor4_loss,
    postprocess=orienmask_yolo_coco_544_anchor4_postprocess,
    optimizer=base_sgd,
    lr_scheduler=step_lr_warmup_coco_e100,
)

orienmask_yolo_coco_544_anchor4 = construct_config(
    orienmask_yolo_coco_544_anchor4_fpn_plus,
    update=dict(name="OrienMaskAnchor4", model=orienmask_yolo_coco),
)

orienmask_yolo_coco_544 = construct_config(
    orienmask_yolo_coco_544_anchor4,
    update=dict(
        name="OrienMaskBase",
        loss=orienmask_yolo_coco_544_loss,
        postprocess=orienmask_yolo_coco_544_postprocess,
    ),
)

# -------------------------------------------------------------------- test

# COCO evaluation of the published model: f32, batch 16, the exact
# candidate selection of the postprocess block.
orienmask_yolo_coco_544_anchor4_fpn_plus_test = dict(
    n_device=1,
    tester="Tester",
    compute_dtype="float32",
    model=orienmask_yolo_coco_544_anchor4_fpn_plus["model"],
    test_loader=construct_config(
        orienmask_yolo_coco_544_anchor4_fpn_plus["val_loader"],
        update=dict(batch_size=16),
    ),
    postprocess=orienmask_yolo_coco_544_anchor4_fpn_plus["postprocess"],
    gt_file=orienmask_yolo_coco_544_anchor4_fpn_plus["val_gt_file"],
)

orienmask_yolo_coco_544_anchor4_test = construct_config(
    orienmask_yolo_coco_544_anchor4_fpn_plus_test,
    update=dict(model=orienmask_yolo_coco_544_anchor4["model"]),
)

orienmask_yolo_coco_544_test = construct_config(
    orienmask_yolo_coco_544_anchor4_test,
    update=dict(postprocess=orienmask_yolo_coco_544["postprocess"]),
)

# ----------------------------------------------------------- more infer

orienmask_yolo_coco_544_anchor4_infer = construct_config(
    orienmask_yolo_coco_544_anchor4_fpn_plus_infer,
    update=dict(model=orienmask_yolo_coco_544_anchor4["model"]),
)

orienmask_yolo_coco_544_infer = construct_config(
    orienmask_yolo_coco_544_anchor4_infer,
    update=dict(postprocess=dict(orienmask_yolo_coco_544["postprocess"],
                                 topk_mode="twostage")),
)

# Streaming (video) inference at 736², two frames in flight (stream.py).
orienmask_yolo_coco_736_anchor4_fpn_plus_infer = construct_config(
    orienmask_yolo_coco_544_anchor4_fpn_plus_infer,
    update=dict(
        transform=transform_infer_736,
        postprocess=dict(orienmask_yolo_coco_736_anchor4_postprocess,
                         topk_mode="twostage"),
        stream_depth=2,
    ),
)
