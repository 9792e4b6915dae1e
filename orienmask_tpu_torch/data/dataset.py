"""The COCO and VOC class tables (counterpart of the class attributes of
``orienmask_tpu/data/dataset.py``): the infer CLI's COCO-format dump maps
label ids to category ids through ``CAT2LABEL``.  The file-backed datasets
themselves are not ported yet (ROADMAP Queue 1 item 4)."""


class COCODataset:
    # label id -> COCO category id
    CAT2LABEL = [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17,
        18, 19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53,
        54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73,
        74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
    ]

    CLASSES = [
        'person', 'bicycle', 'car', 'motorbike', 'aeroplane', 'bus', 'train', 'truck',
        'boat', 'traffic-light', 'fire-hydrant', 'stop-sign', 'parking-meter', 'bench',
        'bird', 'cat', 'dog', 'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra',
        'giraffe', 'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee', 'skis',
        'snowboard', 'sports-ball', 'kite', 'baseball-bat', 'baseball-glove', 'skateboard',
        'surfboard', 'tennis-racket', 'bottle', 'wine-glass', 'cup', 'fork', 'knife',
        'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
        'hot-dog', 'pizza', 'donut', 'cake', 'chair', 'sofa', 'potted-plant', 'bed',
        'dining-table', 'toilet', 'tv-monitor', 'laptop', 'mouse', 'remote', 'keyboard',
        'cell-phone', 'microwave', 'oven', 'toaster', 'sink', 'refrigerator', 'book',
        'clock', 'vase', 'scissors', 'teddy-bear', 'hair-drier', 'toothbrush',
    ]


class VOCDataset(COCODataset):
    CAT2LABEL = list(range(1, 21))

    CLASSES = [
        'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat', 'chair',
        'cow', 'dining-table', 'dog', 'horse', 'motorbike', 'person', 'potted-plant',
        'sheep', 'sofa', 'train', 'tv-monitor',
    ]
