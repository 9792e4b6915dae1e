"""COCO and VOC datasets from files (counterpart of
``orienmask_tpu/data/dataset.py``).

A dataset reads a list file (one image file name a line), an image
directory and the annotation json that ``utils/prepare_dataset.py`` writes
(per file name: normalized cxcywh boxes, label ids, raw COCO segmentations
and the image id).  Images are read as ``cv2.imread`` + BGR2RGB + float32
read them, through ``data/image_io.py`` (JPEG, PNG, PPM, ``.npy``); masks
are decoded from polygons or RLE by the port's codec (``eval/rle.py``).
The class tables also serve the infer CLI's COCO-format dump.
"""

import json
import os

import numpy as np

from ..eval import rle as rle_codec
from .image_io import read_image


class BaseDataset:
    def __init__(self, list_file, image_dir, anno_file, transform):
        with open(list_file) as fh:
            self.samples = [line.strip() for line in fh if line.strip()]
        self.image_dir = image_dir
        self.anno_file = anno_file
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        sample = self._load_sample_data(self.samples[idx])
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def _load_sample_data(self, name):
        raise NotImplementedError


class COCODataset(BaseDataset):
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

    def __init__(self, list_file, image_dir, anno_file, transform=None,
                 with_mask=True, with_info=True):
        super().__init__(list_file, image_dir, anno_file, transform)
        with open(self.anno_file) as fh:
            self.annotations = json.load(fh)
        self.with_mask = with_mask
        self.with_info = with_info

    def _load_sample_data(self, name):
        image = read_image(os.path.join(self.image_dir, name)).astype(np.float32)
        height, width = image.shape[:2]
        entry = self.annotations[name]
        anno = entry["anno"]
        bbox = np.asarray(anno["bbox"], np.float32).reshape(-1, 4)
        cls = np.asarray(anno["cls"], np.int64)
        sample = {"image": image, "bbox": bbox, "cls": cls}
        if self.with_mask:
            sample["mask"] = [self._convert_mask(m, height, width)
                              for m in anno.get("mask", [])]
        if self.with_info:
            sample["info"] = {"id": entry["image_id"], "height": height, "width": width}
        return sample

    @staticmethod
    def _convert_mask(anno, height, width):
        """Polygons, uncompressed RLE or compressed RLE -> (H, W) uint8."""
        if isinstance(anno, list):  # polygons
            return rle_codec.polygons_to_mask(anno, height, width)
        if isinstance(anno.get("counts"), list):  # uncompressed RLE
            return rle_codec.decode({"size": anno["size"], "counts": anno["counts"]})
        return rle_codec.decode(anno)  # compressed RLE string


class VOCDataset(COCODataset):
    CAT2LABEL = list(range(1, 21))

    CLASSES = [
        'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat', 'chair',
        'cow', 'dining-table', 'dog', 'horse', 'motorbike', 'person', 'potted-plant',
        'sheep', 'sofa', 'train', 'tv-monitor',
    ]

    def __init__(self, list_file, image_dir, anno_file, transform=None,
                 with_mask=False, with_info=True):
        super().__init__(list_file, image_dir, anno_file, transform, with_mask, with_info)
