"""Offline COCO annotation converter (counterpart of
``orienmask_tpu/utils/prepare_dataset.py``).

Turns ``instances_*.json`` into the per-file-name annotation dict the
datasets read (normalized cxcywh boxes, label ids, raw segmentations and
the image id) and a shuffled list file; crowd and degenerate boxes are
dropped.

    python -m orienmask_tpu_torch.utils.prepare_dataset [base_dir]
"""

import json
import os
import random
import sys


class COCOConverter:
    def __init__(self, image_dir, anno_file, label_file, list_file, with_mask=True):
        self.image_dir = image_dir
        self.anno_file = anno_file
        self.label_file = label_file
        self.list_file = list_file
        self.with_mask = with_mask
        os.makedirs(os.path.dirname(self.list_file), exist_ok=True)
        self._create_index()

    def _create_index(self):
        with open(self.anno_file) as fh:
            self.coco = json.load(fh)
        self.cat2label = {c["id"]: i for i, c in enumerate(self.coco["categories"])}
        self.img2idx = {im["id"]: i for i, im in enumerate(self.coco["images"])}
        self.img2anno = {image_id: [] for image_id in self.img2idx}
        for i, ann in enumerate(self.coco["annotations"]):
            self.img2anno[ann["image_id"]].append(i)

    def create_dataset_list(self, seed=0):
        names = list(self.generate_bbox_mask())
        random.seed(seed)
        random.shuffle(names)
        with open(self.list_file, "w") as fh:
            fh.write("\n".join(names))

    def generate_bbox_mask(self):
        anno_dict = {}
        for image_id, image_idx in self.img2idx.items():
            info = self.coco["images"][image_idx]
            height, width = info["height"], info["width"]
            bboxes, cats, masks = [], [], []
            for ai in self.img2anno[image_id]:
                ann = self.coco["annotations"][ai]
                if ann.get("iscrowd") or ann.get("area", 0) < 1:
                    continue
                x, y, w, h = ann["bbox"]
                bbox = [(x + w / 2) / width, (y + h / 2) / height, w / width, h / height]
                if bbox[2] < 1e-8 or bbox[3] < 1e-8:
                    continue
                bboxes.append(bbox)
                cats.append(self.cat2label[ann["category_id"]])
                if self.with_mask:
                    masks.append(ann["segmentation"])
            name = info["file_name"]
            anno_dict[name] = {"anno": {"bbox": bboxes, "cls": cats}, "image_id": image_id}
            if self.with_mask:
                anno_dict[name]["anno"]["mask"] = masks
        with open(self.label_file, "w") as fh:
            json.dump(anno_dict, fh)
        return anno_dict.keys()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    base_dir = argv[0] if argv else "coco"
    for data_type in ("val", "train"):
        conv = COCOConverter(
            os.path.join(base_dir, f"{data_type}2017"),
            os.path.join(base_dir, f"annotations/instances_{data_type}2017.json"),
            os.path.join(base_dir, f"annotations/orienmask_coco_{data_type}.json"),
            os.path.join(base_dir, f"list/coco_{data_type}.txt"),
            with_mask=True,
        )
        conv.create_dataset_list(seed=3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
