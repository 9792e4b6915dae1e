"""Synthetic COCO-style eval sets and an in-memory loader for ``Tester``.

The scenes are drawn as ``tools/synthetic_ap.py::make_scenes`` draws them:
class-coloured axis-aligned rectangles and ellipses on a noise background,
later instances occluding earlier ones, each box tightened to its visible
mask.  The ground truth is a COCO ``instances`` dict whose segmentations are
RLE-encoded by the port's codec, so ``LiteCOCOeval`` scores it like a COCO
annotation file.
"""

import numpy as np

from ..eval import rle

CLASS_COLORS = np.array([
    [0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9], [0.9, 0.9, 0.1],
    [0.9, 0.1, 0.9], [0.1, 0.9, 0.9], [0.8, 0.5, 0.2], [0.5, 0.2, 0.8],
], np.float32)


def make_scenes(rng, n, size, num_classes=80, instances=(2, 5)):
    """``n`` scenes of ``size``² -> (images (n, size, size, 3) uint8, infos,
    ground-truth dict).  Instances per scene uniform in ``instances``
    [low, high); each is one of the first ``len(CLASS_COLORS)`` classes,
    coloured by class; categories are ``1..num_classes``."""
    images = rng.normal(0.0, 0.08, (n, size, size, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:size, 0:size] / size
    infos, anns = [], []
    for b in range(n):
        masks, classes = [], []
        for _ in range(int(rng.integers(*instances))):
            bw, bh = rng.uniform(0.15, 0.55, 2)
            cx = rng.uniform(bw / 2 + 0.02, 0.98 - bw / 2)
            cy = rng.uniform(bh / 2 + 0.02, 0.98 - bh / 2)
            c = int(rng.integers(0, len(CLASS_COLORS)))
            if rng.random() < 0.5:  # rectangle
                m = (np.abs(xs - cx) <= bw / 2) & (np.abs(ys - cy) <= bh / 2)
            else:  # ellipse
                m = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1.0
            for earlier in masks:  # later instances occlude earlier ones
                earlier &= ~m
            images[b][m] = CLASS_COLORS[c] + rng.normal(0, 0.05, 3).astype(np.float32)
            masks.append(m)
            classes.append(c)
        for m, c in zip(masks, classes):
            if not m.any():  # fully occluded
                continue
            ys_k, xs_k = np.nonzero(m)
            x1, x2, y1, y2 = xs_k.min(), xs_k.max() + 1, ys_k.min(), ys_k.max() + 1
            anns.append({
                "id": len(anns) + 1, "image_id": b, "category_id": c + 1,
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "area": float(m.sum()), "iscrowd": 0,
                "segmentation": rle.encode(m.astype(np.uint8)),
            })
        infos.append({"id": b, "height": size, "width": size})
    gt = {"images": [{"id": i["id"], "height": size, "width": size} for i in infos],
          "categories": [{"id": c + 1, "name": f"class{c}"} for c in range(num_classes)],
          "annotations": anns}
    images = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    return images, infos, gt


class ArrayDataset:
    """What ``Tester`` reads of a dataset: class names, the label -> COCO
    category map and whether masks are evaluated."""

    def __init__(self, classes, cat2label, with_mask=True):
        self.CLASSES = list(classes)
        self.CAT2LABEL = list(cat2label)
        self.with_mask = with_mask


class ArrayLoader:
    """Batches ``{"image": (B, H, W, 3), "info": [dict] * B}`` of in-memory
    images, in order.  The last batch is wrap-padded to ``batch_size`` with
    infos marked ``_pad``, as the JAX loader's ``pad_last`` does, so every
    batch has one shape and evaluation skips the padding."""

    def __init__(self, images, infos, batch_size, dataset):
        self.images = images
        self.infos = list(infos)
        self.batch_size = batch_size
        self.dataset = dataset

    def __len__(self):
        return -(-len(self.infos) // self.batch_size)

    def __iter__(self):
        n, bs = len(self.infos), self.batch_size
        for start in range(0, n, bs):
            idx = list(range(start, min(start + bs, n)))
            pad = bs - len(idx)
            idx += list(range(pad))
            infos = [dict(self.infos[i]) for i in idx]
            for info in infos[bs - pad:]:
                info["_pad"] = True
            yield {"image": self.images[idx], "info": infos}
