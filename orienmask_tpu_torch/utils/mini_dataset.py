"""A small COCO-layout dataset on disk, and train and test configs for it,
written without cv2 (the port's counterpart of ``tools/make_mini_dataset.py``).

    python -m orienmask_tpu_torch.utils.mini_dataset <root> [--n-images 16]
        [--sizes 480x640,427x613] [--size 544] [--batch-size 8]
        [--stage-blocks 1,1,1,1,1]
    python -m orienmask_tpu_torch.train -c <root>/config.json [--device cpu]
    python -m orienmask_tpu_torch.test -c <root>/test_config.json \\
        -w <root>/runs/<run>/best_model.ckpt [--device cpu]

Scenes are seeded: a noise background and 2-6 instances, each an ellipse
or a convex polygon in its class's colour, later ones occluding earlier
ones.  Images are PNG (``data/image_io.py::write_png``).  The ground truth
is a COCO ``instances`` json: an instance that nothing occludes keeps its
polygon, the others their visible mask as compressed RLE (``eval/rle.py``),
boxes tight around what is visible.  ``utils/prepare_dataset.py`` turns it
into the annotation file and the list file the datasets read.

The train config is the published one (``orienmask_yolo_coco_544_anchor4_
fpn_plus``) pointed at these files, the training set validated on itself,
with the overrides given; at another ``size`` its transforms, grids and
anchors are scaled to it.  The CLI writes it for one device, 2 epochs,
inline loading and no ``pretrained`` file.  The test config evaluates the
same set.
"""

import argparse
import copy
import json
import os
import sys

import numpy as np

from .. import config as configs
from ..data.dataset import COCODataset
from ..data.image_io import write_png
from ..eval import rle
from .prepare_dataset import COCOConverter

# one colour a class, spread over the cube so that classes can be learned
_PALETTE = np.random.default_rng(12345).integers(60, 256, (80, 3))


def _ellipse(rng, height, width):
    ys, xs = np.mgrid[0:height, 0:width]
    rx, ry = rng.uniform(0.08, 0.3) * width, rng.uniform(0.08, 0.3) * height
    cx, cy = rng.uniform(rx, width - rx), rng.uniform(ry, height - ry)
    return (((xs + 0.5 - cx) / rx) ** 2 + ((ys + 0.5 - cy) / ry) ** 2 <= 1).astype(np.uint8)


def _polygon(rng, height, width):
    """A convex polygon of 3-7 vertices on an ellipse, as COCO's flat list."""
    rx, ry = rng.uniform(0.08, 0.3) * width, rng.uniform(0.08, 0.3) * height
    cx, cy = rng.uniform(rx, width - rx), rng.uniform(ry, height - ry)
    angles = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 8))))
    xy = np.stack([cx + rx * np.cos(angles), cy + ry * np.sin(angles)], 1)
    return [[round(float(v), 2) for v in xy.ravel()]]


def make_scene(rng, height, width, image_id, num_classes, first_ann_id):
    """(uint8 image, COCO annotations) of one seeded scene."""
    image = rng.integers(0, 60, (height, width, 3)).astype(np.uint8)
    instances = []  # (label, visible mask, polygon or None)
    for _ in range(int(rng.integers(2, 7))):
        label = int(rng.integers(0, num_classes))
        polygon = _polygon(rng, height, width) if rng.random() < 0.5 else None
        mask = (rle.polygons_to_mask(polygon, height, width) if polygon is not None
                else _ellipse(rng, height, width)).astype(bool)
        if not mask.any():
            continue
        for _, earlier, _ in instances:
            earlier &= ~mask
        image[mask] = np.clip(_PALETTE[label] + rng.integers(-15, 16, 3), 0, 255)
        instances.append((label, mask, polygon))
    anns = []
    for label, mask, polygon in instances:
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        x1, y1 = int(xs.min()), int(ys.min())
        whole = polygon is not None and np.array_equal(
            mask, rle.polygons_to_mask(polygon, height, width).astype(bool))
        anns.append({
            "id": first_ann_id + len(anns), "image_id": image_id,
            "category_id": COCODataset.CAT2LABEL[label],
            "bbox": [float(x1), float(y1), float(xs.max() + 1 - x1), float(ys.max() + 1 - y1)],
            "area": float(mask.sum()), "iscrowd": 0,
            "segmentation": polygon if whole else rle.encode(mask.astype(np.uint8)),
        })
    return image, anns


def write_mini_dataset(root, n_images=16, sizes=((480, 640),), seed=0, num_classes=80):
    """Write the dataset under ``root``; returns its paths: ``image_dir``,
    ``gt_file`` (COCO instances), ``anno_file`` and ``list_file`` (the
    datasets' own).  Image ``i`` has size ``sizes[i % len(sizes)]``."""
    root = str(root)
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n_images):
        height, width = sizes[i % len(sizes)]
        image, scene = make_scene(rng, height, width, i, num_classes, len(anns) + 1)
        name = f"{i:012d}.png"
        write_png(os.path.join(image_dir, name), image)
        images.append({"id": i, "file_name": name, "height": height, "width": width})
        anns += scene
    categories = [{"id": cat, "name": name} for cat, name in
                  zip(COCODataset.CAT2LABEL[:num_classes], COCODataset.CLASSES)]
    paths = {"image_dir": image_dir, "gt_file": os.path.join(root, "instances.json"),
             "anno_file": os.path.join(root, "annos.json"),
             "list_file": os.path.join(root, "list", "mini.txt")}
    with open(paths["gt_file"], "w") as fh:
        json.dump({"images": images, "annotations": anns, "categories": categories}, fh)
    COCOConverter(image_dir, paths["gt_file"], paths["anno_file"],
                  paths["list_file"]).create_dataset_list(seed=seed)
    return paths


def _scale(block, size, base_size):
    """A loss or postprocess block moved from ``base_size``² to ``size``²:
    grids, image size and anchors."""
    block = copy.deepcopy(block)
    block["grid_size"] = [[size // 32] * 2, [size // 16] * 2, [size // 8] * 2]
    block["image_size"] = [size, size]
    block["anchors"] = [[a * size / base_size for a in anchor] for anchor in block["anchors"]]
    return block


def _resized(transform, size):
    transform = copy.deepcopy(transform)
    for step in transform["pipeline"]:
        if step["type"] == "Resize":
            step["size"] = (size, size)
    return transform


def mini_config(paths, log_dir, size=None, **updates):
    """The published train config on the dataset at ``paths``, trained and
    validated on its whole set, logging to ``log_dir``; at ``size``² if
    given; ``updates`` deep-merged last."""
    cfg = copy.deepcopy(configs.orienmask_yolo_coco_544_anchor4_fpn_plus)
    files = {"list_file": paths["list_file"], "image_dir": paths["image_dir"],
             "anno_file": paths["anno_file"]}
    cfg["train_loader"]["dataset"].update(files)
    cfg["val_loader"]["dataset"].update(files)
    cfg.update(name="mini", log_dir=str(log_dir), val_gt_file=paths["gt_file"])
    if size is not None:
        base_size = cfg["loss"]["image_size"][0]
        for key in ("loss", "postprocess"):
            cfg[key] = _scale(cfg[key], size, base_size)
        for key in ("train_loader", "val_loader"):
            cfg[key]["transform"] = _resized(cfg[key]["transform"], size)
    return configs.construct_config(cfg, update=updates)


def mini_test_config(train_config, batch_size=None):
    """The test config of ``mini_config``'s model on its validation set."""
    loader = copy.deepcopy(train_config["val_loader"])
    if batch_size is not None:
        loader["batch_size"] = batch_size
    return {"n_device": 1, "tester": "Tester",
            "compute_dtype": train_config.get("compute_dtype", "float32"),
            "model": copy.deepcopy(train_config["model"]), "test_loader": loader,
            "postprocess": copy.deepcopy(train_config["postprocess"]),
            "gt_file": train_config["val_gt_file"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--n-images", type=int, default=16)
    ap.add_argument("--sizes", default="480x640,427x613",
                    help="image sizes HxW, comma-separated, taken in turn")
    ap.add_argument("--size", type=int, default=None, help="train resolution (default 544)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--stage-blocks", default=None,
                    help="DarkNet-53 stage depths, e.g. 1,1,1,1,1 (default: published)")
    args = ap.parse_args(argv)

    sizes = [tuple(int(v) for v in s.split("x")) for s in args.sizes.split(",")]
    paths = write_mini_dataset(args.root, args.n_images, sizes)
    loader = {"batch_size": args.batch_size, "num_workers": 0}
    updates = {"n_device": 1, "epochs": 2, "val_freq": 1, "save_freq": 1,
               "log_freq": 1, "train_loader": loader, "val_loader": loader,
               "model": {"pretrained": None}}
    if args.stage_blocks:
        updates["model"]["backbone_stage_blocks"] = [int(v) for v in args.stage_blocks.split(",")]
    cfg = mini_config(paths, os.path.join(args.root, "runs"), size=args.size, **updates)
    with open(os.path.join(args.root, "config.json"), "w") as fh:
        json.dump(cfg, fh, indent=1)
    with open(os.path.join(args.root, "test_config.json"), "w") as fh:
        json.dump(mini_test_config(cfg), fh, indent=1)
    print(f"dataset and configs at {args.root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
