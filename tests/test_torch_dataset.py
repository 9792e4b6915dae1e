"""The port's file-backed datasets, annotation converter and mini-dataset
writer (orienmask_tpu_torch/data/dataset.py, utils/prepare_dataset.py,
utils/mini_dataset.py) against orienmask_tpu's on the same files.

The dataset is the port's writer's: 8 seeded scenes at 48x64 and 43x61,
PNG images, a COCO instances json with polygons and RLE.  The JAX package
reads them with cv2 and its own codec; every sample dict (image, boxes,
classes, masks, info) must be identical, and so must the converter's
files.  One image written as JPEG by cv2 is read identically too."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from orienmask_tpu.data.dataset import COCODataset as JaxCOCODataset
from orienmask_tpu.data.dataset import VOCDataset as JaxVOCDataset
from orienmask_tpu.utils.prepare_dataset import COCOConverter as JaxCOCOConverter
from orienmask_tpu_torch.data import COCODataset, VOCDataset
from orienmask_tpu_torch.utils.mini_dataset import write_mini_dataset
from orienmask_tpu_torch.utils.prepare_dataset import COCOConverter

N_IMAGES = 8
SIZES = ((48, 64), (43, 61))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    torch.set_num_threads(1)
    return write_mini_dataset(tmp_path_factory.mktemp("mini"), N_IMAGES, SIZES, seed=0)


def _datasets(paths, cls=(COCODataset, JaxCOCODataset), **kw):
    args = (paths["list_file"], paths["image_dir"], paths["anno_file"])
    return cls[0](*args, **kw), cls[1](*args, **kw)


def _assert_samples_equal(got, want, idx):
    assert got.keys() == want.keys(), idx
    for key in ("image", "bbox", "cls"):
        assert got[key].dtype == want[key].dtype, (idx, key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"sample {idx}: {key}")
    if "mask" in want:
        assert len(got["mask"]) == len(want["mask"]), idx
        for g, w in zip(got["mask"], want["mask"]):
            assert g.dtype == w.dtype, idx
            np.testing.assert_array_equal(g, w, err_msg=f"sample {idx}: mask")
    assert got.get("info") == want.get("info"), idx


def test_writer_makes_a_coco_dataset(paths):
    gt = json.loads(open(paths["gt_file"]).read())
    assert len(gt["images"]) == N_IMAGES and len(gt["categories"]) == 80
    kinds = {"polygon" if isinstance(a["segmentation"], list) else "rle"
             for a in gt["annotations"]}
    assert kinds == {"polygon", "rle"}
    assert {(i["height"], i["width"]) for i in gt["images"]} == set(SIZES)
    names = open(paths["list_file"]).read().split()
    assert sorted(names) == sorted(i["file_name"] for i in gt["images"])


@pytest.mark.parametrize("idx", range(N_IMAGES))
def test_coco_sample_matches_jax(paths, idx):
    got, want = _datasets(paths)
    _assert_samples_equal(got[idx], want[idx], idx)


@pytest.mark.parametrize("with_mask,with_info", [(False, True), (True, False)])
def test_coco_options_match_jax(paths, with_mask, with_info):
    got, want = _datasets(paths, with_mask=with_mask, with_info=with_info)
    assert len(got) == len(want) == N_IMAGES
    _assert_samples_equal(got[1], want[1], 1)


def test_voc_dataset_matches_jax(paths):
    got, want = _datasets(paths, cls=(VOCDataset, JaxVOCDataset))
    assert got.CLASSES == want.CLASSES and got.CAT2LABEL == want.CAT2LABEL
    assert got.with_mask is want.with_mask is False
    _assert_samples_equal(got[2], want[2], 2)


def test_class_tables_match_jax():
    assert COCODataset.CLASSES == JaxCOCODataset.CLASSES
    assert COCODataset.CAT2LABEL == JaxCOCODataset.CAT2LABEL


def test_jpeg_sample_matches_jax(paths, tmp_path):
    """The same scene as a JPEG that cv2 writes: decoded identically."""
    names = open(paths["list_file"]).read().split()
    image = cv2.imread(os.path.join(paths["image_dir"], names[0]))
    jpeg_dir = tmp_path / "jpeg"
    jpeg_dir.mkdir()
    jpeg_name = names[0].replace(".png", ".jpg")
    cv2.imwrite(str(jpeg_dir / jpeg_name), image, [cv2.IMWRITE_JPEG_QUALITY, 90])
    annos = json.loads(open(paths["anno_file"]).read())
    (tmp_path / "annos.json").write_text(json.dumps({jpeg_name: annos[names[0]]}))
    (tmp_path / "list.txt").write_text(jpeg_name)
    args = (tmp_path / "list.txt", str(jpeg_dir), tmp_path / "annos.json")
    _assert_samples_equal(COCODataset(*args)[0], JaxCOCODataset(*args)[0], 0)


def test_converter_matches_jax(paths, tmp_path):
    out = {}
    for name, cls in (("port", COCOConverter), ("jax", JaxCOCOConverter)):
        label, listing = tmp_path / name / "annos.json", tmp_path / name / "list" / "l.txt"
        cls(paths["image_dir"], paths["gt_file"], str(label), str(listing)
            ).create_dataset_list(seed=3)
        out[name] = (label.read_text(), listing.read_text())
    assert out["port"] == out["jax"]


def test_converter_drops_crowd_and_degenerate_boxes(tmp_path):
    gt = {"images": [{"id": 7, "file_name": "a.png", "height": 10, "width": 20}],
          "categories": [{"id": 1}, {"id": 3}],
          "annotations": [
              {"image_id": 7, "category_id": 3, "bbox": [2, 2, 4, 4], "area": 16,
               "iscrowd": 0, "segmentation": [[2, 2, 6, 2, 6, 6]]},
              {"image_id": 7, "category_id": 1, "bbox": [0, 0, 5, 5], "area": 25,
               "iscrowd": 1, "segmentation": [[0, 0, 5, 0, 5, 5]]},
              {"image_id": 7, "category_id": 1, "bbox": [0, 0, 0, 5], "area": 3,
               "iscrowd": 0, "segmentation": [[0, 0, 1, 0, 1, 5]]}]}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    COCOConverter(".", str(tmp_path / "gt.json"), str(tmp_path / "a.json"),
                  str(tmp_path / "l" / "l.txt")).create_dataset_list()
    annos = json.loads((tmp_path / "a.json").read_text())
    assert annos == {"a.png": {"anno": {"bbox": [[0.2, 0.4, 0.2, 0.4]], "cls": [1],
                                        "mask": [[[2, 2, 6, 2, 6, 6]]]}, "image_id": 7}}
