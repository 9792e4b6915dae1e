"""The port's host augmentation (orienmask_tpu_torch/data/transform.py)
against orienmask_tpu.data.transform, which calls cv2, from the same seeds.

* cv2's arithmetic, op by op, on seeded float32 images: INTER_LINEAR
  resizes of images and INTER_NEAREST resizes of masks, copyMakeBorder and
  HSV -> RGB bit for bit; RGB -> grey and RGB -> HSV bit for bit where
  OpenCV's vector loop covers the row (widths that are multiples of 16).
  On a row's last ``width % 16`` pixels OpenCV's scalar code rounds in
  another order: measured at most 1 ulp (grey) and 2 ulps (hue).
* Whole pipelines (the published train and val transforms at 64² and 96²,
  20 seeded samples each): crop box, placement, flips, boxes, classes,
  instance order, masks and infos identical; images within 1e-6 after
  Normalize (measured worst 4.2e-7, at 0.13% of the values at most: the
  ColorJitter's grey and hue conversions above)."""

import copy

import cv2
import numpy as np
import pytest
import torch

from orienmask_tpu.data import transform as jax_transform
from orienmask_tpu.trainer.builder import build_transform as jax_build_transform
from orienmask_tpu_torch.config import transform_train_544, transform_val_544
from orienmask_tpu_torch.data import transform
from orienmask_tpu_torch.trainer.builder import build_transform
from orienmask_tpu_torch.utils.mini_dataset import _resized

IMAGE_ATOL = 1e-6
SHAPES = [(48, 64), (43, 61), (120, 90), (61, 43)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _image(seed, h=37, w=64):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()


@pytest.mark.parametrize("width", [64, 53])
def test_gray_matches_cv2(width):
    img = _image(0, 41, width)
    got, want = transform.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    body = width // 16 * 16
    np.testing.assert_array_equal(got[:, :body], want[:, :body])
    assert _ulps(got, want) <= 1


@pytest.mark.parametrize("width", [64, 53])
def test_hsv_matches_cv2(width):
    img = _image(1, 41, width)
    img[0, :4] = [[10, 10, 10], [0, 0, 0], [255, 0, 0], [0, 0, 255]]  # grey, black, red, blue
    got, want = transform.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    body = width // 16 * 16
    np.testing.assert_array_equal(got[:, :body], want[:, :body])
    assert _ulps(got, want) <= 2
    hsv = want.copy()
    hsv[..., 0] = np.clip(hsv[..., 0] + np.float32(0.07) * 360, 0, 360)  # adjust_hue's clip
    np.testing.assert_array_equal(transform.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("size", [(40, 30), (100, 71), (26, 18), (64, 37), (32, 20)])
def test_resizes_match_cv2(size):
    img = _image(2)
    np.testing.assert_array_equal(transform.imresize(img, size, "linear"),
                                  cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))
    mask = (np.random.default_rng(3).random((37, 64)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(transform.imresize(mask, size, "nearest"),
                                  cv2.resize(mask, size, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("value", [255 / 2, (123.675, 116.28, 103.53), 0])
def test_impad_matches_cv2(value):
    img = _image(4)
    mask = (np.random.default_rng(5).random((37, 64)) > 0.5).astype(np.uint8)
    for arr in (img, mask):
        np.testing.assert_array_equal(
            transform.impad(arr, (1, 2, 3, 4), value),
            cv2.copyMakeBorder(arr, 1, 2, 3, 4, cv2.BORDER_CONSTANT, value=value))


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue"])
def test_color_ops_match_jax(op):
    img = _image(6, 40, 64)
    got = getattr(transform, f"adjust_{op}")(img.copy(), 0.07 if op == "hue" else 1.3)
    want = getattr(jax_transform, f"adjust_{op}")(img.copy(), 0.07 if op == "hue" else 1.3)
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * IMAGE_ATOL)


def _sample(seed):
    rng = np.random.default_rng(seed)
    h, w = SHAPES[seed % len(SHAPES)]
    n = int(rng.integers(0, 5))
    bw, bh = rng.uniform(0.1, 0.6, n), rng.uniform(0.1, 0.6, n)
    cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
    return {"image": rng.integers(0, 256, (h, w, 3)).astype(np.float32),
            "bbox": np.stack([cx, cy, bw, bh], 1).astype(np.float32),
            "cls": rng.integers(0, 80, n),
            "mask": [(rng.random((h, w)) > 0.6).astype(np.uint8) for _ in range(n)],
            "info": {"id": seed, "height": h, "width": w}}


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("name", ["train", "val"])
def test_pipeline_matches_jax(name, size):
    cfg = _resized(transform_train_544 if name == "train" else transform_val_544, size)
    got_t, want_t = build_transform(cfg), jax_build_transform(cfg)
    for seed in range(20):
        sample = _sample(seed)
        got_t.reseed(seed)
        want_t.reseed(seed)
        got, want = got_t(copy.deepcopy(sample)), want_t(copy.deepcopy(sample))
        assert got["info"] == want["info"], seed
        for key in ("bbox", "cls", "mask"):
            assert got[key].dtype == want[key].dtype, (seed, key)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"seed {seed}: {key}")
        assert got["image"].shape == want["image"].shape == (size, size, 3)
        np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=IMAGE_ATOL,
                                   err_msg=f"seed {seed}")


def test_train_pipeline_takes_every_step():
    """Over the 20 seeds the train pipeline crops, letterboxes with random
    placement and flips, so the comparison above covers each branch."""
    t = build_transform(_resized(transform_train_544, 64))
    seen = set()
    for seed in range(20):
        t.reseed(seed)
        info = t(_sample(seed))["info"]
        seen |= {k for k in ("crop", "pad", "hflip") if k in info}
    assert seen == {"crop", "pad", "hflip"}


def test_unported_interpolation_is_refused():
    with pytest.raises(ValueError, match="not ported"):
        transform.COCOTransform.Resize(64, interpolation="cubic")
