"""The port's host augmentation (orienmask_tpu_torch/data/transform.py)
against orienmask_tpu.data.transform, which calls cv2, from the same seeds.

* cv2's arithmetic, op by op, on seeded float32 images: INTER_LINEAR,
  INTER_AREA and INTER_LANCZOS4 resizes of images and INTER_NEAREST resizes
  of masks, copyMakeBorder and HSV -> RGB bit for bit; INTER_CUBIC bit for
  bit where cv2 runs its own loops (2 or 5 channels) and within
  ``CUBIC_ATOL`` where it hands the image to IPP (1, 3 or 4 channels:
  measured at most 9.2e-5 on the 0-255 scale over the cases below); RGB -> grey and RGB -> HSV bit for bit where
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
# INTER_CUBIC on 1, 3 or 4 channels (IPP's arithmetic): measured 9.2e-5
CUBIC_ATOL = 1e-3
NEW_INTERPOLATIONS = ("area", "cubic", "lanczos4")
# (source, output size): down-, up- and mixed scales, whole-number factors
# (2x and 4x down, 2x up, one axis kept), and the letterbox of 480x640 to 544
RESIZE_CASES = [((48, 64), (32, 24)), ((48, 64), (16, 12)), ((48, 64), (128, 96)),
                ((48, 64), (64, 16)), ((48, 64), (40, 30)), ((37, 53), (100, 71)),
                ((37, 53), (30, 50)), ((37, 53), (21, 13)), ((480, 640), (544, 408))]
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


def _held_to_jax(name, got, want):
    if name == "cubic":
        np.testing.assert_allclose(got, want, rtol=0, atol=CUBIC_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1, 2])
@pytest.mark.parametrize("case", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}_to_{d[1]}x{d[0]}" for s, d in RESIZE_CASES])
@pytest.mark.parametrize("name", NEW_INTERPOLATIONS)
def test_new_interpolations_match_jax(name, case, channels):
    """``imresize`` against the JAX package's (cv2.resize with the flag of
    ``name``): area and lanczos4 by bits, cubic as the module states; 2
    channels (no IPP) by bits for all three."""
    (h, w), size = case
    img = np.random.default_rng(h + channels).uniform(0, 255, (h, w, channels)).astype(np.float32)
    if channels == 1:
        img = img[..., 0]
    got = transform.imresize(img, size, name)
    want = jax_transform.imresize(img, size, jax_transform._INTERP[name])
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if channels == 2:
        np.testing.assert_array_equal(got, want)
    else:
        _held_to_jax(name, got, want)


@pytest.mark.parametrize("step", ["Resize", "ShortEdgeResize"])
@pytest.mark.parametrize("name", NEW_INTERPOLATIONS)
def test_resize_steps_with_new_interpolations_match_jax(name, step):
    """``COCOTransform.Resize`` (letterbox with jitter, random placement
    and padding) and ``ShortEdgeResize`` with each new interpolation, from
    the same seeds: sizes, boxes, nearest-resized masks and infos identical,
    images as ``imresize`` holds them."""
    for seed in range(6):
        sample = _sample(seed)
        if step == "Resize":
            kw = dict(size=64, interpolation=name, jitter=0.3, random_place=True, pad_p=0.5,
                      pad_ratio=0.2, warp_p=0.2)
        else:
            kw = dict(short_length=[40, 56], max_size=96, interpolation=name)
        got = getattr(transform.COCOTransform, step)(**kw)(
            copy.deepcopy(sample), np.random.default_rng(seed))
        want = getattr(jax_transform.COCOTransform, step)(**kw)(
            copy.deepcopy(sample), np.random.default_rng(seed))
        assert got["info"] == want["info"], seed
        np.testing.assert_array_equal(got["bbox"], want["bbox"])
        assert len(got["mask"]) == len(want["mask"])
        for m, n in zip(got["mask"], want["mask"]):
            np.testing.assert_array_equal(m, n)
        assert got["image"].shape == want["image"].shape
        _held_to_jax(name, got["image"], want["image"])


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
    """Every cv2 flag the JAX transform names is taken; a name it does not
    know is refused, naming those that are."""
    for step in (lambda i: transform.COCOTransform.Resize(64, interpolation=i),
                 lambda i: transform.COCOTransform.ShortEdgeResize([64], 96, interpolation=i)):
        for name in jax_transform._INTERP:
            step(name)
        with pytest.raises(ValueError, match="not one of .*'lanczos4'"):
            step("bicubic")
    assert set(transform.INTERPOLATIONS) == set(jax_transform._INTERP)
