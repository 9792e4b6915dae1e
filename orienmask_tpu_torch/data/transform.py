"""The host augmentation pipeline and the device-side inference transform
(counterpart of ``orienmask_tpu/data/transform.py``).

Samples are dicts ``{'image': (H, W, 3) float32 RGB, 'bbox': (n, 4)
normalized cxcywh, 'cls': (n,), 'mask': [(H, W) uint8, ...], 'info': {...}}``
passed through ``COCOTransform``'s steps, each drawing from the numpy
``Generator`` it is handed, in the JAX package's order, so that one seed
gives the same crop, placement, flips and jitter factors in both packages.

The JAX package calls cv2; here numpy does OpenCV's arithmetic:

* ``cvtColor`` RGB2GRAY, RGB2HSV and HSV2RGB on float32 as OpenCV's vector
  loops compute them (fused multiply-adds where they fuse; the hue clip of
  ``adjust_hue`` kept).  OpenCV finishes a row that is not a whole number of
  vectors with scalar code whose rounding differs by an ulp at some pixels;
  ``tests/test_torch_transform.py`` states the figure;
* ``resize`` INTER_LINEAR on images through ``ops/resize.py::resize_linear``
  (bit for bit) and INTER_NEAREST on masks (``floor(x * src / dst)``);
* ``copyMakeBorder`` with a constant: a number fills the first channel only
  and the others with 0, as cv2 reads a number as a ``Scalar``.

``FastCOCOTransform`` is the inference transform that runs on the device:
bilinear resize to the network size, then normalize.
"""

import math

import numpy as np
import torch

from ..models.layers import resize_matrices, resize_nhwc
from ..ops.resize import _fma32, resize_linear

INTERPOLATIONS = ("nearest", "linear")
# cv2's float RGB -> grey weights
_R2Y, _G2Y, _B2Y = np.float32(0.299), np.float32(0.587), np.float32(0.114)
_EPS = np.float32(np.finfo(np.float32).eps)
# HSV -> RGB: for each sector, the table entries of (b, g, r)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _pair(x):
    return (x, x) if isinstance(x, (int, float)) else tuple(x)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class BaseTransform:
    """A pipeline and its random generator; ``reseed`` makes it a pure
    function of the seed (the loader reseeds before every sample)."""

    def __init__(self, pipeline):
        self.pipeline = Compose(pipeline)
        self.rng = np.random.default_rng()

    def reseed(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample, rng=None):
        return self.pipeline(sample, rng if rng is not None else self.rng)


# ----------------------------------------------------------------- image ops


def rgb_to_gray(image):
    """``cv2.cvtColor(image, COLOR_RGB2GRAY)`` of (H, W, 3) float32."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return _fma32(b, _B2Y, _fma32(r, _R2Y, g * _G2Y))


def rgb_to_hsv(image):
    """``cv2.cvtColor(image, COLOR_RGB2HSV)`` of (H, W, 3) float32: hue in
    degrees [0, 360), saturation in [0, 1], value as the input."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    scale = np.float32(60.0) / (diff + _EPS)
    hr = (g - b) * scale
    hr = np.where(hr < 0, _fma32(g - b, scale, np.float32(360.0)), hr)
    h = np.where(v == r, hr,
                 np.where(v == g, _fma32(b - r, scale, np.float32(120.0)),
                          _fma32(r - g, scale, np.float32(240.0))))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(hsv):
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of (H, W, 3) float32."""
    one = np.float32(1.0)
    h, s, v = hsv[..., 0] * np.float32(6.0 / 360.0), hsv[..., 1], hsv[..., 2]
    h = np.where(h < 0, h + np.float32(6.0), h)
    h = np.where(h >= 6, h - np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(np.float32)
    outside = (sector < 0) | (sector >= 6)
    sector = np.where(outside, 0, sector)
    h = np.where(outside, np.float32(0.0), h)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one), v * _fma32(-s, one - h, one)],
                   axis=-1)
    rgb = np.take_along_axis(tab, _SECTORS[sector], axis=-1)[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


def adjust_brightness(image, f):
    return np.clip(image * f, 0, 255)


def adjust_contrast(image, f):
    mean = rgb_to_gray(image).mean()
    return np.clip(image * f + mean * (1 - f), 0, 255)


def adjust_saturation(image, f):
    gray = rgb_to_gray(image)[..., None]
    return np.clip(image * f + gray * (1 - f), 0, 255)


def adjust_hue(image, f):
    hsv = rgb_to_hsv(image)
    # clip, not a circular wrap: hue jitter saturates near red, as the
    # JAX package (and the reference before it) does
    hsv[..., 0] = np.clip(hsv[..., 0] + f * 360, 0, 360)
    return hsv_to_rgb(hsv)


def imresize(image, size_wh, interpolation):
    """``cv2.resize(image, size_wh, interpolation=...)``: ``linear`` for
    float32 images, ``nearest`` for any array."""
    width, height = size_wh
    if interpolation == "linear":
        return resize_linear(np.asarray(image, np.float32), width, height)
    if interpolation != "nearest":
        raise ValueError(f"interpolation {interpolation!r} is not one of {INTERPOLATIONS}")
    src_h, src_w = image.shape[:2]
    cols = np.minimum(np.floor(np.arange(width) * (1.0 / (width / src_w))).astype(np.int64),
                      src_w - 1)
    rows = np.minimum(np.floor(np.arange(height) * (1.0 / (height / src_h))).astype(np.int64),
                      src_h - 1)
    return image[rows][:, cols]


def impad(image, padding_tdlr, value=0.0):
    """``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=value)``."""
    top, down, left, right = padding_tdlr
    height, width = image.shape[:2]
    channels = image.shape[2] if image.ndim == 3 else 1
    values = np.atleast_1d(np.asarray(value, np.float64))[:4]
    fill = np.zeros(channels, np.float64)
    fill[:min(len(values), channels)] = values[:channels]
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        fill = np.clip(np.rint(fill), info.min, info.max)
    out = np.empty((height + top + down, width + left + right) + image.shape[2:], image.dtype)
    out[...] = fill.astype(image.dtype) if image.ndim == 3 else fill[0]
    out[top:top + height, left:left + width] = image
    return out


class COCOTransform(BaseTransform):
    class Normalize:
        def __init__(self, mean, std):
            self.mean = np.asarray(mean, np.float32)
            self.std = np.asarray(std, np.float32)

        def __call__(self, sample, rng):
            sample["image"] = (sample["image"] - self.mean) / self.std
            return sample

    class ColorJitter:
        def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
            self.brightness = self._range(brightness)
            self.contrast = self._range(contrast)
            self.saturation = self._range(saturation)
            self.hue = self._range(hue, center=0)

        @staticmethod
        def _range(v, center=1):
            if isinstance(v, (int, float)):
                if v == 0:
                    return None
                lo = max(center - v, 0) if center == 1 else center - v
                return (lo, center + v)
            return tuple(v) if v else None

        def __call__(self, sample, rng):
            ops = []
            if self.brightness:
                f = rng.uniform(*self.brightness)
                ops.append(lambda im: adjust_brightness(im, f))
            if self.contrast:
                f2 = rng.uniform(*self.contrast)
                ops.append(lambda im: adjust_contrast(im, f2))
            if self.saturation:
                f3 = rng.uniform(*self.saturation)
                ops.append(lambda im: adjust_saturation(im, f3))
            if self.hue:
                f4 = rng.uniform(*self.hue)
                ops.append(lambda im: adjust_hue(im, f4))
            order = rng.permutation(len(ops))
            img = sample["image"]
            for i in order:
                img = ops[i](img)
            sample["image"] = img
            return sample

    class RandomCrop:
        """A random crop that keeps every box mostly inside."""

        def __init__(self, p=0.5, image_min_iou=0.64, bbox_min_iou=0.64):
            self.p = p
            self.image_max_ratio = image_min_iou ** 0.5
            self.bbox_max_ratio = bbox_min_iou ** 0.5

        def __call__(self, sample, rng):
            if rng.random() >= self.p:
                return sample
            height, width = sample["image"].shape[:2]
            if sample["bbox"].shape[0] == 0:
                left = int(rng.uniform(0, width * (1 - self.image_max_ratio)) + 0.5)
                right = int(rng.uniform(width * self.image_max_ratio, width) + 0.5)
                top = int(rng.uniform(0, height * (1 - self.image_max_ratio)) + 0.5)
                down = int(rng.uniform(height * self.image_max_ratio, height) + 0.5)
            else:
                bx, by, bw, bh = np.split(sample["bbox"], 4, axis=1)
                bx1, bx2 = (bx - bw / 2) * width, (bx + bw / 2) * width
                by1, by2 = (by - bh / 2) * height, (by + bh / 2) * height
                r = self.bbox_max_ratio
                b_left = (bx1 * r + bx2 * (1 - r)).min()
                b_right = (bx1 * (1 - r) + bx2 * r).max()
                b_top = (by1 * r + by2 * (1 - r)).min()
                b_down = (by1 * (1 - r) + by2 * r).max()
                left = int(rng.uniform(0, min(b_left, width * (1 - self.image_max_ratio))) + 0.5)
                right = int(rng.uniform(max(b_right, width * self.image_max_ratio), width) + 0.5)
                top = int(rng.uniform(0, min(b_top, height * (1 - self.image_max_ratio))) + 0.5)
                down = int(rng.uniform(max(b_down, height * self.image_max_ratio), height) + 0.5)

                nw, nh = right - left + 1, down - top + 1
                nx1 = np.maximum(bx1 - left, 0)
                nx2 = np.minimum(bx2 - left, nw)
                ny1 = np.maximum(by1 - top, 0)
                ny2 = np.minimum(by2 - top, nh)
                sample["bbox"] = np.hstack([
                    (nx1 + nx2) / 2 / nw, (ny1 + ny2) / 2 / nh,
                    (nx2 - nx1) / nw, (ny2 - ny1) / nh,
                ]).astype(np.float32)

            sample["image"] = sample["image"][top:down + 1, left:right + 1]
            if "mask" in sample:
                sample["mask"] = [m[top:down + 1, left:right + 1] for m in sample["mask"]]
            if "info" in sample:
                sample["info"]["crop"] = (top, down + 1, left, right + 1, height, width)
            return sample

    class Resize:
        """Letterbox resize with aspect jitter, random placement and random
        extra padding; records ``info['pad']`` for the inverse mapping of
        COCO evaluation."""

        def __init__(self, size, interpolation="linear", pad_needed=True, warp_p=0.,
                     jitter=0., random_place=False, pad_p=0., pad_ratio=0.,
                     pad_value=255 / 2):
            if interpolation not in INTERPOLATIONS:
                raise ValueError(f"interpolation {interpolation!r} is not ported: "
                                 f"{INTERPOLATIONS} are")
            self.size = _pair(size)
            self.aspect_ratio = self.size[1] / self.size[0]
            self.interpolation = interpolation
            self.pad_needed = pad_needed
            self.warp_p = warp_p
            self.jitter = jitter
            self.random_place = random_place
            self.pad_p = pad_p
            self.pad_ratio = pad_ratio
            self.pad_value = pad_value

        def __call__(self, sample, rng):
            h, w = self.size
            if self.pad_needed and rng.random() > self.warp_p:
                oh, ow = sample["image"].shape[:2]
                dh, dw = oh * self.jitter, ow * self.jitter
                new_ar = (ow + rng.uniform(-dw, dw)) / (oh + rng.uniform(-dh, dh))
                if new_ar < self.aspect_ratio:
                    nh = int(h * (1 - rng.uniform(0, self.pad_ratio)) + 0.5) \
                        if rng.random() < self.pad_p else h
                    nw = int(nh * new_ar + 0.5)
                else:
                    nw = int(w * (1 - rng.uniform(0, self.pad_ratio)) + 0.5) \
                        if rng.random() < self.pad_p else w
                    nh = int(nw / new_ar + 0.5)
                pad_left = int(rng.uniform(0, w - nw) + 0.5) if self.random_place \
                    else int((w - nw) / 2 + 0.5)
                pad_top = int(rng.uniform(0, h - nh) + 0.5) if self.random_place \
                    else int((h - nh) / 2 + 0.5)
                pad_right, pad_down = w - nw - pad_left, h - nh - pad_top

                bb = sample["bbox"]
                if bb.shape[0]:
                    bb[:, 0] = (bb[:, 0] * nw + pad_left) / w
                    bb[:, 1] = (bb[:, 1] * nh + pad_top) / h
                    bb[:, 2] = bb[:, 2] * nw / w
                    bb[:, 3] = bb[:, 3] * nh / h
                padding = (pad_top, pad_down, pad_left, pad_right)
                img = imresize(sample["image"], (nw, nh), self.interpolation)
                sample["image"] = impad(img, padding, self.pad_value)
                if "mask" in sample:
                    sample["mask"] = [
                        impad(imresize(m, (nw, nh), "nearest"), padding, 0)
                        for m in sample["mask"]
                    ]
                if "info" in sample:
                    sample["info"]["pad"] = padding + (h, w)
            else:
                sample["image"] = imresize(sample["image"], (w, h), self.interpolation)
                if "mask" in sample:
                    sample["mask"] = [imresize(m, (w, h), "nearest") for m in sample["mask"]]
            return sample

    class RandomHorizontalFlip:
        def __init__(self, p=0.5):
            self.p = p

        def __call__(self, sample, rng):
            if rng.random() < self.p:
                sample["image"] = np.flip(sample["image"], axis=1)
                if sample["bbox"].shape[0]:
                    sample["bbox"][:, 0] = 1 - sample["bbox"][:, 0]
                if "mask" in sample:
                    sample["mask"] = [np.flip(m, axis=1) for m in sample["mask"]]
                if "info" in sample:
                    sample["info"]["hflip"] = True
            return sample

    class RandomVerticalFlip:
        def __init__(self, p=0.5):
            self.p = p

        def __call__(self, sample, rng):
            if rng.random() < self.p:
                sample["image"] = np.flip(sample["image"], axis=0)
                if sample["bbox"].shape[0]:
                    sample["bbox"][:, 1] = 1 - sample["bbox"][:, 1]
                if "mask" in sample:
                    sample["mask"] = [np.flip(m, axis=0) for m in sample["mask"]]
                if "info" in sample:
                    sample["info"]["vflip"] = True
            return sample

    class ShortEdgeResize:
        def __init__(self, short_length, max_size, interpolation="linear"):
            if interpolation not in INTERPOLATIONS:
                raise ValueError(f"interpolation {interpolation!r} is not ported: "
                                 f"{INTERPOLATIONS} are")
            self.short_length = short_length
            self.max_size = max_size
            self.interpolation = interpolation

        def __call__(self, sample, rng):
            h, w = sample["image"].shape[:2]
            size = rng.choice(self.short_length)
            scale = min(size / min(h, w), self.max_size / max(h, w))
            nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
            sample["image"] = imresize(sample["image"], (nw, nh), self.interpolation)
            if "mask" in sample:
                sample["mask"] = [imresize(m, (nw, nh), "nearest") for m in sample["mask"]]
            return sample

    class Pad:
        """Pad to ``size_divisor``; adjusts the normalized boxes and records
        the inverse."""

        def __init__(self, size_divisor=32, pad_value=255 / 2):
            self.size_divisor = size_divisor
            self.pad_value = pad_value

        def __call__(self, sample, rng):
            height, width = sample["image"].shape[:2]
            nh = int(math.ceil(height / self.size_divisor) * self.size_divisor)
            nw = int(math.ceil(width / self.size_divisor) * self.size_divisor)
            pad_left, pad_top = (nw - width) // 2, (nh - height) // 2
            pad_right, pad_down = nw - width - pad_left, nh - height - pad_top
            bb = sample["bbox"]
            if bb.shape[0]:
                bb[:, 0] = (bb[:, 0] * width + pad_left) / nw
                bb[:, 1] = (bb[:, 1] * height + pad_top) / nh
                bb[:, 2] = bb[:, 2] * width / nw
                bb[:, 3] = bb[:, 3] * height / nh
            padding = (pad_top, pad_down, pad_left, pad_right)
            sample["image"] = impad(sample["image"], padding, self.pad_value)
            if "mask" in sample:
                sample["mask"] = [impad(m, padding, 0) for m in sample["mask"]]
            if "info" in sample:
                sample["info"]["pad"] = padding + (nh, nw)
            return sample

    class ToArray:
        """Finalize: contiguous float32 image, instances shuffled, masks
        stacked as bool."""

        def __call__(self, sample, rng):
            sample["image"] = np.ascontiguousarray(sample["image"], np.float32)
            n = sample["bbox"].shape[0]
            shuffle = rng.permutation(n)
            sample["bbox"] = np.asarray(sample["bbox"], np.float32)[shuffle]
            sample["cls"] = np.asarray(sample["cls"], np.int64)[shuffle]
            if "mask" in sample:
                if n:
                    sample["mask"] = np.stack(
                        [np.ascontiguousarray(m) > 0 for m in sample["mask"]]
                    )[shuffle]
                else:
                    sample["mask"] = np.zeros((0, *sample["image"].shape[:2]), bool)
            return sample


class FastCOCOTransform:
    def __init__(self, pipeline):
        self.size = None
        self.align_corners = False
        self.mean = np.zeros(3, np.float32)
        self.std = np.ones(3, np.float32)
        for item in pipeline:
            kind = item["type"]
            if kind == "Resize":
                self.size = _pair(item["size"])
                if item.get("interpolation", "bilinear") != "bilinear":
                    raise ValueError("FastCOCOTransform only implements bilinear resize")
                self.align_corners = item.get("align_corners", False)
            elif kind == "Normalize":
                self.mean = np.asarray(item["mean"], np.float32)
                self.std = np.asarray(item["std"], np.float32)
            else:
                raise ValueError(f"FastCOCOTransform: unsupported op {kind}")
        self._consts = {}  # (in_h, in_w, device) -> (mh, mw, mean, std)

    def _constants(self, in_h, in_w, device):
        key = (in_h, in_w, str(device))
        if key not in self._consts:
            mh, mw = resize_matrices((in_h, in_w), self.size, self.align_corners, device)
            self._consts[key] = (mh, mw, torch.from_numpy(self.mean).to(device),
                                 torch.from_numpy(self.std).to(device))
        return self._consts[key]

    def apply(self, image):
        """image: (B, H, W, 3) f32 -> resized + normalized (B, h, w, 3) f32:
        two matmuls along H then W (``layers.bilinear_resize``), then
        ``(x - mean) / std``."""
        mh, mw, mean, std = self._constants(image.shape[1], image.shape[2], image.device)
        return (resize_nhwc(image, mh, mw) - mean) / std
