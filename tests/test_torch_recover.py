"""The CPU rehearsal of kernel 6 (orienmask_tpu_torch/ops/recover.py, the
COCO conversion's mask recovery on the card): the composed source window
against the JAX package's crop, flip, crop; the torch plain version (OpenCV's
INTER_LINEAR arithmetic in float64 with the fused multiply-add's tie rule)
against the JAX ``_recover_shape_segm`` (cv2) on noise masks, 0 pixels
apart; the kernel's word logic (``recover_mirror``: staged words, windows,
column tables, the tile check, the identity transpose) against the plain
version, bit for bit, and the identity flag; and
``COCOMetrics.to_coco_format_device`` on CPU tensors against
``to_coco_format`` and the JAX package's, JSON-equal."""

import itertools
import json

import cv2
import numpy as np
import pytest
import torch

from orienmask_tpu.eval.coco_eval import COCOMetrics as JaxCOCOMetrics
from orienmask_tpu_torch.eval import COCOMetrics
from orienmask_tpu_torch.ops.maskops import pack_bits, unpack_bits_np
from orienmask_tpu_torch.ops.recover import (
    IDENTITY,
    _transpose32,
    recover_geometry,
    recover_masks,
    recover_masks_plain,
    recover_mirror,
    source_window,
    tile_classes,
)
from orienmask_tpu_torch.ops.resize import _fma32, fma32, resize_linear
from orienmask_tpu_torch.utils import timer


def _words_to_masks(words, n, oh, ow):
    """Column-major bit words (n, ow, ceil(oh/32)), LSB first -> (n, oh, ow)."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), bitorder="little")
    return bits.reshape(n, ow, -1)[:, :, :oh].transpose(0, 2, 1)


def _recover(masks, info):
    """The plain version of kernel 6 on one image's (n, H, W) bool masks."""
    n, h, w = masks.shape
    packed = pack_bits(torch.from_numpy(masks))[None]
    geom = recover_geometry([info], [n], (h, w), "cpu")
    words = recover_masks(packed, geom).numpy()
    assert words.dtype == np.int32 and words.size == geom.offsets[-1]
    return _words_to_masks(words, n, info["height"], info["width"])


GEOMETRY = {"collate_pad": (3, 8, 2, 5, 40, 48), "pad": (1, 4, 6, 0, 29, 40),
            "hflip": True, "vflip": True}


@pytest.mark.parametrize("keys", [c for r in range(5) for c in itertools.combinations(GEOMETRY, r)],
                         ids=lambda c: "+".join(c) or "none")
def test_source_window_is_the_jax_crop_flip_crop(keys):
    """Every combination of collate_pad, pad, hflip and vflip (asymmetric
    pads): the composed window equals what the JAX ``_recover_shape_segm``
    crops and flips (at the window's own size its cv2 resize copies)."""
    masks = np.random.default_rng(len(keys)).uniform(size=(3, 40, 48)) < 0.5
    info = {k: GEOMETRY[k] for k in keys}
    rows, cols = source_window(info, 40, 48)
    window = masks[:, rows[:, None], cols]
    info.update(height=len(rows), width=len(cols))
    np.testing.assert_array_equal(window, JaxCOCOMetrics._recover_shape_segm(masks, info))
    np.testing.assert_array_equal(window, COCOMetrics._recover_shape_segm(masks, info))
    np.testing.assert_array_equal(window, _recover(masks, info))


SOURCES = [(544, 544), (408, 544), (100, 37), (61, 200)]
OUTPUTS = [(37, 121), (100, 60), (480, 640), (64, 64), (13, 7), (272, 272), (427, 613),
           (720, 1280)]


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: "%dx%d" % s)
def test_plain_version_is_opencvs_resize_on_noise_masks(src):
    """Noise masks (every pixel a boundary, the 0.5 ties everywhere), each
    source size to every output size of the list, its own size and, from
    544², an exact 2x down (272²): 0 pixels differ from the JAX package's
    cv2 route, and the port's host route agrees."""
    torch.set_num_threads(1)
    h, w = src
    masks = np.random.default_rng(h + w).uniform(size=(2, h, w)) < 0.5
    total = 0
    for oh, ow in OUTPUTS + [src]:
        info = {"id": 0, "height": oh, "width": ow}
        want = JaxCOCOMetrics._recover_shape_segm(masks, info)
        got = _recover(masks, info)
        assert got.shape == want.shape == (2, oh, ow)
        assert int((got != want).sum()) == 0, f"{src} -> {(oh, ow)}"
        total += got.size
    assert total > 2 * 1.3e6
    host = COCOMetrics._recover_shape_segm(masks, {"id": 0, "height": 100, "width": 60})
    np.testing.assert_array_equal(host, _recover(masks, {"id": 0, "height": 100, "width": 60}))


def test_torch_fma_breaks_double_rounding_ties_as_numpys():
    """fma32 in torch equals ops.resize._fma32 (the visualizer's rule,
    itself held to cv2) on the float64 halfway ties and on random floats,
    bit for bit."""
    a = np.array([2.0 ** -24 * (1 + 2.0 ** -12), 2.0 ** -24 * (1 + 2.0 ** -18)], np.float32)
    b = np.array([1 - 2.0 ** -12 + 2.0 ** -24, 1 - 2.0 ** -18], np.float32)
    c = np.ones(2, np.float32)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.array([1 + 2.0 ** -23, 1], np.float32))
    rng = np.random.default_rng(0)
    a, b, c = (rng.uniform(-1, 1, 100_000).astype(np.float32) for _ in range(3))
    np.testing.assert_array_equal(
        fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy(),
        _fma32(a, b, c))
    # the resize of general floats, as the visualizer's
    image = rng.random((23, 31)).astype(np.float32)
    np.testing.assert_array_equal(resize_linear(image, 50, 17),
                                  cv2.resize(image, (50, 17), interpolation=cv2.INTER_LINEAR))


NET = 64
INFOS = [
    {"id": 0, "height": NET, "width": NET},
    {"id": 1, "height": 48, "width": 80, "pad": (13, 13, 0, 0, NET, NET)},
    {"id": 2, "height": 100, "width": 60, "pad": (0, 0, 13, 13, NET, NET), "hflip": True},
    {"id": 3, "height": 37, "width": 121, "vflip": True},
    {"id": 4, "height": 480, "width": 640, "collate_pad": (0, 8, 4, 0, NET, NET)},
    {"id": 5, "height": 61, "width": 93, "collate_pad": (2, 6, 3, 1, NET, NET),
     "pad": (4, 1, 0, 7, 60, 56), "hflip": True, "vflip": True},
    {"id": 0, "height": NET, "width": NET, "_pad": True},  # wrap padding: skipped
]


def _device_out(seed, k=6):
    """A postprocess's device dict for len(INFOS) images: valid rows first
    (image 3 none, the padded image all), packed masks (invalid rows
    random, as they are never read)."""
    rng = np.random.default_rng(seed)
    b = len(INFOS)
    n = [int(rng.integers(1, k + 1)) for _ in range(b)]
    n[3], n[-1] = 0, k
    valid = np.arange(k)[None] < np.array(n)[:, None]
    masks = rng.uniform(size=(b, k, NET, NET)) < rng.uniform(0.05, 0.95, (b, k, 1, 1))
    masks[0, 0], masks[0, 1] = False, True  # empty and full
    bbox = np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)), rng.uniform(0.05, 0.5, (b, k, 2)),
                           rng.uniform(0.01, 1, (b, k, 1))], -1).astype(np.float32)
    return {"bbox": torch.from_numpy(bbox),
            "cls": torch.from_numpy(rng.integers(0, 3, (b, k)).astype(np.int32)),
            "mask": pack_bits(torch.from_numpy(masks)), "valid": torch.from_numpy(valid)}


def _host_list(out):
    """``OrienMaskYOLOPostProcess.to_host_list`` of ``out`` (masks NET wide)."""
    host = {k: v.numpy() for k, v in out.items()}
    return [{"bbox": host["bbox"][b, :n], "cls": host["cls"][b, :n],
             "mask": unpack_bits_np(host["mask"][b, :n], NET)}
            for b, n in enumerate(host["valid"].sum(1))]


def test_to_coco_format_device_is_the_host_route_and_jax(tmp_path):
    torch.set_num_threads(1)
    cat2label = [1, 2, 3]
    out = _device_out(3)
    port = COCOMetrics(None, cat2label, True, str(tmp_path))
    got = port.to_coco_format_device(INFOS, out, NET)
    host = port.to_coco_format(INFOS, _host_list(out))
    want = JaxCOCOMetrics(None, cat2label, True, str(tmp_path)).to_coco_format(
        INFOS, _host_list(out))
    n = int(out["valid"][:-1].sum())
    assert len(got["bbox"]) == len(got["segm"]) == n >= 10
    assert {r["image_id"] for r in got["segm"]} == {0, 1, 2, 4, 5}
    assert json.dumps(got) == json.dumps(host) == json.dumps(want)
    boxes_only = COCOMetrics(None, cat2label, False, str(tmp_path))
    assert json.dumps(boxes_only.to_coco_format_device(INFOS, out, NET)) == \
        json.dumps({"bbox": got["bbox"]})


def test_to_coco_format_device_times_its_parts(tmp_path):
    """The copy of boxes, classes and validity, the boxes, the masks'
    recovery with its copy, and the RLE encoding: one timer entry each."""
    timer.reset()
    COCOMetrics(None, [1, 2, 3], True, str(tmp_path)).to_coco_format_device(
        INFOS, _device_out(4), NET)
    assert list(timer._timer_history) == ["To Host List", "COCO Boxes", "Mask Resize",
                                          "RLE Encode"]
    assert all(len(v) == 1 for v in timer._timer_history.values())


def test_recover_masks_refuses_other_devices_and_counts_nothing_on_the_cpu():
    from orienmask_tpu_torch import kernels

    out = _device_out(5)
    geom = recover_geometry(INFOS, [1] * len(INFOS), (NET, NET), "cpu")
    kernels.reset_launches()
    words = recover_masks(out["mask"], geom)
    assert kernels.launches["recover_masks"] == 0
    assert torch.equal(words, recover_masks_plain(out["mask"], geom))
    with pytest.raises(ValueError, match="unsupported device"):
        recover_masks(out["mask"].to("meta"), geom)
    with pytest.raises(ValueError, match="window"):
        recover_geometry([{"height": 5, "width": 5, "pad": (0, 0, NET, 0, NET, NET)}], [1],
                         (NET, NET), "cpu")


# the kernel's word logic against the plain version: every geometry of the
# list in one batch (a 96² source), noise and mask-like masks, each band
SRC = 96
MIRROR_INFOS = [
    {"height": SRC, "width": SRC},  # identity
    {"height": 88, "width": 80, "collate_pad": (0, 16, 0, 8, SRC, SRC)},  # identity, cropped
    {"height": 88, "width": 80, "collate_pad": (3, 13, 2, 6, SRC, SRC)},  # fractions 0, shifted
    {"height": 61, "width": 93, "collate_pad": (2, 6, 3, 1, SRC, SRC),
     "pad": (4, 1, 0, 7, 92, 88), "hflip": True, "vflip": True},  # flips, asymmetric pads
    {"height": 48, "width": 48},  # an exact 2x down
    {"height": 150, "width": 140},  # up
    {"height": 1, "width": 57},
    {"height": 31, "width": 40, "vflip": True},
    {"height": 32, "width": SRC, "hflip": True},
    {"height": 33, "width": 130},
    {"height": 40, "width": 40},  # no detections
]
MIRROR_COUNTS = [3, 2, 2, 3, 2, 2, 1, 2, 1, 2, 0]


def _mask_like(rng, n, size):
    """Elliptic masks as data/synthetic.py::make_scenes draws them, one
    empty and one full among them."""
    ys, xs = np.mgrid[0:size, 0:size] / size
    masks = np.zeros((n, size, size), bool)
    for j in range(n):
        bw, bh = rng.uniform(0.15, 0.55, 2)
        cx = rng.uniform(bw / 2 + 0.02, 0.98 - bw / 2)
        cy = rng.uniform(bh / 2 + 0.02, 0.98 - bh / 2)
        masks[j] = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1.0
    masks[0], masks[-1] = False, True
    return masks


def _mirror_batch(kind, seed):
    rng = np.random.default_rng(seed)
    k = max(MIRROR_COUNTS)
    if kind == "noise":
        masks = rng.uniform(size=(len(MIRROR_INFOS), k, SRC, SRC)) < 0.5
    else:
        masks = np.stack([_mask_like(rng, k, SRC) for _ in MIRROR_INFOS])
    return pack_bits(torch.from_numpy(masks))


@pytest.mark.parametrize("band", [32, 64, 128])
@pytest.mark.parametrize("kind", ["noise", "mask-like"])
def test_kernel_word_logic_is_the_plain_version(kind, band):
    """``recover_mirror`` (the kernel's staging, windows, tables, tile check
    and identity transpose in numpy) gives the plain version's words bit for
    bit on every geometry: identity (plain and cropped), zero fractions at an
    offset, hflip + vflip with asymmetric pads, 2x down, up, oh of 1, 31, 32
    and 33, an image of 0 detections; each path taken."""
    torch.set_num_threads(1)
    packed = _mirror_batch(kind, 7)
    geom = recover_geometry(MIRROR_INFOS, MIRROR_COUNTS, (SRC, SRC), "cpu", band=band)
    want = recover_masks_plain(packed, geom).numpy()
    got, classes = recover_mirror(packed.numpy(), geom)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert int((got != want).sum()) == 0
    assert classes["identity"] == 3 * 3 * 3 + 2 * 3 * 3  # images 0 and 1
    if kind == "noise":
        assert classes["mixed"] > 0 and classes["zero"] == classes["one"] == 0
    else:
        assert min(classes["zero"], classes["one"], classes["mixed"]) > 0
    assert tile_classes(packed.numpy(), geom) == classes


def test_identity_flag_is_set_exactly_for_identities():
    """The flag is set exactly when every fraction is 0 and every first
    index maps i -> i."""
    geom = recover_geometry(MIRROR_INFOS, MIRROR_COUNTS, (SRC, SRC), "cpu")
    flags = geom.geom[:, 7].tolist()
    xo, yo = geom.geom[:, 4].tolist(), geom.geom[:, 5].tolist()
    for b, (info, n) in enumerate(zip(MIRROR_INFOS, MIRROR_COUNTS)):
        if not n:
            assert flags[b] == 0
            continue
        oh, ow = info["height"], info["width"]
        x, fx = geom.xtab[xo[b]:xo[b] + ow], geom.xfrac[xo[b]:xo[b] + ow]
        y, fy = geom.ytab[yo[b]:yo[b] + oh], geom.yfrac[yo[b]:yo[b] + oh]
        identity = (not fx.any() and not fy.any() and torch.equal(x[:, 0], torch.arange(ow))
                    and torch.equal(y[:, 0], torch.arange(oh)))
        assert flags[b] == IDENTITY * identity
    assert [bool(f & IDENTITY) for f in flags[:6]] == [True, True, False, False, False, False]


def test_sub_bands_are_the_widest_whose_window_holds_them():
    """Each image's sub-band width is the largest power of two up to 32 whose
    sub-bands read source pixels at most 31 apart (a 64-bit window holds
    their bits): 32 at and above the source size, fewer when shrunk."""
    geom = recover_geometry(MIRROR_INFOS, MIRROR_COUNTS, (SRC, SRC), "cpu")
    xo, cps = geom.geom[:, 4].tolist(), geom.geom[:, 11].tolist()

    def spans(p, width):
        return [int(p[s:s + width].max() - p[s:s + width].min()) for s in range(0, len(p), width)]

    for b, (info, n) in enumerate(zip(MIRROR_INFOS, MIRROR_COUNTS)):
        if not n:
            continue
        p = geom.xtab[xo[b]:xo[b] + info["width"]].min(1).values.numpy()
        assert max(spans(p, cps[b])) <= 31
        assert cps[b] == 32 or max(spans(p, 2 * cps[b])) > 31
    assert cps[:6] == [32, 32, 32, 32, 16, 32] and min(cps[:-1]) < 16


def test_shuffle_transpose_is_the_bit_transpose():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2 ** 32, 32, dtype=np.uint64).astype(np.uint32)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # (lane, bit)
    want = (bits.T.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
    np.testing.assert_array_equal(_transpose32(x), want.astype(np.uint32))
