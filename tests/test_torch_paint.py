"""Kernel 5's plain version, ``orienmask_tpu_torch.ops.paint``, against
``orienmask_tpu.ops.pallas_paint.paint_orientation`` in interpret mode.

The two must agree bit for bit (pos, neg and torien compared as int32
views, so a -0.0 against a +0.0 fails).  The plain version is also held
against the XLA chunked painter (``jax.vmap(OrientationPainter)``) at
rtol = atol = 1e-5, as the JAX package's own test holds the Pallas kernel:
that painter sums the background offsets in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orienmask_tpu.ops.pallas_paint import paint_orientation as jax_paint
from orienmask_tpu.ops.targets import OrientationPainter, TargetBuilder
from orienmask_tpu_torch.ops.maskops import pack_bits
from orienmask_tpu_torch.ops.paint import paint_orientation, paint_orientation_plain

IMAGE = (64, 64)
GRIDS = [(2, 2), (4, 4), (8, 8)]
ANCHORS = [[4, 6], [8, 10], [12, 8], [10, 20], [20, 16], [18, 36],
           [36, 28], [48, 60], [60, 50]]
MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
N_MAX = 16


def _random_gt(rng, n_inst):
    """Random normalized boxes with elliptic masks (``tests/test_targets.py``)."""
    h, w = IMAGE
    bbox, masks = [], []
    for _ in range(n_inst):
        bw, bh = rng.uniform(0.1, 0.7), rng.uniform(0.1, 0.7)
        cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
        bbox.append([cx, cy, bw, bh])
        ys, xs = np.mgrid[0:h, 0:w]
        masks.append(((xs / w - cx) / (bw / 2)) ** 2 + ((ys / h - cy) / (bh / 2)) ** 2
                     <= rng.uniform(0.5, 1.2))
    pb = np.zeros((N_MAX, 4), np.float32)
    pm = np.zeros((N_MAX, h, w), bool)
    pv = np.zeros((N_MAX,), bool)
    pb[:n_inst], pv[:n_inst] = np.array(bbox, np.float32).reshape(-1, 4), True
    pm[:n_inst] = np.array(masks, bool).reshape(-1, h, w)
    return pb, pm, pv


def _global_anchor(bbox, valid):
    builders = [TargetBuilder(GRIDS[s], IMAGE, ANCHORS, MASKS[s], 5) for s in range(3)]
    ga = jnp.full(bbox.shape[:2], -1, jnp.int32)
    for tb in builders:
        local, matched = jax.vmap(tb.match)(bbox, valid)
        cand = jnp.asarray(np.asarray(tb.anchor_mask, np.int32))[jnp.maximum(local, 0)]
        ga = jnp.where(matched & (ga < 0), cand, ga)
    return ga


def _painter():
    return OrientationPainter(IMAGE, ANCHORS, MASKS, GRIDS, center_region=0.6,
                              valid_region=0.6, chunk=4)


def _matched_case(seed, counts):
    """Batched GT spread over all scales, geometry from JAX's kernel_inputs."""
    rng = np.random.default_rng(seed)
    gts = [_random_gt(rng, k) for k in counts]
    bbox, mask, valid = (jnp.asarray(np.stack(x)) for x in zip(*gts))
    ga = _global_anchor(bbox, valid)
    geom, n_last = _painter().kernel_inputs(bbox, ga, ga >= 0)
    return np.array(geom), np.array(n_last), np.array(mask), (bbox, ga, mask)


def _geom_rows(rng, b, n, anchors=9):
    """Hand-made geometry rows: ROIs anywhere, bounds rounded as kernel_inputs
    rounds them."""
    h, w = IMAGE
    cx, cy = rng.uniform(0, w - 1, (b, n)), rng.uniform(0, h - 1, (b, n))
    cwx, cwy = rng.uniform(0.5, 20, (b, n)), rng.uniform(0.5, 20, (b, n))
    vx, vy = cwx / 0.6 * 0.7, cwy / 0.6 * 0.7
    x1, x2 = np.round(np.clip(cx - vx, 0, w - 1)), np.round(np.clip(cx + vx, 0, w - 1)) + 1
    y1, y2 = np.round(np.clip(cy - vy, 0, h - 1)), np.round(np.clip(cy + vy, 0, h - 1)) + 1
    anc = rng.integers(0, anchors, (b, n))
    geom = np.stack([cx, cy, cwx, cwy, x1, x2, y1, y2, anc, np.ones((b, n))], -1)
    return geom.astype(np.float32)


def _n_last(geom):
    act = geom[..., 9] > 0
    idx = np.arange(1, geom.shape[1] + 1)
    return np.where(act, idx, 0).max(axis=1).astype(np.int32)


def _edge_cases():
    rng = np.random.default_rng(7)
    h, w = IMAGE
    b, n = 3, N_MAX
    cases = {}

    geom = _geom_rows(rng, b, n)
    geom[:, :, 8] = 4  # every instance on one anchor: overlaps, the last wins
    geom[:, :, 4:8] = [8, 40, 8, 40]
    cases["overlap on one anchor"] = (geom, rng.uniform(size=(b, n, h, w)) < 0.5)

    geom = _geom_rows(rng, b, n)
    borders = [[0, 9, 0, 64], [55, 64, 0, 64], [0, 64, 0, 9], [0, 64, 55, 64],
               [0, 64, 0, 64], [0, 1, 0, 1], [63, 64, 63, 64]]
    geom[:, :len(borders), 4:8] = borders
    geom[:, :len(borders), 0:2] = [[0, 0], [63, 63], [31.5, 0], [0, 63], [32, 32],
                                   [0, 0], [63, 63]]
    cases["ROIs on every border"] = (geom, rng.uniform(size=(b, n, h, w)) < 0.3)

    geom = _geom_rows(rng, b, n)
    geom[:, 3, 9] = 0  # an unmatched instance in the middle
    geom[:, 6, 9] = 0
    geom[1, :, 9] = 0  # a sample with nothing to paint: n_last = 0
    geom[2, 5:, 9] = 0
    cases["unmatched in the middle, n_last 0"] = (geom, rng.uniform(size=(b, n, h, w)) < 0.5)

    geom = _geom_rows(rng, b, n)
    ones = np.ones((b, n, h, w), bool)
    ones[0] = False  # sample 0 all-zero masks, samples 1 and 2 all-one
    cases["all-one and all-zero masks"] = (geom, ones)
    return {k: (g, _n_last(g), m) for k, (g, m) in cases.items()}


# one compile for every case: all of them are (3, N_MAX) batches
_jax_paint = jax.jit(lambda geom, n_last, packed: jax_paint(
    geom, n_last, packed, np.asarray(ANCHORS, np.float32), IMAGE, block_h=32,
    interpret=True))


def _run_both(geom, n_last, mask):
    """The Pallas kernel on packed masks; the port on packed and on unpacked
    masks."""
    pixel_anchors = np.asarray(ANCHORS, np.float32)
    want = _jax_paint(jnp.asarray(geom), jnp.asarray(n_last),
                      jnp.asarray(np.packbits(mask, axis=-1)))
    mask_t = torch.from_numpy(np.array(mask))
    got = {layout: paint_orientation(torch.from_numpy(geom), torch.from_numpy(n_last), m,
                                     pixel_anchors, IMAGE)
           for layout, m in (("packed", pack_bits(mask_t)), ("unpacked", mask_t))}
    return ([np.asarray(x) for x in want],
            {k: [x.numpy() for x in v] for k, v in got.items()})


def _assert_bits(want, got):
    for layout, outs in got.items():
        for name, w, g in zip(("pos", "neg", "torien"), want, outs):
            assert g.shape == w.shape and g.dtype == np.float32, (layout, name)
            bad = g.view(np.int32) != w.view(np.int32)
            assert not bad.any(), f"{layout} {name}: {bad.sum()} values differ, e.g. " \
                f"{g[bad][:4]} against {w[bad][:4]}"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [21, 22])
def test_plain_painter_matches_pallas_by_bits(seed):
    """The cases of tests/test_targets.py: B = 3, 0-12 instances, GT over all
    three scales; one sample of seed 22 has no instance (n_last = 0)."""
    counts = list(np.random.default_rng(seed).integers(0, 12, 3))
    counts[0] = 12 if seed == 21 else 0
    geom, n_last, mask, _ = _matched_case(seed, counts)
    want, got = _run_both(geom, n_last, mask)
    assert want[0].sum() > 0 and want[1].sum() > 0
    _assert_bits(want, got)


@pytest.mark.parametrize("case", list(_edge_cases()))
def test_plain_painter_edge_cases_by_bits(case):
    geom, n_last, mask = _edge_cases()[case]
    want, got = _run_both(geom, n_last, mask)
    _assert_bits(want, got)


def test_instance_center_gives_negative_zero():
    """An instance's own center pixel has raw offset 0 and den -1: torien is
    -0.0 in both versions, which only a comparison by bits can see."""
    geom = np.zeros((3, N_MAX, 10), np.float32)
    geom[0, 0] = [10, 12, 4, 4, 5, 15, 6, 18, 0, 1]
    mask = np.ones((3, N_MAX, *IMAGE), bool)
    want, got = _run_both(geom, np.array([1, 0, 0], np.int32), mask)
    _assert_bits(want, got)
    center = got["packed"][2][0, 0, 12, 10]
    assert np.signbit(center).all() and (center == 0).all()


@pytest.mark.parametrize("seed", [21, 22])
def test_plain_painter_matches_xla_painter(seed):
    rng = np.random.default_rng(seed)
    geom, n_last, mask, (bbox, ga, mask_j) = _matched_case(
        seed, list(rng.integers(1, 12, 3)))
    ref = jax.vmap(_painter())(bbox, ga, ga >= 0, mask_j)
    got = paint_orientation_plain(torch.from_numpy(geom), torch.from_numpy(n_last),
                                  torch.from_numpy(mask), np.asarray(ANCHORS, np.float32),
                                  IMAGE)
    assert float(np.asarray(ref[0]).sum()) > 0
    for name, g, r in zip(("pos", "neg", "torien"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
