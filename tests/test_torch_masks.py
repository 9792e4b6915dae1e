"""The port's mask assembly (orienmask_tpu_torch/ops/masks.py) against the
three kernels of orienmask_tpu/ops/pallas_masks.py in interpret mode
(assemble_masks_anchor_resident, assemble_masks, assemble_masks_bitpacked):
bytes must be BIT-identical.

W = 544, the network width: the kernel's column coordinate x * f32(1/W)
differs from x / W by one ulp in 31 of its columns, which a narrow test
width would hide.  The CUDA kernels' parity with the plain versions is
checked on the card by chip_smoke.py."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from orienmask_tpu.ops import pallas_masks
from orienmask_tpu.ops.pallas_masks import assemble_masks_anchor_resident
from orienmask_tpu_torch.ops.masks import (
    ALL_IN,
    ALL_OUT,
    EMPTY,
    TILE_W,
    assemble_masks,
    assemble_masks_bitpacked,
    assemble_masks_bitpacked_plain,
    assemble_masks_packed,
    assemble_masks_packed_plain,
    assemble_masks_plain,
    classify_tiles,
    field_bounds,
    position_bounds,
    tile_bounds,
    tile_classes,
    tile_classes_per_detection,
)

A, W, K = 9, 544, 20


def _inputs(seed, b, h, k=K):
    rng = np.random.default_rng(seed)
    field = rng.standard_normal((b, A, 2, h, W)).astype(np.float32)
    boxes = np.stack([
        rng.uniform(0.2, 0.8, (b, k)), rng.uniform(0.2, 0.8, (b, k)),
        rng.uniform(0.1, 0.6, (b, k)), rng.uniform(0.1, 0.6, (b, k)),
    ], axis=-1).astype(np.float32)
    boxes[:, -3:] = 0.0  # padded detections: zero box -> empty mask
    anchor_idx = rng.integers(0, A - 2, (b, k)).astype(np.int32)  # 7, 8 unused
    anchor_idx[:, :4] = 3  # duplicates on one anchor
    table = rng.uniform(0.05, 0.7, (A, 2)).astype(np.float32)
    return field, boxes, anchor_idx, table


def _jax(field, boxes, anchor_idx, table, **kw):
    return np.asarray(assemble_masks_anchor_resident(
        jnp.asarray(field), jnp.asarray(boxes), jnp.asarray(table[anchor_idx]),
        jnp.asarray(anchor_idx), orien_thresh=0.3, interpret=True, **kw))


def _port(field, boxes, anchor_idx, table, **kw):
    return assemble_masks_packed_plain(
        torch.from_numpy(field), torch.from_numpy(boxes), torch.from_numpy(anchor_idx),
        torch.from_numpy(table), 0.3, **kw).numpy()


def test_plain_masks_match_pallas_at_w544():
    torch.set_num_threads(1)
    h = 16
    field, boxes, anchor_idx, table = _inputs(0, 2, h)
    got = _port(field, boxes, anchor_idx, table)
    assert got.shape == (2, K, h, W // 8) and got.dtype == np.uint8
    for b in range(2):
        want = _jax(field[b], boxes[b], anchor_idx[b], table, block_h=h)
        np.testing.assert_array_equal(got[b], want)
    assert got.any() and not got[:, -3:].any()


def test_plain_masks_row_shards_match_pallas_and_whole_image():
    """Row blocks with coord_h = global H and row0 = the block's first row
    equal the JAX kernel's shards and the rows of the whole-image call."""
    torch.set_num_threads(1)
    h, hs = 32, 16
    field, boxes, anchor_idx, table = _inputs(1, 1, h)
    whole = _port(field, boxes, anchor_idx, table)
    for r0 in range(0, h, hs):
        shard = _port(field[:, :, :, r0:r0 + hs].copy(), boxes, anchor_idx, table,
                      coord_h=h, row0=r0)
        want = _jax(field[0, :, :, r0:r0 + hs], boxes[0], anchor_idx[0], table,
                    block_h=hs, coord_h=h, row0=r0)
        np.testing.assert_array_equal(shard[0], want)
        np.testing.assert_array_equal(shard, whole[:, :, r0:r0 + hs])


def test_plain_masks_anchor_off_table_is_empty():
    torch.set_num_threads(1)
    field, boxes, anchor_idx, table = _inputs(2, 1, 8, k=6)
    boxes[:] = [0.5, 0.5, 2.0, 2.0]  # covers the whole image
    anchor_idx[0, 2] = A  # no such anchor
    got = _port(field, boxes, anchor_idx, table)
    assert not got[0, 2].any() and got[0, 0].any()


def test_wrapper_takes_plain_version_on_cpu():
    torch.set_num_threads(1)
    field, boxes, anchor_idx, table = (torch.from_numpy(a) for a in _inputs(3, 1, 8))
    assert torch.equal(
        assemble_masks_packed(field, boxes, anchor_idx, table, 0.3),
        assemble_masks_packed_plain(field, boxes, anchor_idx, table, 0.3))


VALID_PATTERNS = {
    "all": lambda rng, b, k: np.ones((b, k), bool),
    "none": lambda rng, b, k: np.zeros((b, k), bool),
    "sparse": lambda rng, b, k: rng.uniform(size=(b, k)) < 0.3,
}


@pytest.mark.parametrize("pattern", list(VALID_PATTERNS))
def test_plain_masks_with_valid_match_pallas_times_valid(pattern):
    """Kernel 2's plain version with the validity row equals the JAX
    kernel's masks multiplied by ``valid``, as JAX's postprocess does
    (``orienmask_tpu/ops/postprocess.py:404``)."""
    torch.set_num_threads(1)
    h = 16
    field, boxes, anchor_idx, table = _inputs(4, 2, h)
    valid = VALID_PATTERNS[pattern](np.random.default_rng(5), 2, K)
    if pattern == "sparse":
        assert 0 < valid.sum() < valid.size
    got = _port(field, boxes, anchor_idx, table, valid=torch.from_numpy(valid))
    for b in range(2):
        want = _jax(field[b], boxes[b], anchor_idx[b], table, block_h=h)
        np.testing.assert_array_equal(got[b], want * valid[b][:, None, None].astype(np.uint8))
    assert got.any() == (pattern != "none")


def test_wrapper_passes_valid_on_cpu():
    torch.set_num_threads(1)
    field, boxes, anchor_idx, table = (torch.from_numpy(a) for a in _inputs(6, 2, 8))
    valid = torch.from_numpy(np.random.default_rng(6).uniform(size=(2, K)) < 0.5)
    got = assemble_masks_packed(field, boxes, anchor_idx, table, 0.3, valid=valid)
    assert torch.equal(got, assemble_masks_packed_plain(field, boxes, anchor_idx, table, 0.3,
                                                        valid=valid))
    whole = assemble_masks_packed(field, boxes, anchor_idx, table, 0.3)
    assert torch.equal(got, whole * valid[..., None, None])
    assert got[valid].any() and not got[~valid].any()


# --------------------------------------------- kernel 2's tile culling

def _predicate(gx, gy, c, tb):
    """The plain per-pixel predicate |g - c| < t*b in both axes."""
    return ((gx - c[0]).abs() < tb[0]) & ((gy - c[1]).abs() < tb[1])


SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 0.5, -0.5, 1.0, 0.25, 1e-38, 3e38]
f32s = st.one_of(st.sampled_from(SPECIAL),
                 st.floats(-2, 2, width=32, allow_nan=False, allow_infinity=False))


@st.composite
def tile_and_detection(draw):
    """A tile of 1-32 pixels (the rule holds for any set of pixels; the
    kernel's tiles hold TILE_W) and a detection.  Each axis draws its pixels
    inside [c - |tb|, c + |tb|], then replaces up to three of them with a
    special value (+-inf, NaN, -0.0, ...), g exactly at c +- tb, or a value
    near c; tb = 0 and negative tb are among the draws."""
    n = draw(st.integers(1, 32))
    finite = st.floats(-2, 2, width=32)
    c = [draw(st.one_of(finite, f32s)) for _ in range(2)]
    positive = st.floats(2.0 ** -10, 1, width=32)
    tb = [draw(st.one_of(positive, positive, st.sampled_from([0.0, -0.0, -0.25, np.inf, np.nan]),
                         st.floats(-1, 1, width=32))) for _ in range(2)]
    axes = []
    with np.errstate(invalid="ignore", over="ignore"):
        for ci, ti in zip(np.float32(c), np.float32(tb)):
            inside = st.floats(-1, 1, width=32).map(
                lambda f, ci=ci, ti=ti: float(ci + np.float32(f) * abs(ti)))
            near = st.floats(-1, 1, width=32).map(lambda f, ci=ci: float(ci + np.float32(f)))
            vals = draw(st.lists(inside, min_size=n, max_size=n))
            for _ in range(draw(st.integers(0, 3))):
                vals[draw(st.integers(0, n - 1))] = draw(st.one_of(
                    f32s, st.just(np.nan), st.sampled_from([float(ci + ti), float(ci - ti)]),
                    near))
            axes.append(vals)
    return [torch.tensor(v, dtype=torch.float32) for v in (*axes, c, tb)]


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(tile_and_detection())
def test_tile_rule_never_contradicts_the_predicate(case):
    """No tile classed all out holds a set pixel of the plain predicate, and
    no tile classed all in holds an unset one."""
    gx, gy, c, tb = case
    cls = int(classify_tiles(tile_bounds(gx, gy), c, tb))
    inside = _predicate(gx, gy, c, tb)
    if cls == ALL_OUT:
        assert not inside.any()
    elif cls == ALL_IN:
        assert inside.all()


def test_tile_rule_at_exact_ties():
    """g with |g - c| == t*b exactly is outside (the compare is one-sided):
    a tile whose bounds reach the edge is mixed or all out, never all in."""
    c = torch.tensor([0.5, 0.5])
    tb = torch.tensor([0.25, 0.25])
    edge = torch.tensor([0.25, 0.5, 0.75])  # both ends exactly at c -+ tb
    inner = torch.tensor([0.5, 0.5, 0.5])
    assert int(classify_tiles(tile_bounds(edge, inner), c, tb)) == 2
    assert int(classify_tiles(tile_bounds(inner, inner), c, tb)) == ALL_IN
    assert int(classify_tiles(tile_bounds(torch.tensor([0.75, 0.8]), inner[:2]), c, tb)) \
        == ALL_OUT
    nan_tile = torch.tensor([0.5, float("nan")])
    assert int(classify_tiles(tile_bounds(nan_tile, inner[:2]), c, tb)) == 2


@pytest.mark.parametrize("w", [544, 40])
def test_tile_classes_agree_with_the_plain_masks(w):
    """Every tile classed all out is a zero word of kernel 2's plain output,
    every tile classed all in a word of ones, every EMPTY detection zero:
    at W = 544 and at a width that ends in a partial tile, with a box over
    the whole image, NaN and inf in the field, and invalid detections."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(w)
    b, h, k = 2, 12, 16
    field = (rng.standard_normal((b, A, 2, h, w)) * 0.05).astype(np.float32)
    field[0, 3, 0, 2, 5], field[1, 3, 1, 7, 9], field[0, 3, 0, 4, 30] = np.nan, np.inf, -np.inf
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)),
                            rng.uniform(0.05, 0.6, (b, k, 2))], -1).astype(np.float32)
    boxes[:, 0] = [0.5, 0.5, 4.0, 4.0]  # covers the image: all-in tiles
    boxes[:, -2] = 0.0
    boxes[:, -1] = [0.5, 0.5, -1.0, 1.0]  # negative side: never inside
    anchor_idx = rng.integers(0, A, (b, k)).astype(np.int32)
    anchor_idx[:, :6] = 3
    anchor_idx[0, 7] = A  # off the table
    table = rng.uniform(0.05, 0.7, (A, 2)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) < 0.8
    args = [torch.from_numpy(a) for a in (field, boxes, anchor_idx, table)]
    kw = dict(valid=torch.from_numpy(valid))
    cls = tile_classes(*args, 0.3, **kw)
    nw = -(-w // TILE_W)
    assert cls.shape == (b, k, h, nw)
    packed = assemble_masks_packed_plain(*args, 0.3, **kw).numpy()
    per = TILE_W // 8  # bytes a tile
    words = np.pad(packed, [(0, 0)] * 3 + [(0, nw * per - w // 8)]).reshape(b, k, h, nw, per)
    absent = (np.arange(nw * per) >= w // 8).reshape(nw, per)  # past the row's last byte
    zero, ones = ((words == 0) | absent).all(-1), ((words == 255) | absent).all(-1)
    cls = cls.numpy()
    assert zero[cls == ALL_OUT].all() and zero[cls == EMPTY].all()
    assert ones[cls == ALL_IN].all()
    assert (cls == ALL_IN).any() and (cls == ALL_OUT).any() and (cls == 2).any()
    assert (cls[~valid] == EMPTY).all() and (cls[0, 7] == EMPTY).all()
    assert not (cls[:, -1] == ALL_IN).any()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_tile_classes_agree_with_the_plain_masks_on_a_painted_field():
    """The same agreement on chip_smoke.py's case (e) at 544²: the field that
    OrientationPainter paints for 8 instances (what a model that fits its
    targets predicts) and 100 detections drawn from them.  Most tiles there
    are all out, and the instances' interiors give all-in tiles."""
    torch.set_num_threads(1)
    args, thresh = _chip_smoke().painted_inputs(np.random.default_rng(8), 1, device="cpu")
    assert args[0].shape == (1, A, 2, W, W) and torch.isfinite(args[0]).all()
    cls = tile_classes(*args, thresh).numpy()
    words = assemble_masks_packed_plain(*args, thresh).numpy().reshape(1, 100, W, -1, TILE_W // 8)
    assert (words[cls == ALL_OUT] == 0).all()
    assert (words[cls == ALL_IN] == 255).all()
    n = {c: (cls == c).sum() for c in (ALL_OUT, ALL_IN, 2)}
    assert n[ALL_OUT] > 0.9 * cls.size and n[ALL_IN] > 0 and n[2] > 0


def test_pack_bits_matches_jax_maskops():
    """Plain MSB-first packing and host unpacking against
    orienmask_tpu/ops/maskops.py, including a width that is not a multiple of 8."""
    from orienmask_tpu.ops.maskops import pack_bits as jax_pack_bits
    from orienmask_tpu_torch.ops.maskops import pack_bits, unpack_bits_np

    torch.set_num_threads(1)
    for w in (544, 21):
        m = np.random.default_rng(w).uniform(size=(3, 5, w)) < 0.4
        got = pack_bits(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_pack_bits(jnp.asarray(m))))
        np.testing.assert_array_equal(unpack_bits_np(got, w), m)


# ------------------------------------------ kernels 3 and 4: per detection

def _per_detection_inputs(seed, b, h, w, k, off_table):
    """Field, boxes, per-detection anchor sizes and indices.  ``off_table``:
    every detection draws its own size (no per-anchor table holds them);
    otherwise the sizes are rows of a table, as every real caller passes."""
    rng = np.random.default_rng(seed)
    field = rng.standard_normal((b, A, 2, h, w)).astype(np.float32)
    boxes = np.stack([
        rng.uniform(0.2, 0.8, (b, k)), rng.uniform(0.2, 0.8, (b, k)),
        rng.uniform(0.1, 0.6, (b, k)), rng.uniform(0.1, 0.6, (b, k)),
    ], axis=-1).astype(np.float32)
    boxes[:, -1] = 0.0  # a padded detection: zero box -> empty mask
    anchor_idx = rng.integers(0, A, (b, k)).astype(np.int32)
    anchor_idx[:, :3] = 2  # duplicates on one anchor
    if off_table:
        anchor_wh = rng.uniform(0.05, 0.7, (b, k, 2)).astype(np.float32)
    else:
        anchor_wh = rng.uniform(0.05, 0.7, (A, 2)).astype(np.float32)[anchor_idx]
    return field, boxes, anchor_wh, anchor_idx


# (name, seed, B, H, W, K, block_h of the JAX kernel, coord_h, sizes off the table)
PER_DET_CASES = [
    ("w544_h136", 10, 1, 136, 544, 6, 136, None, False),
    ("w544_off_table", 11, 1, 136, 544, 6, 136, None, True),
    ("64x64_b2", 12, 2, 64, 64, 12, 32, None, True),
    ("coord_h_544", 13, 1, 136, 544, 5, 136, 544, True),
]


@pytest.mark.parametrize("name,seed,b,h,w,k,block_h,coord_h,off_table", PER_DET_CASES,
                         ids=[c[0] for c in PER_DET_CASES])
def test_per_detection_kernels_match_pallas(name, seed, b, h, w, k, block_h, coord_h, off_table):
    """Kernel 3's plain version against ``assemble_masks(interpret=True)``
    and kernel 4's against ``assemble_masks_bitpacked(interpret=True)``."""
    torch.set_num_threads(1)
    field, boxes, anchor_wh, anchor_idx = _per_detection_inputs(seed, b, h, w, k, off_table)
    args = [torch.from_numpy(a) for a in (field, boxes, anchor_wh, anchor_idx)]
    got = assemble_masks_plain(*args, 0.3, coord_h=coord_h).numpy()
    got_packed = assemble_masks_bitpacked_plain(*args, 0.3, coord_h=coord_h).numpy()
    assert got.shape == (b, k, h, w) and got.dtype == np.uint8
    assert got_packed.shape == (b, k, h, w // 8) and got_packed.dtype == np.uint8
    for i in range(b):
        jargs = [jnp.asarray(a[i]) for a in (field, boxes, anchor_wh, anchor_idx)]
        want = pallas_masks.assemble_masks(*jargs, orien_thresh=0.3, block_h=block_h,
                                           interpret=True, coord_h=coord_h)
        np.testing.assert_array_equal(got[i], np.asarray(want))
        want_packed = pallas_masks.assemble_masks_bitpacked(
            *jargs, orien_thresh=0.3, block_h=block_h, interpret=True, coord_h=coord_h)
        np.testing.assert_array_equal(got_packed[i], np.asarray(want_packed))
    assert set(np.unique(got)) == {0, 1} and not got[:, -1].any()
    np.testing.assert_array_equal(np.packbits(got, axis=-1), got_packed)


def test_per_detection_kernels_equal_kernel_2_on_table_sizes():
    """With each detection's size a row of the per-anchor table, kernel 4
    packs the same bytes as kernel 2 (bench_maskkernel.py's check)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(9)
    field, boxes, _, anchor_idx = _per_detection_inputs(9, 2, 16, W, 10, False)
    table = rng.uniform(0.05, 0.7, (A, 2)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (field, boxes, table[anchor_idx], anchor_idx)]
    packed = assemble_masks_packed_plain(*(torch.from_numpy(a) for a in (
        field, boxes, anchor_idx, table)), 0.3)
    assert torch.equal(assemble_masks_bitpacked_plain(*args, 0.3), packed)
    assert packed.any()


def test_per_detection_kernels_refuse_width_not_multiple_of_8():
    """W % 8 != 0 raises, as the TPU kernels assert (pallas_masks.py:73, :151);
    no zero-tail packing."""
    field, boxes, anchor_wh, anchor_idx = (torch.from_numpy(a) for a in
                                           _per_detection_inputs(4, 1, 8, 20, 3, True))
    for fn in (assemble_masks, assemble_masks_plain, assemble_masks_bitpacked,
               assemble_masks_bitpacked_plain):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(field, boxes, anchor_wh, anchor_idx, 0.3)


def test_per_detection_anchor_off_table_is_empty():
    torch.set_num_threads(1)
    field, boxes, anchor_wh, anchor_idx = _per_detection_inputs(5, 1, 8, 64, 4, True)
    boxes[:] = [0.5, 0.5, 2.0, 2.0]  # covers the whole image
    anchor_idx[0, 1], anchor_idx[0, 2] = A, -1  # no such anchors
    got = assemble_masks_plain(*(torch.from_numpy(a) for a in (
        field, boxes, anchor_wh, anchor_idx)), 0.3)
    assert not got[0, 1:3].any() and got[0, 0].any() and got[0, 3].any()


def test_per_detection_wrappers_take_plain_versions_on_cpu():
    torch.set_num_threads(1)
    args = [torch.from_numpy(a) for a in _per_detection_inputs(6, 2, 8, 64, 5, True)]
    assert torch.equal(assemble_masks(*args, 0.3), assemble_masks_plain(*args, 0.3))
    assert torch.equal(assemble_masks_bitpacked(*args, 0.3),
                       assemble_masks_bitpacked_plain(*args, 0.3))


# ------------------------- kernels 3 and 4's tile culling, per detection

S_SPECIAL = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-40, 3e38, -0.25]


@st.composite
def field_tile_and_detection(draw):
    """A tile of 1-16 pixels of one row and a detection: field values
    (+-inf, NaN and -0.0 among them; often sorted, so that the pixel with
    the extreme value sits at the bound's column), ascending column
    coordinates (ties allowed), a row coordinate, the detection's half
    anchor size per axis (+-0, negative, NaN, +-inf and subnormal among
    them) and its box.  Per axis the centre is a pixel's position, their
    midpoint or any value, and t*b is often one pixel's distance |g - c|
    (computed as the predicate computes it) or one ulp either side of it:
    tiles all in, all out and tied on their bounds on both axes."""
    n = draw(st.integers(1, 16))
    small = st.floats(-1, 1, width=32)
    vals = st.one_of(small, f32s, st.sampled_from([np.nan, np.inf, -np.inf, -0.0]))
    # half the planes finite (an axis can then be all in), half with specials
    fx, fy = (draw(st.lists(draw(st.sampled_from([small, vals])), min_size=n, max_size=n))
              for _ in range(2))
    fx = {"none": fx, "up": sorted(fx), "down": sorted(fx)[::-1]}[
        draw(st.sampled_from(["none", "up", "down"]))]
    cols = sorted(draw(st.lists(st.floats(0, 1, width=32), min_size=n, max_size=n)))
    row = draw(st.floats(0, 1, width=32))
    half = st.floats(-0.5, 0.5, width=32)
    s = [draw(st.one_of(half, half, st.sampled_from(S_SPECIAL))) for _ in range(2)]
    c, tb = [], []
    with np.errstate(invalid="ignore", over="ignore"):
        for f, col, si in ((fx, cols, s[0]), (fy, [row] * n, s[1])):
            g = np.float32(f) * np.float32(si) + np.float32(col)  # each op rounded to f32
            finite = g[np.isfinite(g)]
            mid = [float((finite.min() + finite.max()) / 2)] if len(finite) else []
            ci = np.float32(draw(st.one_of(st.sampled_from([float(v) for v in g] + mid),
                                           st.floats(-1, 2, width=32))))
            # the pixels' distances, and those of the corners the tile's
            # bounds are made of (its extreme field values at its first and
            # last column)
            fin = np.float32(f)[~np.isnan(np.float32(f))]
            corners = np.float32([v * np.float32(si) + np.float32(x)
                                  for v in (fin.min(), fin.max()) for x in (col[0], col[-1])]
                                 if len(fin) else [])
            dist = np.abs(np.concatenate([g, corners]) - ci)
            dist = dist[np.isfinite(dist)]
            ends = [dist.min(), dist.max()] if len(dist) else [np.float32(0.5)] * 2
            near = [float(v) for d in ends for v in (
                d, np.nextafter(d, np.float32(np.inf)), np.nextafter(d, np.float32(0)))]
            top = near[3:5]  # the largest distance: a tie on the tile's bound, or all in
            c.append(float(ci))
            tb.append(draw(st.one_of(st.sampled_from(top), st.sampled_from(top),
                                     st.sampled_from(near),
                                     st.sampled_from([0.0, -0.25, np.inf, np.nan]),
                                     st.floats(2.0 ** -10, 1, width=32))))
    return [torch.tensor(v, dtype=torch.float32) for v in (fx, fy, cols, row, s, c, tb)]


@settings(max_examples=500, deadline=None, derandomize=True, database=None)
@given(field_tile_and_detection())
def test_per_detection_tile_rule_never_contradicts_the_predicate(case):
    """Kernels 3 and 4's rule, from the tile's field bounds and the
    detection's own anchor size: no tile classed all out holds a set pixel
    of the plain predicate, no tile classed all in an unset one, and an
    axis whose bounds are all in (the kernels then skip that axis's
    per-pixel compare) passes every pixel's compare on that axis."""
    fx, fy, cols, row, s, c, tb = case
    lims, nan = field_bounds(fx, fy)
    bounds = position_bounds(lims, nan, s, cols[0], cols[-1], row)
    cls = int(classify_tiles(bounds, c, tb))
    ok_x = (fx * s[0] + cols - c[0]).abs() < tb[0]
    ok_y = (fy * s[1] + row - c[1]).abs() < tb[1]
    if cls == ALL_OUT:
        assert not (ok_x & ok_y).any()
    elif cls == ALL_IN:
        assert (ok_x & ok_y).all()
    for ok, lo, hi, ci, ti in ((ok_x, bounds[0], bounds[1], c[0], tb[0]),
                               (ok_y, bounds[2], bounds[3], c[1], tb[1])):
        if -ti < lo - ci and hi - ci < ti:
            assert ok.all()


def test_per_detection_tile_rule_with_negative_and_zero_sizes():
    """s < 0 swaps the field's min and max; s = +-0 puts every pixel on its
    own coordinate, unless the field holds an inf (inf * 0 is NaN)."""
    fx = torch.tensor([-1.0, 0.5, 2.0])
    fy = torch.zeros(3)
    cols, row = torch.tensor([0.25, 0.5, 0.75]), torch.tensor(0.5)
    c, tb = torch.tensor([0.0, 0.5]), torch.tensor([0.2, 0.1])
    # s = -0.5: gx min from fx max, 2 * -0.5 + 0.25; gx max from fx min,
    # -1 * -0.5 + 0.75
    lims, nan = field_bounds(fx, fy)
    s = torch.tensor([-0.5, 1.0])
    xlo, xhi, _, _ = position_bounds(lims, nan, s, cols[0], cols[-1], row)
    assert float(xlo) == -0.75 and float(xhi) == 1.25
    assert int(classify_tiles(position_bounds(lims, nan, s, cols[0], cols[-1], row), c, tb)) == 2
    for zero in (0.0, -0.0):
        s = torch.tensor([zero, zero])
        b = position_bounds(lims, nan, s, cols[0], cols[-1], row)
        assert [float(v) for v in b] == [0.25, 0.75, 0.5, 0.5]
    lims, nan = field_bounds(torch.tensor([0.0, np.inf, 1.0]), fy)
    b = position_bounds(lims, nan, torch.tensor([0.0, 1.0]), cols[0], cols[-1], row)
    assert torch.isnan(b[1]) and int(classify_tiles(b, torch.tensor([0.5, 0.5]),
                                                    torch.tensor([1.0, 1.0]))) == 2


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("f", [[-0.25, 0.0, 0.5], [-0.5, 0.0, 0.25]], ids=["hi", "lo"])
def test_per_detection_tile_rule_at_exact_ties(axis, f):
    """On one axis, positions f * 0.5 + 0.5 (exact: 0.375, 0.5, 0.75 or
    0.25, 0.5, 0.625; the other axis all in) and t*b = 0.25.  Around c =
    0.5 one extreme pixel lies exactly at c -+ t*b: mixed, and one ulp more
    of t*b makes it all in.  With c = t*b beyond the lowest or highest
    position the nearest pixel lies exactly on the edge: all out, and one
    ulp more makes it mixed."""
    f = torch.tensor(f)
    fields = (f, torch.zeros(3)) if axis == 0 else (torch.zeros(3), f)
    lims, nan = field_bounds(*fields)
    half, row = torch.tensor([0.5, 0.5]), torch.tensor(0.5)
    bounds = position_bounds(lims, nan, half, row, row, row)
    pos = f * 0.5 + 0.5
    tie = np.float32(0.25)
    for tb, want in ((tie, (2, ALL_OUT, ALL_OUT)),
                     (np.nextafter(tie, np.float32(1)), (ALL_IN, 2, 2))):
        for ci, w in zip((0.5, float(pos[0] - tie), float(pos[-1] + tie)), want):
            c = torch.tensor([ci, 0.5] if axis == 0 else [0.5, ci])
            t = torch.tensor([tb, 1.0] if axis == 0 else [1.0, tb])
            assert int(classify_tiles(bounds, c, t)) == w, (float(tb), ci)


def _per_detection_tile_inputs(rng, b, h, w, k):
    """A normal field with NaN and +-inf, boxes covering the image, zero and
    negative boxes, off-table anchors, and half sizes of zero, -0.0,
    negative, NaN and inf."""
    field = (rng.standard_normal((b, A, 2, h, w)) * 0.2).astype(np.float32)
    field[0, 3, 0, 2, 5], field[1, 3, 1, 7, 9], field[0, 3, 0, 4, w - 3] = np.nan, np.inf, -np.inf
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)),
                            rng.uniform(0.05, 0.6, (b, k, 2))], -1).astype(np.float32)
    boxes[:, :3] = [0.5, 0.5, 4.0, 4.0]  # covers the image: all-in tiles
    boxes[:, -2] = 0.0
    boxes[:, -1] = [0.5, 0.5, -1.0, 1.0]  # negative side: never inside
    anchor_idx = rng.integers(0, A, (b, k)).astype(np.int32)
    anchor_idx[:, :6] = 3
    anchor_idx[0, 7], anchor_idx[1, 8] = A, -1  # off the table
    anchor_wh = rng.uniform(0.05, 0.7, (b, k, 2)).astype(np.float32)
    anchor_wh[0, 1:6] = [[0.0, 0.3], [-0.0, -0.0], [-0.3, 0.2], [np.nan, 0.1], [np.inf, 0.4]]
    return [torch.from_numpy(a) for a in (field, boxes, anchor_wh, anchor_idx)]


def _assert_tiles_agree(cls, masks, w):
    """Every tile classed all out (or EMPTY) is zero in ``masks`` (B, K, H,
    W) {0, 1}, every tile classed all in is ones, past W excepted."""
    b, k, h = masks.shape[:3]
    nw = -(-w // TILE_W)
    words = np.pad(masks, [(0, 0)] * 3 + [(0, nw * TILE_W - w)], constant_values=2)
    words = words.reshape(b, k, h, nw, TILE_W)
    zero, ones = ((words == 0) | (words == 2)).all(-1), ((words == 1) | (words == 2)).all(-1)
    assert cls.shape == (b, k, h, nw)
    assert zero[cls == ALL_OUT].all() and zero[cls == EMPTY].all()
    assert ones[cls == ALL_IN].all()


@pytest.mark.parametrize("w", [544, 40])
def test_per_detection_tile_classes_agree_with_the_plain_masks(w):
    """``tile_classes_per_detection`` against kernel 3's plain masks at W =
    544 and at a width that ends in a partial tile."""
    torch.set_num_threads(1)
    args = _per_detection_tile_inputs(np.random.default_rng(w + 1), 2, 12, w, 16)
    cls = tile_classes_per_detection(*args, 0.3).numpy()
    _assert_tiles_agree(cls, assemble_masks_plain(*args, 0.3).numpy(), w)
    assert (cls == ALL_IN).any() and (cls == ALL_OUT).any() and (cls == 2).any()
    assert (cls[0, 7] == EMPTY).all() and (cls[1, 8] == EMPTY).all()
    assert not (cls[:, -1] == ALL_IN).any()


def test_per_detection_tile_classes_agree_with_the_plain_masks_on_a_painted_field():
    """The same agreement at 544² on chip_smoke.py's painted field with each
    detection's anchor size within 5% of its anchor's row (phase 9's
    painted case): most tiles all out, the instances' interiors all in."""
    torch.set_num_threads(1)
    args, thresh, _ = _chip_smoke().painted_per_detection_inputs(
        np.random.default_rng(9), 1, device="cpu")
    cls = tile_classes_per_detection(*args, thresh).numpy()
    _assert_tiles_agree(cls, assemble_masks_plain(*args, thresh).numpy(), W)
    n = {c: (cls == c).sum() for c in (ALL_OUT, ALL_IN, 2)}
    assert n[ALL_OUT] > 0.9 * cls.size and n[ALL_IN] > 0 and n[2] > 0


def test_per_detection_tile_classes_equal_kernel_2s_on_table_sizes():
    """With each detection's size a row of the table, the per-detection rule
    equals kernel 2's ``tile_classes`` where the field is constant over
    each tile (the bounds coincide: a zero field, and one random value a
    tile).  On a normal field kernel 2 bounds the positions themselves,
    which is tighter: wherever the per-detection rule is definite, kernel
    2's class is the same, and kernel 2 has no more mixed tiles."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(12)
    b, h, k = 2, 10, 24
    cols = np.arange(W, dtype=np.float32) * np.float32(1.0 / W)
    boxes = np.stack([cols[rng.integers(0, W, (b, k))], rng.uniform(0.2, 0.8, (b, k)),
                      rng.uniform(0.05, 0.6, (b, k)), rng.uniform(0.05, 0.6, (b, k))],
                     -1).astype(np.float32)
    anchor_idx = rng.integers(0, A, (b, k)).astype(np.int32)
    table = rng.uniform(0.05, 0.7, (A, 2)).astype(np.float32)
    table[1] = -table[1]  # s < 0
    per_tile = np.repeat(rng.standard_normal((b, A, 2, h, W // TILE_W)), TILE_W, -1) * 0.1
    for name, field in (("zero", np.zeros((b, A, 2, h, W))), ("per tile", per_tile),
                        ("normal", rng.standard_normal((b, A, 2, h, W)) * 0.1)):
        field = torch.from_numpy(field.astype(np.float32))
        k2 = tile_classes(field, *(torch.from_numpy(a) for a in (boxes, anchor_idx, table)), 1.0)
        k3 = tile_classes_per_detection(field, *(torch.from_numpy(a) for a in (
            boxes, table[anchor_idx], anchor_idx)), 1.0)
        if name == "normal":
            definite = k3 != 2
            assert torch.equal(k2[definite], k3[definite]), name
            assert (k2 == 2).sum() <= (k3 == 2).sum()
        else:
            assert torch.equal(k2, k3), name
        assert (k3 == ALL_IN).any() and (k3 == 2).any()
