"""The port's mask assembly (orienmask_tpu_torch/ops/masks.py) against the
three kernels of orienmask_tpu/ops/pallas_masks.py in interpret mode
(assemble_masks_anchor_resident, assemble_masks, assemble_masks_bitpacked):
bytes must be BIT-identical.

W = 544, the network width: the kernel's column coordinate x * f32(1/W)
differs from x / W by one ulp in 31 of its columns, which a narrow test
width would hide.  The CUDA kernels' parity with the plain versions is
checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orienmask_tpu.ops import pallas_masks
from orienmask_tpu.ops.pallas_masks import assemble_masks_anchor_resident
from orienmask_tpu_torch.ops.masks import (
    assemble_masks,
    assemble_masks_bitpacked,
    assemble_masks_bitpacked_plain,
    assemble_masks_packed,
    assemble_masks_packed_plain,
    assemble_masks_plain,
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
