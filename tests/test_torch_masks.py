"""The port's mask assembly (orienmask_tpu_torch/ops/masks.py) against
orienmask_tpu/ops/pallas_masks.py::assemble_masks_anchor_resident in
interpret mode: packed bytes must be BIT-identical.

W = 544, the network width: the kernel's column coordinate x * f32(1/W)
differs from x / W by one ulp in 31 of its columns, which a narrow test
width would hide.  The CUDA kernel's parity with the plain version is
checked on the card by chip_smoke.py."""

import numpy as np
import torch

import jax.numpy as jnp

from orienmask_tpu.ops.pallas_masks import assemble_masks_anchor_resident
from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain

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
