"""The port's exact top-k (orienmask_tpu_torch/ops/topk.py) against
orienmask_tpu/ops/pallas_topk.py::exact_topk (interpret mode) and
jax.lax.top_k: values and indices must be EXACTLY equal.

The CUDA kernel's own parity with the plain version is checked on the card
by chip_smoke.py on the same cases."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orienmask_tpu.ops.pallas_topk import exact_topk as jax_exact_topk
from orienmask_tpu_torch.ops.topk import (
    CHUNK,
    KEYS_PER_CTA,
    MAX_CLUSTER,
    MAX_K,
    MAX_P,
    SMS,
    exact_topk,
    exact_topk_plain,
    exact_topk_split,
    launch_plan,
    split_chunk,
)


def _random(p, seed):
    return np.random.default_rng(seed).standard_normal(p).astype(np.float32)


def _sentinels(p, seed):
    rng = np.random.default_rng(seed)
    x = np.full(p, -1.0, np.float32)
    pos = rng.choice(p, 37, replace=False)
    x[pos] = rng.uniform(0.005, 1.0, 37)
    return x


def _quantized(p, seed):
    return np.random.default_rng(seed).choice(
        np.float32([0.1, 0.2, 0.3, -1.0]), p)


def _all_equal(p, seed):
    return np.full(p, 0.25, np.float32)


# (name, row maker, P, k, also compare with the JAX kernel)
CASES = [
    ("random_detect", _random, 18207, 400, True),
    ("random_pair", _random, 32000, 400, True),
    ("sentinels", _sentinels, 18207, 400, True),
    ("quantized_ties", _quantized, 32000, 400, True),
    ("all_equal", _all_equal, 18207, 400, True),
    ("p_not_multiple_of_32", _random, 1001, 400, True),
    ("k_equals_p", lambda p, s: np.random.default_rng(s).uniform(-2, 2, p)
     .astype(np.float32), 300, 300, True),
    # The JAX kernel pads with -3.0 and is documented wrong for inputs
    # <= -3.0 (ADVICE.md finding 1): these compare with lax.top_k only.
    ("below_minus_three", lambda p, s: _random(p, s) * 4.0 - 6.0, 18207, 400, False),
    ("minus_inf", lambda p, s: np.where(_random(p, s) > 0.3, -np.inf,
                                        _random(p, s + 1) - 5.0).astype(np.float32),
     32000, 400, False),
]


@pytest.mark.parametrize("name,make,p,k,with_kernel", CASES, ids=[c[0] for c in CASES])
def test_plain_topk_matches_jax(name, make, p, k, with_kernel):
    torch.set_num_threads(1)
    rows = np.stack([make(p, 11 * s) for s in range(2)])  # B = 2
    got_v, got_i = exact_topk_plain(torch.from_numpy(rows), k)
    for b in range(rows.shape[0]):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows[b]), k)
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(want_i))
        if with_kernel:
            ker_v, ker_i = jax_exact_topk(jnp.asarray(rows[b]), k, interpret=True)
            np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(ker_v))
            np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(ker_i))


def test_wrapper_takes_plain_version_on_cpu():
    torch.set_num_threads(1)
    x = torch.from_numpy(np.stack([_quantized(5000, s) for s in range(4)]))
    v, i = exact_topk(x, 400)
    pv, pi = exact_topk_plain(x, 400)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert i.dtype == torch.int64 and v.shape == (4, 400)


def test_kernel_row_limit_covers_detect_stage():
    """Both detect-stage rows (18207 and 400*80 = 32000) at k = 400, and the
    two levels of the exact selection's split (chunks of CHUNK keys, then 45
    chunks x 400 winners), are within the kernel's limits: k <= MAX_K, and
    the row fits in the registers of a cluster of at most MAX_CLUSTER CTAs
    (KEYS_PER_CTA keys each), a portable cluster size."""
    k = 400
    assert MAX_CLUSTER <= 8 and MAX_P == MAX_CLUSTER * KEYS_PER_CTA
    for p in (18207, 32000, CHUNK, -(-18207 * 80 // CHUNK) * k):
        assert k <= min(p, MAX_K) and p <= MAX_P


# (B, P) -> (C, chunk): the main path's two rows, the exact selection
# (B = 16 rows of 18207 x 80 pairs) and its two levels, a batch of two
# frames, rows shorter than the cluster, k = P (the plan does not read k).
PLAN_CASES = [
    ("infer_detect_max", 1, 18207, (8, None)),
    ("infer_pairs", 1, 32000, (8, None)),
    ("infer_b2", 2, 32000, (8, None)),
    ("exact_selection", 16, 18207 * 80, (None, 32368)),
    ("eval_level1_720_rows", 16 * 45, 32368, (4, None)),
    ("eval_level2", 16, 45 * 400, (8, None)),
    ("p_less_than_c", 3, 5, (8, None)),
    ("k_equals_p", 2, 300, (8, None)),
    ("max_p", 1, MAX_P, (8, None)),
    ("one_past_max_p", 1, MAX_P + 1, (None, 21846)),
    ("many_short_rows", 1000, 1000, (1, None)),
    ("many_long_rows", 200, 3 * KEYS_PER_CTA, (3, None)),
    # batch inference's detect-stage rows: the cluster sizes between 3 and 8
    ("batch_17_rows", 17, 18207, (7, None)),
    ("batch_22_rows", 22, 18207, (6, None)),
    ("batch_26_rows", 26, 18207, (5, None)),
    ("batch_27_rows", 27, 18207, (4, None)),
    ("batch_40_rows", 40, 18207, (3, None)),
]


@pytest.mark.parametrize("name,b,p,want", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_launch_plan(name, b, p, want):
    c, chunk = launch_plan(b, p)
    assert (c, chunk) == want
    if chunk is None:
        # the cluster holds the row, is portable, and few rows fill no more
        # than one CTA an SM unless the row needs more CTAs
        assert 1 <= c <= MAX_CLUSTER and c * KEYS_PER_CTA >= p
        assert b * c <= SMS or c == -(-p // KEYS_PER_CTA)
    else:
        # each level of the split is one launch (k = 400, the configs' nms_pre)
        assert chunk == split_chunk(p) <= CHUNK
        n = -(-p // chunk)
        assert launch_plan(b * n, chunk)[1] is None
        assert launch_plan(b, n * 400)[1] is None


# Rows past one launch (the exact selection's 1,456,560 pairs at 544²): the
# two-level split, with the plain top-k as each level, against lax.top_k.
# (name, row maker, P, k); every P leaves a short last chunk.
SPLIT_CASES = [
    ("sentinels", lambda p, s: np.where(np.random.default_rng(s).uniform(size=p) < 0.002,
                                        np.random.default_rng(s + 1).uniform(0.005, 1, p),
                                        -1.0).astype(np.float32), MAX_P + 4001, 400),
    ("heavy_ties", _quantized, 3 * CHUNK + 77, 400),
    ("all_equal", _all_equal, 2 * CHUNK + 5, 400),
    ("last_chunk_shorter_than_k", _random, 2 * CHUNK + 100, 400),
    ("minus_inf", lambda p, s: np.where(_random(p, s) > -2.5, -np.inf, _random(p, s + 1))
     .astype(np.float32), MAX_P + 1, 1024),
    # one past the largest row of one launch
    ("one_key_in_last_chunk", _sentinels, 2 * CHUNK + 1, 400),
    # chunks that fill the row exactly: no padding
    ("even_chunks_no_pad", _quantized, 3 * 30000, 400),
]
# Chunks are as even as their count allows (split_chunk), so a last chunk
# no longer falls short of k or holds one key: those two cases keep their
# names and check a padded last chunk.


@pytest.mark.parametrize("name,make,p,k", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_two_level_topk_matches_lax_top_k(name, make, p, k):
    torch.set_num_threads(1)
    rows = np.stack([make(p, 7 * s + 1) for s in range(2)])
    got_v, got_i = exact_topk_split(torch.from_numpy(rows), k, exact_topk_plain)
    assert got_i.dtype == torch.int64 and got_v.shape == (2, k)
    for b in range(2):
        want_v, want_i = jax.lax.top_k(jnp.asarray(rows[b]), k)
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(want_i))


def test_two_level_topk_of_the_exact_selection_row():
    """One row of the exact selection's length, 18207 x 80 pairs (45 chunks
    of 32,368, no padding), mostly the -1.0 below-threshold sentinel, with
    ties among the kept scores."""
    torch.set_num_threads(1)
    p = 18207 * 80
    rng = np.random.default_rng(3)
    row = np.full(p, -1.0, np.float32)
    pos = rng.choice(p, 3000, replace=False)
    row[pos] = rng.choice(np.float32([0.25, 0.5, 0.75]), 3000)
    row[pos[:500]] = rng.uniform(0.01, 1.0, 500)
    got_v, got_i = exact_topk_split(torch.from_numpy(row[None]), 400, exact_topk_plain)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 400)
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
