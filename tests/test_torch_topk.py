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
from orienmask_tpu_torch.ops.topk import MAX_K, MAX_P, exact_topk, exact_topk_plain


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
    """Both detect-stage rows (18207 and 400*80 = 32000) at k = 400 are
    within the kernel's limits, and their keys (4 B each) fit in shared
    memory beside the 512 padded winners (8 B each): Hopper gives a block at
    most 227 KB."""
    k, kpad = 400, 512
    for p in (18207, 32000):
        assert k <= min(p, MAX_K) and p <= MAX_P
        assert kpad * 8 + p * 4 <= 227 * 1024
