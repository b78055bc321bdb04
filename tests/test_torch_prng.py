"""The port's counter-based generator (vo_slam_test_tpu_torch/utils/prng.py)
against jax.random on the CPU, exactly: the Threefry-2x32 bits of
``jax.random.bits``, and the RANSAC sample picks of the JAX package
(``lax.top_k`` of ``jax.random.gumbel`` plus the validity logits,
solvers/ransac.py:61-68 and solvers/epnp.py:215-218) at the system's shape
[128 hypotheses, 1000 keypoints], over seeds 0-63 and the large seeds of
frame 10^5 (frame_id * 8 + i, pipeline/system.py:459).

The gumbel values themselves come from two log implementations and may differ
in the last bit; adjacent uniforms map at least three ulps apart, so the
picks, which are what the system uses, must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.utils import prng

SHAPE = (128, 1000)
SEEDS = list(range(64)) + [100_000 * 8 + i for i in range(8)]


@jax.jit
def _jax_picks(seed, logits):
    key = jax.random.PRNGKey(seed.astype(jnp.uint32))
    g = jax.random.gumbel(key, SHAPE) + logits[None, :]
    return jax.lax.top_k(g, 4)[1]


@pytest.mark.parametrize("seed", [0, 1, 7, 63, 800_007, 2**31 - 1])
def test_random_bits_equal_jax(seed):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(np.uint32(seed)), SHAPE))
    got = prng.random_bits(prng.prng_key(seed), SHAPE).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_uniform_and_gumbel_close_to_jax():
    key_j = jax.random.PRNGKey(np.uint32(5))
    u_j = np.asarray(jax.random.uniform(key_j, SHAPE, minval=np.finfo(np.float32).tiny))
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(5), SHAPE,
                                               float(np.finfo(np.float32).tiny)).numpy(), u_j)
    g_j = np.asarray(jax.random.gumbel(key_j, SHAPE))
    np.testing.assert_allclose(prng.gumbel(prng.prng_key(5), SHAPE).numpy(), g_j,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masking", ["all_valid", "horn_1e9", "pnp_inf"])
def test_gumbel_top_k_picks_equal_jax(masking):
    """The picks over every seed, with the logits of each solver: 0 for all
    (no mask), -1e9 for invalid slots (Horn 3D-3D: every invalid slot rounds
    to -1e9, ties broken to the lower index) and -inf (EPnP)."""
    rng = np.random.default_rng(11)
    for seed in SEEDS:
        valid = rng.random(SHAPE[1]) < 0.4
        valid[:2] = False  # a tie among the first invalid slots when few are valid
        if masking == "all_valid":
            logits = np.zeros(SHAPE[1], np.float32)
        else:
            if seed % 8 == 0:
                valid[:] = False
                valid[[5, 900]] = True  # fewer valid slots than picks
            bad = -1e9 if masking == "horn_1e9" else -np.inf
            logits = np.where(valid, 0.0, bad).astype(np.float32)
        want = np.asarray(_jax_picks(jnp.asarray(seed, jnp.int32), jnp.asarray(logits)))
        g = prng.gumbel(prng.prng_key(seed), SHAPE) + torch.as_tensor(logits)[None, :]
        got = prng.top_k(g, 4)[1].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_top_k_ties_go_to_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, -np.inf]])
    vals, idx = prng.top_k(x, 6)
    assert idx.tolist() == [[1, 2, 4, 0, 3, 5]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 6)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
