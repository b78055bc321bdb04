"""Threefry with device keys (vo_slam_test_tpu_torch/utils/prng.py): a key
made from a 0-d integer tensor (the relocalization's seed frame_id * K + i,
computed on the device from the device frame counter) draws the same bits,
uniforms, gumbels and RANSAC picks as the key of the same seed as a Python
int, for seeds near 2^31 and 2^32 and for an int32 seed that wrapped, as
JAX's int32 arithmetic wraps before ``astype(uint32)``; and the int key's
bits equal jax.random's."""

import jax
import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.utils import prng

SHAPE = (128, 300)
SEEDS = [0, 7, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 2**32, 2**32 + 9]


@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_draws_equal_int_key(seed):
    k_int = prng.prng_key(seed)
    for k_dev in (prng.prng_key(torch.tensor(seed, dtype=torch.int64)),
                  prng.prng_key(torch.tensor(seed, dtype=torch.int64).to(torch.int32))):
        assert torch.equal(prng.random_bits(k_int, SHAPE), prng.random_bits(k_dev, SHAPE))
        assert torch.equal(prng.gumbel(k_int, SHAPE), prng.gumbel(k_dev, SHAPE))
        assert torch.equal(prng.top_k(prng.gumbel(k_int, SHAPE), 4)[1],
                           prng.top_k(prng.gumbel(k_dev, SHAPE), 4)[1])
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(np.uint32(seed % 2**32)), SHAPE))
    np.testing.assert_array_equal(prng.random_bits(k_int, SHAPE).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("frame", [0, 11, 268_435_455, 268_435_456, 536_870_911, 2**31 - 1])
def test_relocalization_seed_wraps_as_jax(frame):
    """frame_id * K + i on an int32 device counter (K = 8) -> the key of
    JAX's ``PRNGKey((frame * K + i).astype(uint32))`` with int32 wrap."""
    for i in range(8):
        dev_seed = torch.tensor(frame, dtype=torch.int32).to(torch.int64) * 8 + i
        want = (np.int64(frame) * 8 + i) % 2**32
        assert prng.prng_key(dev_seed)[1].item() == prng.prng_key(int(want))[1] == want
