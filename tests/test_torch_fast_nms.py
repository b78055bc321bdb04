"""The FAST kernel's 3x3-NMS mode: the port's plain version against the JAX
package's.

``fast.nms3x3`` and ``fast.fast_score_nms`` (the plain version of
``fast_cuda.fast_score(levels, with_nms=True)``, which is what a CPU tensor
runs) equal ``jnp.where(nms3x3(fast_score(x)), fast_score(x), 0)`` on every
pixel (both wrap in both axes), and the JAX package's Pallas kernel in
interpret mode away from a 5 px border, with the tolerance of
tests/test_fast_pallas.py (atol 1e-3; the kernel zero-pads its row halo, the
XLA roll wraps). Scores are integers, so every comparison is exact: a tie
suppresses both pixels, which the random batch of integers exercises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.ops import fast as jfast
from vo_slam_test_tpu.ops.fast_pallas import fast_score_nms_pallas
from vo_slam_test_tpu_torch.ops import fast, fast_cuda

torch.set_num_threads(1)


def jax_nms(levels: np.ndarray) -> np.ndarray:
    s = jfast.fast_score(jnp.asarray(levels))
    return np.asarray(jnp.where(jfast.nms3x3(s), s, 0.0))


@pytest.fixture(scope="module")
def frame_batch(synthetic_seq):
    """tests/test_fast_pallas.py's batch: frame 0 and its vertical flip."""
    gray, _, _ = synthetic_seq[0]
    return np.stack([gray, gray[::-1]]).astype(np.float32)


def random_batch(shape, seed=0):
    """Integers in [0, 255], many ties."""
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["frame", "random", "odd"])
def test_nms_plain_matches_jax_every_pixel(frame_batch, kind):
    levels = {"frame": frame_batch, "random": random_batch((2, 96, 128)),
              "odd": random_batch((3, 17, 29), seed=1)}[kind]
    x = torch.as_tensor(levels)
    want = jax_nms(levels)
    np.testing.assert_array_equal(fast.fast_score_nms(x).numpy(), want)
    np.testing.assert_array_equal(fast_cuda.fast_score(x, with_nms=True).numpy(), want)
    # the keep mask alone, on the score
    score = jfast.fast_score(jnp.asarray(levels))
    np.testing.assert_array_equal(fast.nms3x3(torch.as_tensor(np.array(score))).numpy(),
                                  np.asarray(jfast.nms3x3(score)))
    assert (want > 0).any()


def test_nms_plain_matches_pallas_interpret(frame_batch):
    want = np.asarray(fast_score_nms_pallas(jnp.asarray(frame_batch), interpret=True))
    got = fast.fast_score_nms(torch.as_tensor(frame_batch)).numpy()
    b = 5
    np.testing.assert_allclose(got[:, b:-b, b:-b], want[:, b:-b, b:-b], atol=1e-3)


def test_ties_suppress_both_and_raw_mode_unchanged():
    # two equal corners side by side: neither is strictly greater
    score = torch.zeros((1, 8, 8))
    score[0, 3, 3] = score[0, 3, 4] = 7.0
    score[0, 6, 1] = 5.0
    keep = fast.nms3x3(score)
    assert not keep[0, 3, 3] and not keep[0, 3, 4] and keep[0, 6, 1]
    levels = torch.as_tensor(random_batch((2, 40, 48), seed=2))
    assert torch.equal(fast_cuda.fast_score(levels), fast.fast_score(levels))
