"""The port's host quad-tree (``frontend/distribute.py``) against the JAX
package's on seeded inputs: the kept index arrays must be equal, in order.
Both are numpy; the port keeps its own copy. Also the twins of
``tests/test_extractor.py::TestDistribute``."""

import numpy as np
import pytest

from vo_slam_test_tpu.frontend.distribute import distribute_octtree as j_distribute
from vo_slam_test_tpu_torch.frontend.distribute import distribute_octtree

BOUNDS = (16, 624, 16, 464)


def clustered(rng, n):
    centers = rng.uniform([60, 60], [580, 420], (6, 2))
    pts = centers[rng.integers(0, 6, n)] + rng.normal(0, 12, (n, 2))
    return (np.clip(pts[:, 0], 16, 623.9).astype(np.float32),
            np.clip(pts[:, 1], 16, 463.9).astype(np.float32))


def spread(rng, n):
    return rng.uniform(16, 624, n).astype(np.float32), rng.uniform(16, 464, n).astype(np.float32)


def integer_grid(rng, n):
    """FAST candidates sit on integer pixels: many share a coordinate with a
    node's integer corner, where the strict ``<`` decides."""
    return (rng.integers(16, 624, n).astype(np.float32),
            rng.integers(16, 464, n).astype(np.float32))


MAKERS = {"clustered": clustered, "spread": spread, "integer": integer_grid}
CASES = [
    ("clustered", 2000, 200), ("clustered", 600, 60), ("spread", 30, 500),   # sparse
    ("spread", 2500, 300), ("integer", 3000, 150), ("integer", 4000, 1000),  # overflow finishing
    ("clustered", 1, 10), ("spread", 5000, 4),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind,n,target", CASES)
def test_keep_equal_to_jax(kind, n, target, seed):
    rng = np.random.default_rng(seed)
    xs, ys = MAKERS[kind](rng, n)
    resp = rng.uniform(1, 200, n).astype(np.float32)
    got = distribute_octtree(xs, ys, resp, *BOUNDS, target)
    want = j_distribute(xs, ys, resp, *BOUNDS, target)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int64
    assert 0 < got.size <= min(target + 2, n)


def test_empty_input():
    e = np.empty(0, np.float32)
    assert distribute_octtree(e, e, e, *BOUNDS, 10).size == 0


def test_spreads_points():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.uniform(100, 140, 500), rng.uniform(16, 624, 100)]).astype(np.float32)
    ys = np.concatenate([rng.uniform(100, 140, 500), rng.uniform(16, 464, 100)]).astype(np.float32)
    resp = rng.uniform(1, 50, 600).astype(np.float32)
    keep = distribute_octtree(xs, ys, resp, 16, 624, 16, 464, 200)
    np.testing.assert_array_equal(keep, j_distribute(xs, ys, resp, 16, 624, 16, 464, 200))
    assert 150 <= keep.size <= 260
    assert (keep >= 500).sum() >= 80  # the spread points survive disproportionately


def test_small_input_reference_semantics():
    # both points share a quadrant at every split: the no-progress rule stops
    # the pass and keeps the shared node's best response only
    xs = np.array([10.0, 20.0]); ys = np.array([10.0, 30.0]); r = np.array([1.0, 2.0])
    keep = distribute_octtree(xs, ys, r, 0, 100, 0, 100, 50)
    assert set(keep) == {1}
    np.testing.assert_array_equal(keep, j_distribute(xs, ys, r, 0, 100, 0, 100, 50))
    # separable points both survive
    xs2 = np.array([10.0, 80.0]); ys2 = np.array([10.0, 70.0])
    keep2 = distribute_octtree(xs2, ys2, r, 0, 100, 0, 100, 50)
    assert set(keep2) == {0, 1}
    np.testing.assert_array_equal(keep2, j_distribute(xs2, ys2, r, 0, 100, 0, 100, 50))
