"""The quad-tree kernel's formulation (``csrc/distribute.cu``) on the CPU.

The kernel computes ``ops/distribute_device.py::distribute_level``'s keep
mask without [M, M] matrices: from each valid candidate's least Morton-code
xor over the other valid candidates and over its dominators it gets two share
depths, from them the per-depth counts, the stop depth and the keep mask, and
it caps to the target by each kept candidate's count of kept dominators.
``mirror`` below repeats that arithmetic in numpy (the kernel itself runs only
on the card: ``tests/test_torch_kernels_gpu.py``); its keep mask must equal
the plain version's on every case.
"""

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.frontend.extractor import quad_tree_levels
from vo_slam_test_tpu_torch.ops import distribute_cuda, fast
from vo_slam_test_tpu_torch.ops.distribute_device import MAX_DEPTH, _cell_scale, distribute_level
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec

NO_PAIR = np.uint32(0xFFFFFFFF)


def spread_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0xFFFF)
    for s, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << np.uint32(s))) & np.uint32(m)
    return x


def share_depth(m: np.ndarray) -> np.ndarray:
    """The largest depth at which two candidates whose Morton codes differ by
    the xor ``m`` share a cell (-1 for none): 7 - ceil(bitlen(m) / 2)."""
    bitlen = np.frexp(m.astype(np.float64))[1]
    return np.maximum(MAX_DEPTH - ((bitlen + 1) >> 1), -1)


def mirror(xs, ys, resp, valid, bounds, target, n_ini):
    """The kernel's arithmetic for one level, in numpy."""
    min_x, max_x, min_y, max_y = bounds
    ncx, ncy = n_ini << MAX_DEPTH, 1 << MAX_DEPTH
    sx = np.float32(_cell_scale(max_x - min_x, ncx))
    sy = np.float32(_cell_scale(max_y - min_y, ncy))
    cx = np.clip(((xs.astype(np.float32) - np.float32(min_x)) * sx).astype(np.int32), 0, ncx - 1)
    cy = np.clip(((ys.astype(np.float32) - np.float32(min_y)) * sy).astype(np.int32), 0, ncy - 1)
    morton = spread_bits(cx) | (spread_bits(cy) << np.uint32(1))

    idx = np.flatnonzero(valid)  # the valid candidates in index order
    m, r = morton[idx], resp[idx].astype(np.float32)
    pos = np.arange(idx.size)
    x = m[:, None] ^ m[None, :]
    # j dominates i: a higher response, ties to the lower index
    dom = (r[None, :] > r[:, None]) | ((r[None, :] == r[:, None]) & (pos[None, :] < pos[:, None]))
    other = pos[None, :] != pos[:, None]
    max_other = share_depth(np.where(other, x, NO_PAIR).min(axis=1, initial=NO_PAIR))
    max_better = share_depth(np.where(dom, x, NO_PAIR).min(axis=1, initial=NO_PAIR))

    depths = np.arange(MAX_DEPTH + 1)[:, None]
    live = ((max_better < depths) & (max_other >= depths)).sum(axis=1)
    singles = (max_other + 1 <= depths).sum(axis=1)
    reached = (live + singles >= target) | (live == 0)
    stop = int(np.argmax(reached)) if reached.any() else MAX_DEPTH
    kept = (max_other + 1 <= stop) | ((max_better < stop) & (max_other >= stop))

    rank = (dom & kept[None, :]).sum(axis=1)  # kept dominators of each i
    keep = np.zeros(xs.size, bool)
    keep[idx[kept & (rank < target)]] = True
    return keep


B = fast.DETECT_BORDER


def _frame(n_ini):
    return (640, 480) if n_ini == 1 else (1000, 480)  # round((w - 32) / (h - 32))


def make_case(kind, M, n_ini, seed):
    """(xs, ys, resp, valid) int32, int32, f32, bool [M] inside the level's
    bounds."""
    rng = np.random.default_rng(seed)
    w, h = _frame(n_ini)
    resp = rng.uniform(1, 200, M).astype(np.float32)
    valid = rng.random(M) < 0.8
    if kind == "random":
        xs, ys = rng.integers(B, w - B, M), rng.integers(B, h - B, M)
    elif kind == "clustered":
        centers = rng.uniform([B + 20, B + 20], [w - B - 20, h - B - 20], (5, 2))
        p = centers[rng.integers(0, 5, M)] + rng.normal(0, 9, (M, 2))
        xs = np.clip(np.rint(p[:, 0]), B, w - B - 1)
        ys = np.clip(np.rint(p[:, 1]), B, h - B - 1)
    elif kind == "ties":  # few distinct responses: the index breaks the ties
        xs, ys = rng.integers(B, w - B, M), rng.integers(B, h - B, M)
        resp = rng.integers(1, 4, M).astype(np.float32)
    elif kind == "boundaries":  # every integer position of a row and a column
        col, row = np.arange(B, h - B), np.arange(B, w - B)
        ys = np.concatenate([col, np.full(row.size, B + 7)])
        xs = np.concatenate([np.full(col.size, B + 7), row])
        resp = np.full(xs.size, 80.0, np.float32)
        valid = np.ones(xs.size, bool)
    elif kind == "one_cell":  # many candidates in one depth-7 cell, some equal
        xs = np.where(np.arange(M) < M // 4, 100, rng.integers(B, w - B, M))
        ys = np.where(np.arange(M) < M // 4, 101, rng.integers(B, h - B, M))
        resp = np.where(np.arange(M) % 3 == 0, 50.0, resp).astype(np.float32)
    elif kind == "all_invalid":
        xs, ys = rng.integers(B, w - B, M), rng.integers(B, h - B, M)
        valid = np.zeros(M, bool)
    else:  # "sparse": a handful of valid candidates
        xs, ys = rng.integers(B, w - B, M), rng.integers(B, h - B, M)
        valid = np.zeros(M, bool)
        valid[rng.choice(M, 40, replace=False)] = True
    return xs.astype(np.int32), ys.astype(np.int32), resp, valid


CASES = [
    # kind, M, n_ini, target
    ("random", 560, 1, 60), ("random", 560, 2, 150), ("random", 2520, 1, 217),
    ("random", 2520, 2, 217), ("clustered", 560, 1, 40), ("clustered", 2520, 1, 217),
    ("clustered", 2520, 2, 400), ("ties", 560, 1, 60), ("ties", 2520, 2, 217),
    ("boundaries", 0, 1, 8), ("boundaries", 0, 2, 8), ("one_cell", 560, 1, 30),
    ("one_cell", 560, 2, 1), ("all_invalid", 560, 1, 50),
    ("sparse", 560, 1, 100),  # fewer valid than the target
    ("sparse", 560, 2, 40),   # exactly the target
    ("random", 560, 1, 1), ("clustered", 560, 2, 200),
]


@pytest.mark.parametrize("kind,M,n_ini,target", CASES)
def test_kernel_formulation_equals_plain(kind, M, n_ini, target):
    xs, ys, resp, valid = make_case(kind, M, n_ini, seed=M + 7 * n_ini + target)
    w, h = _frame(n_ini)
    bounds = (float(B), float(w - B), float(B), float(h - B))
    assert max(int(round((w - 2 * B) / (h - 2 * B))), 1) == n_ini
    want = distribute_level(*(torch.as_tensor(a) for a in (xs, ys, resp, valid)), bounds, target,
                            n_ini=n_ini).numpy()
    got = mirror(xs, ys, resp, valid, bounds, target, n_ini)
    np.testing.assert_array_equal(got, want)
    assert want.sum() <= target


def test_distribute_on_cpu_is_the_plain_version():
    """``distribute`` over a CPU [L, M] batch: each level's row is
    ``distribute_level``'s keep mask, with the 320x240 pyramid's quad-tree
    levels (``quad_tree_levels``: the bounds inside the FAST border, a root
    cell a level)."""
    spec = PyramidSpec(320, 240, 8, 1.2)
    budgets = spec.budget(500)
    M = 560
    rows = [make_case("random", M, 1, seed=lvl) for lvl in range(spec.n_levels)]
    xs, ys, resp, valid = (torch.as_tensor(np.stack(a)) for a in zip(*rows))
    levels = quad_tree_levels(spec, budgets)
    got = distribute_cuda.distribute(xs, ys, resp, valid, levels)
    assert got.shape == (spec.n_levels, M) and got.dtype == torch.bool
    for lvl, lv in enumerate(levels):
        want = distribute_level(xs[lvl], ys[lvl], resp[lvl], valid[lvl], lv.bounds, lv.target,
                                n_ini=lv.n_ini)
        assert torch.equal(got[lvl], want), lvl


def test_distribute_rejects_other_devices():
    t = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    lv = distribute_cuda.Level((16.0, 624.0, 16.0, 464.0), 10, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        distribute_cuda.distribute(t, t, t.float(), t.bool(), [lv])
