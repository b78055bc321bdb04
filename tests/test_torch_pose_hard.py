"""Twin of tests/test_pose_hard.py: fast damped GN against full LM pose
solving on the hard grid (large motion x few inliers x high outlier
fraction, identity init), in the port's ``solvers/pose_only.py``, on the JAX
test's instances (its ``_make_instance`` on the same seeds, 17 and 23).

Per grid: the JAX test's gates hold on the port's (fast, LM) pair; and the
port's fast solve agrees with JAX's fast solve on every instance: pose
translation within 1e-4 m (observed at most 4.2e-7 m) and the inlier sets
equal on at least 99% of the valid rows (observed: every row of all 56
instances, with equal inlier counts). ``slow``, as the JAX file is. The JAX
side runs once per file.
"""

import jax
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.solvers.pose_only import solve_pose_only as jsolve
from vo_slam_test_tpu_torch.solvers.pose_only import PoseObs, solve_pose_only
from test_pose_hard import BF, CX, CY, FX, FY, GRID, _make_instance

pytestmark = pytest.mark.slow  # JAX compiles two solvers; the grid runs in both packages

torch.set_num_threads(1)


def _instances(seed, reps):
    rng = np.random.default_rng(seed)
    return [_make_instance(rng, n_pts, of, ms) for (n_pts, of, ms) in GRID for _ in range(reps)]


@pytest.fixture(scope="module")
def grids():
    """Per grid: the instances (numpy) and JAX's fast and LM results."""
    fast = jax.jit(lambda T, o: jsolve(T, o, FX, FY, CX, CY, BF, fast=True))
    lm = jax.jit(lambda T, o: jsolve(T, o, FX, FY, CX, CY, BF, fast=False))
    out = {}
    for name, seed, reps in (("agreement", 17, 3), ("accuracy", 23, 1)):
        rows = []
        for T0, obs, T_gt, _ in _instances(seed, reps):
            jf = jax.device_get(fast(T0, obs))
            jl = jax.device_get(lm(T0, obs))
            rows.append(dict(T0=np.asarray(T0), obs=jax.device_get(obs), T_gt=T_gt,
                             fast=(np.asarray(jf[0]), np.asarray(jf[1]), int(jf[2])),
                             lm=(np.asarray(jl[0]), np.asarray(jl[1]), int(jl[2]))))
        out[name] = rows
    return out


def _port(row, fast):
    obs = PoseObs(*[torch.as_tensor(np.array(f)) for f in row["obs"]])
    T, inl, n = solve_pose_only(torch.as_tensor(np.array(row["T0"], np.float32)), obs,
                                FX, FY, CX, CY, BF, fast=fast)
    return T.numpy(), inl.numpy(), int(n)


def _against_jax_fast(row, pf):
    """Port fast against JAX fast: translation within 1e-4 m, inlier sets
    equal on >= 99% of the valid rows."""
    Tj, inj, _ = row["fast"]
    valid = np.asarray(row["obs"].valid)
    gap = float(np.linalg.norm(pf[0][:3, 3] - Tj[:3, 3]))
    assert gap < 1e-4, gap
    assert ((pf[1] & valid) == (inj & valid))[valid].mean() >= 0.99


def test_fast_gn_vs_full_lm_hard_grid(grids):
    gaps, agree, n_ok = [], [], 0
    for row in grids["agreement"]:
        pf, pl = _port(row, True), _port(row, False)
        _against_jax_fast(row, pf)
        assert np.isfinite(pf[0]).all() and np.isfinite(pl[0]).all()
        if min(pf[2], pl[2]) < 15:
            continue
        n_ok += 1
        valid = np.asarray(row["obs"].valid)
        gaps.append(float(np.linalg.norm(pf[0][:3, 3] - pl[0][:3, 3])))
        agree.append(((pf[1] & valid) == (pl[1] & valid))[valid].mean())
    assert n_ok >= 30, n_ok
    gaps, agree = np.asarray(gaps), np.asarray(agree)
    assert np.median(gaps) < 2e-3, np.median(gaps)
    assert np.percentile(gaps, 90) < 2e-2, np.percentile(gaps, 90)
    assert agree.mean() > 0.97, agree.mean()


def test_fast_gn_matches_lm_accuracy_vs_ground_truth(grids):
    err_f, err_l = [], []
    for row in grids["accuracy"]:
        pf, pl = _port(row, True), _port(row, False)
        _against_jax_fast(row, pf)
        if min(pf[2], pl[2]) < 15:
            continue
        err_f.append(float(np.linalg.norm(pf[0][:3, 3] - row["T_gt"][:3, 3])))
        err_l.append(float(np.linalg.norm(pl[0][:3, 3] - row["T_gt"][:3, 3])))
    err_f, err_l = np.asarray(err_f), np.asarray(err_l)
    assert err_f.size >= 8
    mf, ml = np.median(err_f), np.median(err_l)
    assert mf < max(1.5 * ml, ml + 2e-3), (mf, ml)
