"""Port pose-only solver vs the JAX package (fast GN path and LM path) on the
test_pose_solver.py-style instance: pose within 1e-4 and identical inlier
masks. The normal equations are summed in another order on each side, so
poses agree to float32 rounding, not bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import lie as jlie
from vo_slam_test_tpu.solvers import pose_only as jpo
from vo_slam_test_tpu_torch.solvers import pose_only

FX, FY, CX, CY, BF = 517.3, 516.5, 318.6, 255.3, 40.0


def make_scene(n=300, seed=0, noise=0.3, outlier_frac=0.0, stereo_frac=0.7):
    rng = np.random.default_rng(seed)
    pw = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], size=(n, 3)).astype(np.float32)
    xi_gt = np.array([0.05, -0.08, 0.12, 0.03, -0.02, 0.04], np.float32)
    T_gt = np.asarray(jlie.se3_exp(jnp.asarray(xi_gt)))
    pc = pw @ T_gt[:3, :3].T + T_gt[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX + rng.normal(0, noise, n)
    v = FY * pc[:, 1] / pc[:, 2] + CY + rng.normal(0, noise, n)
    ur = u - BF / pc[:, 2] + rng.normal(0, noise, n)
    ur = np.where(rng.uniform(size=n) < stereo_frac, ur, -1.0)
    is_out = rng.uniform(size=n) < outlier_frac
    u = np.where(is_out, u + rng.uniform(15, 60, n) * rng.choice([-1, 1], n), u)
    v = np.where(is_out, v + rng.uniform(15, 60, n) * rng.choice([-1, 1], n), v)
    octave = rng.integers(0, 8, n)
    obs = dict(
        p_world=pw, uv=np.stack([u, v], -1).astype(np.float32), u_right=ur.astype(np.float32),
        inv_sigma2=(1.0 / 1.2 ** (2 * octave)).astype(np.float32), valid=np.ones(n, bool))
    xi0 = np.array([0.03, 0.02, -0.04, -0.015, 0.01, 0.02], np.float32)
    T0 = (np.asarray(jlie.se3_exp(jnp.asarray(xi0))) @ T_gt).astype(np.float32)
    return T0, obs


CASES = {
    "outliers": dict(noise=0.4, outlier_frac=0.25, seed=3),
    "clean": dict(noise=0.0, seed=0),
    "few_points": dict(n=8, noise=0.0, seed=7),   # < 10 inliers: round 1 is kept
}


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_pose_only_matches_jax(case, fast):
    T0, obs = make_scene(**CASES[case])
    if case == "clean":   # half the set invalid and corrupted
        obs["uv"][150:] += 500.0
        obs["valid"] = np.arange(300) < 150
    T_j, inl_j, n_j = jpo.solve_pose_only(
        jnp.asarray(T0), jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        FX, FY, CX, CY, BF, fast=fast)
    T_p, inl_p, n_p = pose_only.solve_pose_only(
        torch.as_tensor(T0), pose_only.PoseObs(**{k: torch.as_tensor(v) for k, v in obs.items()}),
        FX, FY, CX, CY, BF, fast=fast)
    np.testing.assert_allclose(T_p.numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    assert int(n_p) == int(n_j)
    if case == "few_points":
        assert int(n_p) <= 8
    else:
        assert int(n_p) >= 140
