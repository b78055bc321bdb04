"""The fixed-trip loops as device loops: ``ops/undistort.py``'s 10
fixed-point trips, EPnP's 6 Gauss-Newton steps on the betas and the fast
pose round's 4 Gauss-Newton steps (``solvers/pose_only.py::
_solve_round_gn``), each a ``utils.graphs.repeat`` (the JAX package's
``lax.fori_loop`` / ``lax.scan``; one WHILE node in a capture).

On seeded inputs each is bit-equal to the unrolled Python loop it replaced
(a copy of it is kept here), eagerly and in ``select`` mode under
``no_host_reads``; eager makes no ``graphs.scan`` call (no trip index is
launched), select makes exactly one per loop; and each stays within the
tolerance of its twin against the JAX function (tests/test_torch_frontend.py
2e-4 px, tests/test_torch_reloc_solvers.py 1e-2, tests/
test_torch_pose_only.py 1e-4 with equal inlier masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.ops import undistort as jundistort
from vo_slam_test_tpu.solvers import epnp as jepnp
from vo_slam_test_tpu.solvers import pose_only as jpo
from vo_slam_test_tpu_torch import lie
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.ops import undistort
from vo_slam_test_tpu_torch.solvers import epnp, pose_only
from vo_slam_test_tpu_torch.utils import graphs
from test_epnp import make_scene as epnp_scene
from test_torch_pose_only import BF, CASES, CX, CY, FX, FY
from test_torch_pose_only import make_scene as pose_scene

torch.set_num_threads(1)
NO_DIST = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)


def t(a):
    return torch.as_tensor(np.asarray(a))


# the unrolled forms the loops replaced, op for op


def undistort_unrolled(uv, fx, fy, cx, cy, dist_coef, iters=10):
    k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def gauss_newton_betas_unrolled(V, rho, betas):
    dv = epnp._rho_v(V)
    for _ in range(epnp.GN_ITERS):
        cc = torch.einsum("...k,...kpx->...px", betas, dv)
        res = (cc * cc).sum(-1) - rho
        J = 2.0 * torch.einsum("...px,...kpx->...pk", cc, dv)
        JtJ = torch.einsum("...pi,...pj->...ij", J, J) + 1e-9 * epnp._eye(4, J)
        betas = betas - epnp._solve(JtJ, torch.einsum("...pi,...p->...i", J, res))
    return betas


def solve_round_gn_unrolled(T0, obs, active, fx, fy, cx, cy, bf, use_huber, iters):
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T = T0
    for _ in range(iters):
        H, g, _, _ = pose_only._normal_equations(T, obs, active, fx, fy, cx, cy, bf, use_huber)
        Hd = H + 1e-4 * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
        step = -torch.linalg.solve_ex(Hd, g)[0]
        ok = torch.all(torch.isfinite(step)) & (torch.max(torch.abs(step)) < 1.0)
        T = torch.where(ok, lie.se3_exp(step) @ T, T)
    return T


def both_modes(monkeypatch, fn):
    """``fn()`` eagerly and in select mode under ``no_host_reads`` ->
    (eager, select, the ``length`` of each ``graphs.scan`` call eagerly, in
    select mode)."""
    lengths = []
    scan = graphs.scan

    def rec(body, carry, xs=None, length=None, **kw):
        lengths.append(length)
        return scan(body, carry, xs, length, **kw)

    monkeypatch.setattr(graphs, "scan", rec)
    eager = fn()
    n_eager = list(lengths)
    with graphs.use("select"), graphs.no_host_reads():
        select = fn()
    return eager, select, n_eager, lengths[len(n_eager):]


def assert_bits(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("seed", [2, 5])
def test_undistort_is_one_device_loop(monkeypatch, seed):
    cfg = JConfig()
    dist = np.array([cfg.camera_k1, cfg.camera_k2, cfg.camera_p1, cfg.camera_p2, cfg.camera_k3],
                    np.float32)
    assert np.abs(dist).max() > 0
    uv = np.random.default_rng(seed).uniform([0, 0], [640, 480], (1024, 2)).astype(np.float32)
    k = [np.float32(v) for v in (cfg.camera_fx, cfg.camera_fy, cfg.camera_cx, cfg.camera_cy)]
    args = (t(uv), *[t(v) for v in k], t(dist))
    eager, select, n_eager, n_select = both_modes(
        monkeypatch, lambda: undistort.undistort_points(*args))
    assert (n_eager, n_select) == ([], [10])
    assert_bits(eager, undistort_unrolled(*args))
    assert_bits(select, eager)
    want = np.asarray(jundistort.undistort_points(jnp.asarray(uv), *k, jnp.asarray(dist)))
    np.testing.assert_allclose(eager.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("n,seed,noise", [(60, 1, 0.0), (50, 3, 0.3)])
def test_epnp_gauss_newton_is_one_device_loop(monkeypatch, n, seed, noise):
    cam = Camera.from_config(SlamConfig(**NO_DIST), "cpu")
    _, Xw, uv, _ = epnp_scene(n=n, seed=seed, noise_px=noise)
    w = np.ones(n, np.float32)
    eager, select, n_eager, n_select = both_modes(
        monkeypatch, lambda: epnp.epnp_pose(t(Xw), t(uv), t(w), cam))
    assert (n_eager, n_select) == ([], [epnp.GN_ITERS])
    monkeypatch.setattr(epnp, "_gauss_newton_betas", gauss_newton_betas_unrolled)
    assert_bits(eager, epnp.epnp_pose(t(Xw), t(uv), t(w), cam))
    assert_bits(select, eager)
    jcam = JCamera.from_config(JConfig(**NO_DIST))
    want = np.asarray(jepnp.epnp_pose(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(w), jcam))
    np.testing.assert_allclose(eager.numpy(), want, atol=1e-2)


def _pose_case(case):
    T0, obs = pose_scene(**CASES[case])
    if case == "clean":  # tests/test_torch_pose_only.py's half-invalid set
        obs["uv"][150:] += 500.0
        obs["valid"] = np.arange(300) < 150
    return T0, obs


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_pose_round_is_one_device_loop(monkeypatch, case):
    T0, obs = _pose_case(case)
    pobs = pose_only.PoseObs(**{k: torch.as_tensor(v) for k, v in obs.items()})

    def solve():
        return pose_only.solve_pose_only(torch.as_tensor(T0), pobs, FX, FY, CX, CY, BF, fast=True)

    eager, select, n_eager, n_select = both_modes(monkeypatch, solve)
    assert (n_eager, n_select) == ([], [4, 4])  # one loop per round
    monkeypatch.setattr(pose_only, "_solve_round_gn", solve_round_gn_unrolled)
    assert_bits(eager, solve())
    assert_bits(select, eager)
    T_j, inl_j, n_j = jpo.solve_pose_only(
        jnp.asarray(T0), jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        FX, FY, CX, CY, BF, fast=True)
    np.testing.assert_allclose(eager[0].numpy(), np.asarray(T_j), atol=1e-4)
    np.testing.assert_array_equal(eager[1].numpy(), np.asarray(inl_j))
    assert int(eager[2]) == int(n_j)


def test_zero_trips_run_nothing(monkeypatch):
    T0, obs = _pose_case("clean")
    pobs = pose_only.PoseObs(**{k: torch.as_tensor(v) for k, v in obs.items()})
    T = torch.as_tensor(T0)
    eager, select, n_eager, n_select = both_modes(monkeypatch, lambda: pose_only._solve_round_gn(
        T, pobs, pobs.valid, FX, FY, CX, CY, BF, True, 0))
    assert eager is T and select is T and n_eager == n_select == []
