"""Pose-only SE3 optimization, motion-only bundle adjustment (port of
``vo_slam_test_tpu/solvers/pose_only.py``).

Batched residuals over the padded match set (mono 2-dof, virtual-stereo
3-dof rows), analytic Jacobians, per-octave weighting, and the reference's
two-round structure (Huber round, chi2 reclassification, plain round from the
input pose again). ``fast=True`` runs fixed 4-iteration damped Gauss-Newton
rounds (``utils.graphs.repeat``, the JAX package's ``lax.fori_loop``: one
WHILE node in a step program) with no host read-back: round 2 is always
computed and selected with ``torch.where`` when round 1 kept >= 10 inliers,
which gives the same result as the JAX package's ``lax.cond``. The LM path (``fast=False``) is
``utils.graphs.while_capped``, the JAX package's ``lax.while_loop``: it exits
early on convergence, reading one scalar back per iteration when eager and
none in ``select`` mode or a captured graph.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import math

import torch

from .. import lie
from ..utils import graphs

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
_DELTA_MONO = math.sqrt(CHI2_MONO)
_DELTA_STEREO = math.sqrt(CHI2_STEREO)


class PoseObs(NamedTuple):
    """Padded observation set for one frame."""

    p_world: torch.Tensor     # [N, 3] f32 map point positions
    uv: torch.Tensor          # [N, 2] f32 undistorted pixel observations
    u_right: torch.Tensor     # [N] f32 virtual-stereo u; < 0 => mono
    inv_sigma2: torch.Tensor  # [N] f32 1/scale^2 per observation octave
    valid: torch.Tensor       # [N] bool


def _residuals_jac(T, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals [N,3] (third row zeroed for mono) and Jacobians [N,3,6]
    w.r.t. the left-multiplied twist (rho, phi)."""
    pc = lie.transform_points(T, obs.p_world)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    invz = 1.0 / safe_z
    invz2 = invz * invz
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz

    stereo = obs.u_right >= 0
    e = torch.stack(
        [u - obs.uv[:, 0], v - obs.uv[:, 1], torch.where(stereo, ur - obs.u_right, 0.0)], dim=-1
    )
    zero = torch.zeros_like(x)
    du = torch.stack([fx * invz, zero, -fx * x * invz2], -1)
    dv = torch.stack([zero, fy * invz, -fy * y * invz2], -1)
    dur = du + torch.stack([zero, zero, bf * invz2], -1)
    dproj = torch.stack([du, dv, torch.where(stereo[:, None], dur, 0.0)], -2)  # [N,3,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -lie.hat(pc)], dim=-1)  # [N,3,6]
    return e, dproj @ dpc, stereo


def _huber_delta(stereo: torch.Tensor) -> torch.Tensor:
    return torch.where(stereo, _DELTA_STEREO, _DELTA_MONO)


def _rho(s2: torch.Tensor, stereo: torch.Tensor, use_huber: bool) -> torch.Tensor:
    if not use_huber:
        return s2
    delta = _huber_delta(stereo)
    s = torch.sqrt(s2 + 1e-12)
    return torch.where(s <= delta, s2, 2.0 * delta * s - delta * delta)


def _normal_equations(T, obs, active, fx, fy, cx, cy, bf, use_huber):
    inv_sigma = torch.sqrt(obs.inv_sigma2)
    e, J, stereo = _residuals_jac(T, obs, fx, fy, cx, cy, bf)
    ew = e * inv_sigma[:, None]
    if use_huber:
        nrm = torch.sqrt(torch.sum(ew * ew, dim=-1) + 1e-12)
        w = torch.minimum(torch.ones_like(nrm), _huber_delta(stereo) / nrm)
    else:
        w = torch.ones(e.shape[0], dtype=e.dtype, device=e.device)
    Jw = J * inv_sigma[:, None, None]
    m = active.to(e.dtype) * w
    H = torch.einsum("nri,nrj,n->ij", Jw, Jw, m)
    g = torch.einsum("nri,nr,n->i", Jw, ew, m)
    return H, g, ew, stereo


def _solve_round(T0, obs: PoseObs, active, fx, fy, cx, cy, bf, use_huber: bool,
                 max_iters: int = 10) -> torch.Tensor:
    """One LM round from T0 over the active subset."""
    inv_sigma = torch.sqrt(obs.inv_sigma2)
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)

    def cost_of(T):
        e, _, stereo = _residuals_jac(T, obs, fx, fy, cx, cy, bf)
        ew = e * inv_sigma[:, None]
        return torch.sum(torch.where(active, _rho(torch.sum(ew * ew, dim=-1), stereo, use_huber), 0.0))

    def body(carry):
        T, lam, _ = carry
        H, g, ew, stereo = _normal_equations(T, obs, active, fx, fy, cx, cy, bf, use_huber)
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
        step = -torch.linalg.solve_ex(Hd, g)[0]
        T_new = lie.se3_exp(step) @ T
        c_old = torch.sum(torch.where(active, _rho(torch.sum(ew * ew, dim=-1), stereo, use_huber), 0.0))
        improved = cost_of(T_new) < c_old
        T = torch.where(improved, T_new, T)
        lam = torch.where(improved, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 4.0, max=1e6))
        return T, lam, torch.max(torch.abs(step)) < 1e-8

    lam = torch.full((), 1e-4, dtype=T0.dtype, device=T0.device)
    converged = torch.zeros((), dtype=torch.bool, device=T0.device)
    # the JAX package's lax.while_loop with its trip cap: a host read per
    # iteration when eager, a conditional node per iteration in a capture
    T, _, _ = graphs.while_capped(lambda c: ~c[2], body, (T0, lam, converged), max_iters,
                                  active=max_iters > 0, name="pose_lm")
    return T


def _solve_round_gn(T0, obs: PoseObs, active, fx, fy, cx, cy, bf, use_huber: bool,
                    iters: int) -> torch.Tensor:
    """Fixed-iteration damped Gauss-Newton round (the tracking fast path)."""
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)

    def body(T):
        H, g, _, _ = _normal_equations(T, obs, active, fx, fy, cx, cy, bf, use_huber)
        Hd = H + 1e-4 * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
        step = -torch.linalg.solve_ex(Hd, g)[0]
        # guard: a wild step (degenerate geometry) keeps the old pose
        ok = torch.all(torch.isfinite(step)) & (torch.max(torch.abs(step)) < 1.0)
        return torch.where(ok, lie.se3_exp(step) @ T, T)

    return graphs.repeat(iters, body, T0, name="pose_round")


def _classify(T, obs: PoseObs, fx, fy, cx, cy, bf) -> Tuple[torch.Tensor, torch.Tensor]:
    """chi2 inlier classification (optimizer_ceres.cpp:259-304)."""
    e, _, stereo = _residuals_jac(T, obs, fx, fy, cx, cy, bf)
    e2 = torch.sum(e[:, :2] ** 2, dim=-1)
    chi2 = torch.where(stereo, e2 + e[:, 2] ** 2, e2) * obs.inv_sigma2
    inlier = (chi2 < torch.where(stereo, CHI2_STEREO, CHI2_MONO)) & obs.valid
    return inlier, inlier.sum(dtype=torch.int32)


def solve_pose_only(T_init: torch.Tensor, obs: PoseObs, fx, fy, cx, cy, bf,
                    max_iters: int = 10, fast: bool = False):
    """Two-round robust pose-only solve -> (T, inlier_mask [N], inlier_count).

    The final pose is always written; the caller gates on the count."""
    if fast:
        def rnd(T0, act, huber):
            return _solve_round_gn(T0, obs, act, fx, fy, cx, cy, bf, huber, 4)
    else:
        def rnd(T0, act, huber):
            return _solve_round(T0, obs, act, fx, fy, cx, cy, bf, huber, max_iters)

    T1 = rnd(T_init, obs.valid, True)
    inlier1, n1 = _classify(T1, obs, fx, fy, cx, cy, bf)
    T2 = rnd(T_init, inlier1, False)
    inlier2, n2 = _classify(T2, obs, fx, fy, cx, cy, bf)
    second = n1 >= 10
    T_out = torch.where(second, T2, T1)
    inlier_out = torch.where(second, inlier2, inlier1)
    n_out = torch.where(second, n2, n1)
    # keep the pose on the SE3 manifold (f32 drift compounds through the
    # motion-model inverse otherwise)
    return lie.orthonormalize(T_out), inlier_out, n_out
