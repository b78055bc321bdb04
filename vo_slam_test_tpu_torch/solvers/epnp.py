"""Batched EPnP absolute pose from 2D-3D matches (port of
``vo_slam_test_tpu/solvers/epnp.py``, the cv::solvePnPRansac role of
visualOdometry.cpp:806-826 for depth-poor frames).

EPnP (Lepetit et al.) per hypothesis, all hypotheses batched: four control
points (the centroid and the principal axes), barycentric coordinates, the
[2n,12] projection system whose four smallest eigenvectors span the
camera-frame control points, betas for the paper's approximations 1-3 each
refined by six Gauss-Newton steps (``utils.graphs.repeat``, the JAX
package's ``lax.scan``: one WHILE node in a step program), and R, t by Horn
alignment of the control points; the case with the least reprojection error
wins. ``ransac_pnp``: 128 minimal 4-point samples (``utils/prng.py``), the
8 px gate, one all-inlier refinement.

The small solves are ``torch.linalg.solve_ex``/``inv_ex``: like the JAX
package they return non-finite values for a singular system where the checked
forms would raise, and they read no error flag back to the host. The
eigenproblems (the control points' 3x3 covariance, the 12x12 ``M^T M``) go to
``ops/symeig_cuda.py`` (f64 Jacobi, NaN for a non-finite matrix) where the JAX
package calls ``jnp.linalg.eigh``, whose torch counterpart checks its status on
the host. A minimal sample's projection system has a null space of dimension
four, whose basis the solver picks by rounding: its hypotheses differ from the
JAX package's in the last bits or more, while the all-inlier refinement is
well posed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..camera import Camera
from ..ops import symeig_cuda
from ..slam_map.map_state import pick
from ..utils import graphs, prng
from .ransac import N_HYP, REPROJ_GATE, horn_align

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
GN_ITERS = 6


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b for (..., n, n), (..., n) without a host read of the status."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _control_points(Xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., n, 3] world points (weights w) -> [..., 4, 3] control points:
    centroid + principal directions scaled by the std along each."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c0 = (Xw * wn[..., None]).sum(-2)
    d = (Xw - c0[..., None, :]) * torch.sqrt(wn)[..., None]
    cov = torch.einsum("...ni,...nj->...ij", d, d)
    eval_, evec = symeig_cuda.symeig(cov)
    s = torch.sqrt(torch.clamp(eval_, min=1e-12))
    axes = evec * s[..., None, :]         # columns scaled
    return torch.cat([c0[..., None, :], axes.transpose(-1, -2) + c0[..., None, :]], dim=-2)


def _barycentric(Xw: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """alphas [..., n, 4] with X = sum_j alpha_j C_j, sum alpha = 1."""
    B = torch.stack([C[..., 1, :] - C[..., 0, :], C[..., 2, :] - C[..., 0, :],
                     C[..., 3, :] - C[..., 0, :]], dim=-1)  # [...,3,3]
    Binv = torch.linalg.inv_ex(B + 1e-12 * _eye(3, B))[0]
    rel = Xw - C[..., None, 0, :]
    a123 = torch.einsum("...ij,...nj->...ni", Binv, rel)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _dist2(C: torch.Tensor) -> torch.Tensor:
    """[..., 4, 3] -> [..., 6] squared pairwise distances."""
    return torch.stack([((C[..., i, :] - C[..., j, :]) ** 2).sum(-1) for i, j in _PAIRS], -1)


def _rho_v(V: torch.Tensor) -> torch.Tensor:
    """V [..., 4, 4, 3] (vector, control point, xyz) -> pairwise difference
    vectors [..., 4, 6, 3]."""
    return torch.stack([V[..., :, i, :] - V[..., :, j, :] for i, j in _PAIRS], dim=-2)


def _signed_root(sq: torch.Tensor, prod: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """sqrt(max(sq, 0)) * sign(prod) * sign(first or 1 where first == 0)."""
    return (torch.sqrt(torch.clamp(sq, min=0.0)) * torch.sign(prod)
            * torch.sign(torch.where(first == 0, 1.0, first)))


def _betas_cases(V: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Initial betas of the paper's approximations 1-3; V [..., 4, 4, 3] null
    vectors (index 0: smallest eigenvalue), rho [..., 6] squared control
    distances -> [..., 3, 4]."""
    dv = _rho_v(V)

    def dot(a, b):
        return (dv[..., a, :, :] * dv[..., b, :, :]).sum(-1)  # [...,6]

    z = torch.zeros_like(rho[..., 0])
    # case 1: x = b0 v0
    b1 = (dot(0, 0) * rho).sum(-1) / torch.clamp((dot(0, 0) ** 2).sum(-1), min=1e-12)
    beta1 = torch.stack([torch.sqrt(torch.clamp(b1, min=0.0)), z, z, z], -1)

    # case 2: x = b0 v0 + b1 v1; unknowns (b0^2, b0 b1, b1^2)
    L2 = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1)], -1)  # [...,6,3]
    sol2 = _solve(torch.einsum("...ni,...nj->...ij", L2, L2) + 1e-9 * _eye(3, L2),
                  torch.einsum("...ni,...n->...i", L2, rho))
    b0_2 = torch.sqrt(torch.clamp(sol2[..., 0], min=0.0))
    b1_2 = _signed_root(sol2[..., 2], sol2[..., 1], sol2[..., 0])
    beta2 = torch.stack([b0_2, b1_2, z, z], -1)

    # case 3: x = b0 v0 + b1 v1 + b2 v2; unknowns (b00, b01, b11, b02, b12)
    L3 = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2)], -1)
    sol3 = _solve(torch.einsum("...ni,...nj->...ij", L3, L3) + 1e-9 * _eye(5, L3),
                  torch.einsum("...ni,...n->...i", L3, rho))
    b0_3 = torch.sqrt(torch.clamp(sol3[..., 0], min=0.0))
    b1_3 = _signed_root(sol3[..., 2], sol3[..., 1], sol3[..., 0])
    b2_3 = torch.where(b0_3 > 1e-12, sol3[..., 3] / (2.0 * torch.clamp(b0_3, min=1e-12)), 0.0)
    beta3 = torch.stack([b0_3, b1_3, b2_3, z], -1)
    return torch.stack([beta1, beta2, beta3], dim=-2)


def _gauss_newton_betas(V: torch.Tensor, rho: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Refine betas on the 6 distance residuals (the paper's gauss_newton)."""
    dv = _rho_v(V)  # [..., 4, 6, 3]

    def step(betas):
        cc = torch.einsum("...k,...kpx->...px", betas, dv)    # [...,6,3]
        res = (cc * cc).sum(-1) - rho                          # [...,6]
        J = 2.0 * torch.einsum("...px,...kpx->...pk", cc, dv)  # [...,6,4]
        JtJ = torch.einsum("...pi,...pj->...ij", J, J) + 1e-9 * _eye(4, J)
        return betas - _solve(JtJ, torch.einsum("...pi,...p->...i", J, res))

    return graphs.repeat(GN_ITERS, step, betas)


def epnp_pose(Xw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, cam: Camera) -> torch.Tensor:
    """EPnP pose [..., 4, 4] (T_c_w) from weighted 2D-3D matches:
    Xw [..., n, 3], uv [..., n, 2] undistorted pixels, w [..., n]."""
    n = Xw.shape[-2]
    batch = Xw.shape[:-2]
    C = _control_points(Xw, w)
    alpha = _barycentric(Xw, C)          # [..., n, 4]

    fu, fv, uc, vc = cam.fx, cam.fy, cam.cx, cam.cy
    aw = alpha * w[..., None]
    zero = torch.zeros_like(aw)
    # rows [a_j fu, 0, a_j (uc-u)] and [0, a_j fv, a_j (vc-v)] per control point j
    row_u = torch.stack([aw * fu, zero, aw * (uc - uv[..., 0:1])], -1)  # [..., n, 4, 3]
    row_v = torch.stack([zero, aw * fv, aw * (vc - uv[..., 1:2])], -1)
    M = torch.cat([row_u.reshape(*batch, n, 12), row_v.reshape(*batch, n, 12)], dim=-2)
    MtM = torch.einsum("...ni,...nj->...ij", M, M)
    _, evec = symeig_cuda.symeig(MtM)
    V = evec[..., :, :4].transpose(-1, -2).reshape(*batch, 4, 4, 3)

    rho = _dist2(C)
    betas0 = _betas_cases(V, rho)          # [..., 3, 4]
    V3 = V[..., None, :, :, :].expand(betas0.shape[:-1] + V.shape[-3:])
    betas = _gauss_newton_betas(V3, rho[..., None, :].expand(betas0.shape[:-1] + (6,)), betas0)

    # camera-frame control points per case; fix the sign so depths are +
    Cc = torch.einsum("...ck,...ckpx->...cpx", betas, V3)    # [...,3,4,3]
    pc = torch.einsum("...nj,...cjx->...cnx", alpha, Cc)     # [...,3,n,3]
    neg = torch.where(w[..., None, :] > 0, torch.sign(pc[..., 2]), 0.0).sum(-1) < 0
    Cc = torch.where(neg[..., None, None], -Cc, Cc)

    # per case: Horn(world control points -> camera ones), scored by reprojection
    Cw = C[..., None, :, :].expand(Cc.shape)
    T = horn_align(Cw, Cc, torch.ones(Cc.shape[:-1], dtype=Cc.dtype, device=Cc.device))
    pcs = torch.einsum("...cij,...nj->...cni", T[..., :3, :3], Xw) + T[..., None, :3, 3]
    z = torch.where(torch.abs(pcs[..., 2]) < 1e-9, 1e-9, pcs[..., 2])
    u = fu * pcs[..., 0] / z + uc
    v = fv * pcs[..., 1] / z + vc
    err = (u - uv[..., None, :, 0]) ** 2 + (v - uv[..., None, :, 1]) ** 2
    score = torch.where(w[..., None, :] > 0, err, 0.0).sum(-1)
    best = torch.argmin(score, -1)
    return torch.gather(T, -3, best[..., None, None, None].expand(*batch, 1, 4, 4))[..., 0, :, :]


def ransac_pnp(key: prng.Key, Xw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               inv_sigma2: torch.Tensor, cam: Camera
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T_c_w [4,4], inlier mask [N], n_inliers): 128 parallel 4-point EPnP
    hypotheses drawn with ``key`` (``utils.prng.prng_key``, whose words may
    be device tensors), the 8 px gate
    weighted by ``inv_sigma2``, one all-inlier EPnP refinement."""
    N = Xw.shape[0]
    logits = torch.where(valid, 0.0, -torch.inf)
    g = prng.gumbel(key, (N_HYP, N), Xw.device) + logits[None, :]
    sample = prng.top_k(g, 4)[1]                                      # [H,4]
    T = epnp_pose(Xw[sample], uv[sample], torch.ones((N_HYP, 4), device=Xw.device), cam)

    def inliers(T_):
        pc = torch.einsum("...ij,nj->...ni", T_[..., :3, :3], Xw) + T_[..., None, :3, 3]
        z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        e2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
        return valid & (pc[..., 2] > 0) & (e2 * inv_sigma2 < REPROJ_GATE ** 2)

    inl = inliers(T)
    counts = inl.sum(-1, dtype=torch.int32)
    hbest = torch.argmax(counts)  # the first maximum, as jnp.argmax
    inl_h, n_h = pick(inl, hbest), pick(counts, hbest)

    # all-inlier refinement (one EPnP over the winning consensus set)
    T_ref = epnp_pose(Xw, uv, inl_h.to(Xw.dtype), cam)
    inl_ref = inliers(T_ref)
    n_ref = inl_ref.sum(dtype=torch.int32)
    better = n_ref >= n_h
    return (torch.where(better, T_ref, pick(T, hbest)), torch.where(better, inl_ref, inl_h),
            torch.maximum(n_ref, n_h))
