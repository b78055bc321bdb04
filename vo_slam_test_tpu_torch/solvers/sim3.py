"""Sim3 solving for loop closure: batched Horn RANSAC and LM refinement (port
of ``vo_slam_test_tpu/solvers/sim3.py``).

- ``ransac_sim3``: the reference's Sim3Solver (sim3Solver.cpp) batched: each
  of ``N_HYP`` hypotheses is a closed-form 3-point alignment between the two
  keyframes' camera-frame points, scored by the bidirectional reprojection
  gates 9.21 sigma^2 (sim3Solver.cpp:53-54, 242-268). The samples come from
  ``utils/prng.py``, so the port draws the JAX package's for the same seed.
- ``refine_sim3``: Optimizer::solveLoopSim3 (optimizer_ceres.cpp:810-1030):
  Levenberg-Marquardt over the relative transform with bidirectional
  reprojection residuals, Huber(sqrt(10)) first, then a plain pass over the
  chi2 = 10 inliers. Jacobians by forward-mode AD at a zero twist.

RGB-D fixes the scale to 1 (sim3Solver.cpp:227-234); the JAX package's
``fix_scale=False`` branch (monocular) has no caller and is not ported. The
JAX package stops each LM pass when a step's largest entry falls under 1e-8
(its ``lax.while_loop``); here each pass is ``utils.graphs.while_capped``
with the same exit: eager it reads the exit test once per iteration, in a
step program it is one WHILE node, and nothing is read back.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import lie
from ..slam_map.map_state import pick
from ..utils import graphs, prng
from .ransac import horn_align

N_HYP = 128
CHI2_SIM3 = 10.0


def _project(pc, fx, fy, cx, cy):
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([fx * pc[..., 0] / safe_z + cx, fy * pc[..., 1] / safe_z + cy], dim=-1)


def jac_at_zero(fn: Callable[[torch.Tensor], torch.Tensor], shape, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fn and its forward-mode Jacobian at a zero argument of ``shape``
    (..., P), where each output row depends only on its own leading entries
    of the argument. One jvp over P stacked copies of the argument, copy d
    carrying the tangent e_d (``fn`` broadcasts over that leading axis; a
    0-d angle would also meet PyTorch's forward-mode promotion of a 0-d
    tangent times a Python float to float64) -> (fn(0), Jacobian of fn's
    output shape + (P,))."""
    P = shape[-1]
    full = (P,) + tuple(shape)
    basis = torch.eye(P, device=device).reshape((P,) + (1,) * (len(shape) - 1) + (P,))
    out, tangent = torch.func.jvp(fn, (torch.zeros(full, device=device),),
                                  (basis.expand(full),))
    return out[0], tangent.movedim(0, -1)


def ransac_sim3(
    pc1: torch.Tensor,       # [N,3] matched points in keyframe-1 camera frame
    pc2: torch.Tensor,       # [N,3] the same points in keyframe-2 camera frame
    uv1: torch.Tensor,       # [N,2] pixels in image 1
    uv2: torch.Tensor,       # [N,2] pixels in image 2
    max_err1: torch.Tensor,  # [N] 9.21 * sigma1^2 gates
    max_err2: torch.Tensor,
    valid: torch.Tensor,     # [N]
    fx, fy, cx, cy,
    seed: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (s12 (1), T12 [4,4] cam2 -> cam1, inlier mask, count); apply as
    p1 = s12 * R12 p2 + t12."""
    N = pc1.shape[0]
    dev = pc1.device
    logits = torch.where(valid, 0.0, -1e9)
    # one gumbel vector per hypothesis; the top 3 are distinct samples
    g = prng.gumbel(prng.prng_key(seed), (N_HYP, N), dev) + logits[None, :]
    _, picks = prng.top_k(g, 3)
    s = torch.ones((N_HYP,), device=dev)
    T = horn_align(pc2[picks], pc1[picks], torch.ones((N_HYP, 3), device=dev))

    # bidirectional gates for every hypothesis
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    p1_pred = s[:, None, None] * torch.einsum("bij,nj->bni", R, pc2) + t[:, None, :]
    # inverse: p2 = (1/s) R^T (p1 - t)
    p2_pred = torch.einsum("bij,bnj->bni", R.transpose(1, 2), pc1[None] - t[:, None, :]) \
        / s[:, None, None]
    e1 = torch.sum((_project(p1_pred, fx, fy, cx, cy) - uv1[None]) ** 2, -1)
    e2 = torch.sum((_project(p2_pred, fx, fy, cx, cy) - uv2[None]) ** 2, -1)
    inl = (e1 < max_err1[None]) & (e2 < max_err2[None]) & valid[None]
    counts = inl.sum(1, dtype=torch.int32)
    best = torch.argmax(counts)  # the first maximum, as jnp.argmax
    return pick(s, best), lie.orthonormalize(pick(T, best)), pick(inl, best), pick(counts, best)


def refine_sim3(
    T12_init: torch.Tensor,  # [4,4]
    s12_init: torch.Tensor,
    pc1: torch.Tensor, pc2: torch.Tensor,
    uv1: torch.Tensor, uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    fx, fy, cx, cy,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-pass LM refinement -> (s12, T12, inlier mask, count)."""
    dev = pc1.device
    w1 = torch.sqrt(inv_sigma2_1)[:, None]
    w2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(xi, T, s):
        """xi [..., 6] -> [..., N, 4]."""
        T = lie.se3_exp(xi) @ T
        R = T[..., :3, :3]
        t = T[..., None, :3, 3]
        p1 = s * pc2 @ R.transpose(-1, -2) + t
        e1 = (_project(p1, fx, fy, cx, cy) - uv1) * w1
        p2 = ((pc1 - t) @ R) / s
        e2 = (_project(p2, fx, fy, cx, cy) - uv2) * w2
        return torch.cat([e1, e2], dim=-1)

    delta = CHI2_SIM3 ** 0.5
    zero6 = torch.zeros((6,), device=dev)

    def cost(T, s, active, use_huber):
        e = residuals(zero6, T, s)
        r2 = torch.sum(e * e, -1)
        if use_huber:
            sr = torch.sqrt(r2 + 1e-12)
            r2 = torch.where(sr <= delta, r2, 2 * delta * sr - delta * delta)
        return torch.sum(torch.where(active, r2, 0.0))

    def lm_pass(T, s, active, use_huber):
        eye = torch.eye(6, device=dev)

        def body(state):
            T, c_T, lam, _ = state  # c_T: the cost of the T kept
            e, J = jac_at_zero(lambda x: residuals(x, T, s), (6,), dev)  # [N,4], [N,4,6]
            r2 = torch.sum(e * e, -1)
            wr = torch.clamp(delta / torch.sqrt(r2 + 1e-12), max=1.0) if use_huber \
                else torch.ones_like(r2)
            w = active.to(e.dtype) * wr
            H = torch.einsum("nri,nrj,n->ij", J, J, w)
            g = torch.einsum("nri,nr,n->i", J, e, w)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
            step = -torch.linalg.solve_ex(Hd, g)[0]
            T_new = lie.se3_exp(step) @ T
            c_new = cost(T_new, s, active, use_huber)
            improved = c_new < c_T
            return (torch.where(improved, T_new, T), torch.where(improved, c_new, c_T),
                    torch.where(improved, torch.clamp(lam * 0.33, min=1e-8),
                                torch.clamp(lam * 4.0, max=1e6)),
                    torch.abs(step).max() < 1e-8)

        lam = torch.full((), 1e-4, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        T, _, _, _ = graphs.while_capped(lambda st: ~st[3], body,
                                         (T, cost(T, s, active, use_huber), lam, done), iters,
                                         active=iters > 0)
        return T

    def classify(T, s):
        e = residuals(zero6, T, s)
        chi1 = torch.sum(e[:, :2] ** 2, -1)
        chi2c = torch.sum(e[:, 2:] ** 2, -1)
        return valid & (chi1 < CHI2_SIM3) & (chi2c < CHI2_SIM3)

    T1 = lm_pass(T12_init, s12_init, valid, True)
    inl = classify(T1, s12_init)
    T2 = lm_pass(T1, s12_init, inl, False)
    inl2 = classify(T2, s12_init)
    return s12_init, lie.orthonormalize(T2), inl2, inl2.sum(dtype=torch.int32)
