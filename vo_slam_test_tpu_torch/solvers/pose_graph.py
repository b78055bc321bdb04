"""Essential-graph Sim3 pose-graph optimization (port of
``vo_slam_test_tpu/solvers/pose_graph.py``).

Optimizer::solvePoseGraphLoop (optimizer_ceres.cpp:1036-1305): a Sim3 vertex
per keyframe; edges from the new loop connections, spanning-tree parents,
historical loop edges and strong covisibles (weight >= 100); the 7-dim
residual log_sim3(S_ij * S_j * S_i^-1) (optimizer_ceres.h:269-311); the
loop-match keyframe held fixed (:1239-1241).

The graph is dense over the keyframe capacity: the edge list is the upper
triangle's set entries, compacted; residuals and Jacobians (forward-mode AD
over each edge's two 7-dof tangents) are batched over it, and the normal
equations are one dense (K*7)^2 system. The JAX package solves it with
``jnp.linalg.solve`` (an LU); here the damped matrix, symmetric positive
definite, takes a Cholesky factor and two triangular solves
(``utils/linalg.py::spd_solve``, no status read back): cuSOLVER's LU of one
matrix of the default caps' 1792 rows does not instantiate inside a nested
conditional node, where the background program runs the loop correction.
The steps agree with an LU's to rounding. RGB-D freezes the scale (the 7th
tangent). The JAX package adds the blocks with a scatter; here a diagonal
block is a one-hot matmul over the edges and an off-diagonal block is set
once (each keyframe pair is one edge), so the sums do not depend on
scheduling. The LM loop is ``utils.graphs.while_capped`` with the JAX
package's exit (a step's largest entry under 1e-9, ``lax.while_loop``): eager
it reads the exit test once per iteration, in a step program it is one WHILE
node.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import lie
from ..slam_map.map_state import compact_ids, scatter_set
from ..utils import graphs
from ..utils.linalg import spd_solve
from .sim3 import jac_at_zero


def _edge_residual(si, Ri, ti, sj, Rj, tj, s_m, R_m, t_m):
    """log_sim3(S_meas_ij * S_j * S_i^-1) -> [..., 7]."""
    rel = lie.sim3_compose(sj, Rj, tj, *lie.sim3_inverse(si, Ri, ti))
    err = lie.sim3_compose(s_m, R_m, t_m, *rel)
    return lie.sim3_log(*err)


def _vertex_apply(s, R, t, xi):
    return lie.sim3_compose(*lie.sim3_exp(xi), s, R, t)


def solve_pose_graph(
    kf_s: torch.Tensor,       # [K] initial scales (1 for RGB-D)
    kf_R: torch.Tensor,       # [K,3,3] T_c_w rotations
    kf_t: torch.Tensor,       # [K,3]
    kf_valid: torch.Tensor,   # [K]
    edge_mask: torch.Tensor,  # [K,K] bool, undirected (upper triangle used)
    meas_s: torch.Tensor,     # [K,K] measured relative scale S_ij = S_i S_j^-1
    meas_R: torch.Tensor,     # [K,K,3,3]
    meas_t: torch.Tensor,     # [K,K,3]
    fixed_kf,                 # int or 0-d device tensor: the keyframe held fixed
    iters: int = 20,
    max_edges: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (s, R, t) optimized per keyframe."""
    K = kf_s.shape[0]
    dev = kf_s.device
    n_p = 7
    ids = torch.arange(K, device=dev)
    tri = torch.triu(torch.ones((K, K), dtype=torch.bool, device=dev), diagonal=1)
    emask = edge_mask & tri & kf_valid[:, None] & kf_valid[None, :]
    # the first max_edges set entries in row-major order; a list longer than
    # the triangle would only hold more empty slots
    lin = compact_ids(emask.reshape(-1), max(1, min(max_edges, K * (K - 1) // 2)))
    e_ok = lin >= 0
    e_i = torch.where(e_ok, lin // K, 0).long()
    e_j = torch.where(e_ok, lin % K, 0).long()
    E = lin.shape[0]
    m_s, m_R, m_t = meas_s[e_i, e_j], meas_R[e_i, e_j], meas_t[e_i, e_j]
    w = e_ok.to(torch.float32)
    O_i = torch.nn.functional.one_hot(e_i, K).to(torch.float32) * w[:, None]  # [E,K]
    O_j = torch.nn.functional.one_hot(e_j, K).to(torch.float32) * w[:, None]
    # the off-diagonal blocks (i, j) and (j, i) of the live edges: one each
    dump = K * K
    off_ij = torch.where(e_ok, e_i * K + e_j, dump)
    off_ji = torch.where(e_ok, e_j * K + e_i, dump)
    diag = ids * K + ids
    sel = (torch.arange(n_p, device=dev) < 6).to(torch.float32)  # the scale tangent frozen
    free = kf_valid & (ids != fixed_kf)
    boost = torch.where(free, 0.0, 1e8).repeat_interleave(n_p)
    eye_kp = torch.eye(K * n_p, device=dev)

    def residual(xi_i, xi_j, s, R, t):
        si, Ri, ti = _vertex_apply(s[e_i], R[e_i], t[e_i], xi_i)
        sj, Rj, tj = _vertex_apply(s[e_j], R[e_j], t[e_j], xi_j)
        return _edge_residual(si, Ri, ti, sj, Rj, tj, m_s, m_R, m_t)

    def cost(s, R, t):
        zero = torch.zeros((E, n_p), device=dev)
        rr = residual(zero, zero, s, R, t)
        return torch.sum(torch.where(e_ok[:, None], rr * rr, 0.0))

    def body(state):
        s, R, t, c_cur, lam, _ = state  # c_cur: the cost of the state kept
        r, J = jac_at_zero(lambda x: residual(x[..., :n_p], x[..., n_p:], s, R, t),
                           (E, 2 * n_p), dev)
        Ji, Jj = J[..., :n_p] * sel, J[..., n_p:] * sel
        Hii = torch.einsum("eri,erj,e->eij", Ji, Ji, w)
        Hjj = torch.einsum("eri,erj,e->eij", Jj, Jj, w)
        Hij = torch.einsum("eri,erj,e->eij", Ji, Jj, w)
        gi = torch.einsum("eri,er,e->ei", Ji, r, w)
        gj = torch.einsum("eri,er,e->ei", Jj, r, w)
        blocks = torch.zeros((K * K + 1, n_p, n_p), device=dev)
        blocks = scatter_set(blocks, off_ij, Hij)
        blocks = scatter_set(blocks, off_ji, Hij.transpose(1, 2))
        Hd = (O_i.T @ Hii.reshape(E, -1) + O_j.T @ Hjj.reshape(E, -1)).reshape(K, n_p, n_p)
        blocks = scatter_set(blocks, diag, Hd)
        H = blocks[:dump].reshape(K, K, n_p, n_p).permute(0, 2, 1, 3).reshape(K * n_p, K * n_p)
        g = (O_i.T @ gi + O_j.T @ gj).reshape(-1)
        # gauge: the loop-match keyframe and every invalid vertex held fixed
        H = H + eye_kp * (lam + 1e-8 + boost)
        # the damped normal matrix is positive definite: a Cholesky solve
        # (module docstring); a failed factor gives a NaN step, rejected
        step = -spd_solve(H, g).reshape(K, n_p)
        step = step * sel * free[:, None]
        s_new, R_new, t_new = _vertex_apply(s, R, t, step)
        c_new = cost(s_new, R_new, t_new)
        improved = c_new < c_cur
        return (torch.where(improved, s_new, s), torch.where(improved, R_new, R),
                torch.where(improved, t_new, t), torch.where(improved, c_new, c_cur),
                torch.where(improved, torch.clamp(lam * 0.33, min=1e-9),
                            torch.clamp(lam * 5.0, max=1e6)),
                torch.abs(step).max() < 1e-9)

    lam = torch.full((), 1e-6, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    s, R, t, _, _, _ = graphs.while_capped(
        lambda st: ~st[5], body, (kf_s, kf_R, kf_t, cost(kf_s, kf_R, kf_t), lam, done), iters,
        active=iters > 0)
    R = lie.quat_to_mat(lie.mat_to_quat(R))
    return s, R, t
