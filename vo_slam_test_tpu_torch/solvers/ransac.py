"""Batched RANSAC absolute pose for relocalization, 3D-3D (port of
``vo_slam_test_tpu/solvers/ransac.py``).

The reference calls cv::solvePnPRansac (EPnP, 100 iterations, 8 px gate;
visualOdometry.cpp:806-826). With RGB-D depth the JAX package solves the
3D-3D problem instead: each of 128 hypotheses is a closed-form Horn alignment
of a 3-point sample, all scored at once by the reference's 8 px reprojection
gate. The samples come from ``utils/prng.py``, so the port draws the JAX
package's samples for the same seed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import lie
from ..slam_map.map_state import pick
from ..utils import prng

N_HYP = 128          # reference uses 100 sequential iterations
REPROJ_GATE = 8.0    # px (visualOdometry.cpp:806)


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LAPACK call, no host sync)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def finite_or_zero(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, n) -> (A with its non-finite matrices zeroed, [...] bool
    mask of those). ``torch.linalg.svd``/``eigh`` raise on a non-finite
    input where the JAX package's return NaN; the callers put NaN back."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    return torch.where(bad[..., None, None], 0.0, A), bad


def horn_align(p_src: torch.Tensor, p_dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form SE3, R from the SVD of the cross-covariance.

    p_src/p_dst: [..., n, 3]; w: [..., n]. Returns [..., 4, 4] T with
    p_dst ~= R p_src + t. The singular vectors' signs are the library's, but
    R = U diag(1, 1, det(U V^T)) V^T does not depend on them."""
    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c_src = (p_src * wn[..., None]).sum(-2)
    c_dst = (p_dst * wn[..., None]).sum(-2)
    src_c = p_src - c_src[..., None, :]
    dst_c = p_dst - c_dst[..., None, :]
    H, bad = finite_or_zero(torch.einsum("...ni,...nj,...n->...ij", dst_c, src_c, wn))
    U, _, Vt = torch.linalg.svd(H)
    det = det3(U @ Vt)
    ones = torch.ones_like(det)
    D = torch.diag_embed(torch.stack([ones, ones, det], -1))
    R = torch.where(bad[..., None, None], torch.nan, U @ D @ Vt)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return lie.rt_to_mat(R, t)


def ransac_pose_3d3d(
    p_world: torch.Tensor,    # [N,3] map points
    p_cam: torch.Tensor,      # [N,3] camera-frame points (from RGB-D depth)
    uv: torch.Tensor,         # [N,2] undistorted pixels (for the inlier gate)
    valid3d: torch.Tensor,    # [N] has depth (can be sampled)
    valid: torch.Tensor,      # [N] participates in scoring
    fx, fy, cx, cy,
    seed: int,                # deterministic per frame and candidate
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (T_c_w [4,4], inlier mask [N], n_inliers)."""
    N = p_world.shape[0]
    # one gumbel vector per hypothesis; the top 3 are distinct sample points
    logits = torch.where(valid3d, 0.0, -1e9)
    g = prng.gumbel(prng.prng_key(seed), (N_HYP, N), p_world.device) + logits[None, :]
    _, picks = prng.top_k(g, 3)                            # [B,3]

    T = horn_align(p_world[picks], p_cam[picks], torch.ones((N_HYP, 3), device=p_world.device))

    # score every hypothesis against every observation
    pc = torch.einsum("bij,nj->bni", T[:, :3, :3], p_world) + T[:, None, :3, 3]
    z = pc[..., 2]
    good_z = z > 1e-6
    invz = 1.0 / torch.where(good_z, z, 1.0)
    u = fx * pc[..., 0] * invz + cx
    v = fy * pc[..., 1] * invz + cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = good_z & (err2 < REPROJ_GATE ** 2) & valid[None, :]
    counts = inl.sum(1, dtype=torch.int32)                 # [B]

    best = torch.argmax(counts)  # the first maximum, as jnp.argmax
    T_best, inl_best, n_best = pick(T, best), pick(inl, best), pick(counts, best)
    # refine with a weighted Horn over all 3D inliers
    w_ref = (inl_best & valid3d).to(torch.float32)
    T_ref = horn_align(p_world[None], p_cam[None], w_ref[None])[0]
    # keep the refinement only if it loses no inliers
    pc2 = p_world @ T_ref[:3, :3].T + T_ref[:3, 3]
    z2 = pc2[:, 2]
    gz = z2 > 1e-6
    invz2 = 1.0 / torch.where(gz, z2, 1.0)
    err2b = (fx * pc2[:, 0] * invz2 + cx - uv[:, 0]) ** 2 + (fy * pc2[:, 1] * invz2 + cy - uv[:, 1]) ** 2
    inl2 = gz & (err2b < REPROJ_GATE ** 2) & valid
    n2 = inl2.sum(dtype=torch.int32)
    use_ref = n2 >= n_best
    T_out = torch.where(use_ref, T_ref, T_best)
    inl_out = torch.where(use_ref, inl2, inl_best)
    return lie.orthonormalize(T_out), inl_out, torch.maximum(n2, n_best)
