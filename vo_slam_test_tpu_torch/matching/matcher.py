"""Projection searches (port of ``vo_slam_test_tpu/matching/matcher.py``).

``search_by_projection_frame`` (frame to last frame): the gates (spatial
window, octave band, virtual stereo, valid flags) and the Hamming top-2 run
fused in the CUDA kernel ``csrc/match.cu`` on the card. ``search_by_projection_kf``
(a keyframe's points into a frame, the relocalization top-up) takes a dense
masked Hamming argmin, as the JAX package computes it in XLA outside any
Pallas kernel. Thresholds are the reference's (TH_HIGH=100).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import hamming, match_cuda
from . import rotation

TH_HIGH = 100
BIG = 1 << 20


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N_src] i32: matched target index, -1 if none
    dist: torch.Tensor   # [N_src] i32: Hamming distance of the best target
    count: torch.Tensor  # i32 scalar: number of matches


def projection_top2_args(
    p_world, src_desc, src_octave, src_valid,
    tgt_uv_und, tgt_u_right, tgt_octave, tgt_desc, tgt_valid, tgt_blocked,
    T_c_w, T_l_w, scale_factors, fx, fy, cx, cy, bf, b, width: float, height: float,
    radius: float,
) -> Tuple[torch.Tensor, ...]:
    """Project the last frame's points and build the 15 arguments of
    ``masked_top2`` (matcher.cpp:18-148 gates)."""
    R = T_c_w[:3, :3]
    t = T_c_w[:3, 3]
    pc = p_world @ R.T + t
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    invz = 1.0 / safe_z
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    in_img = (z > 0) & (u >= 0) & (u <= width) & (v >= 0) & (v <= height)
    src_ok = src_valid & in_img

    # forward/backward from the last-to-current translation z
    T_l_c = T_l_w @ torch.linalg.inv_ex(T_c_w)[0]
    tz = T_l_c[2, 3]
    forward = tz > b
    backward = -tz > b

    r_scale = radius * scale_factors[src_octave.long()]
    lo = torch.where(forward, src_octave, torch.where(backward, 0, src_octave - 1))
    hi = torch.where(forward, 10_000, torch.where(backward, src_octave, src_octave + 1))
    ur_pred = u - bf * invz
    return (
        src_desc, tgt_desc, u, v, r_scale, ur_pred, r_scale,
        lo.to(torch.int32), hi.to(torch.int32), src_ok,
        tgt_uv_und[:, 0].contiguous(), tgt_uv_und[:, 1].contiguous(), tgt_u_right,
        tgt_octave, tgt_valid & ~tgt_blocked,
    )


def search_by_projection_frame(
    p_world, src_desc, src_octave, src_angle, src_valid,
    tgt_uv_und, tgt_u_right, tgt_octave, tgt_angle, tgt_desc, tgt_valid, tgt_blocked,
    T_c_w, T_l_w, scale_factors, fx, fy, cx, cy, bf, b, width: float, height: float,
    radius: float, check_rot: bool = True,
) -> MatchResult:
    """Frame-to-last-frame projection search: best Hamming <= TH_HIGH inside
    the gates, then the optional rotation-consistency filter."""
    args = projection_top2_args(
        p_world, src_desc, src_octave, src_valid,
        tgt_uv_und, tgt_u_right, tgt_octave, tgt_desc, tgt_valid, tgt_blocked,
        T_c_w, T_l_w, scale_factors, fx, fy, cx, cy, bf, b, width, height, radius,
    )
    best, best_d, _, _ = match_cuda.masked_top2(*args)
    matched = best_d <= TH_HIGH
    if check_rot:
        bins = rotation.rotation_bins(src_angle, tgt_angle[best.long()])
        matched = rotation.rotation_consistency_mask(bins, matched)
    idx = torch.where(matched, best, -1)
    return MatchResult(idx=idx, dist=best_d, count=matched.sum(dtype=torch.int32))


def search_by_projection_kf(
    p_world, src_desc, src_angle, src_min_dist, src_max_dist, src_pt, src_valid,
    tgt_uv_und, tgt_angle, tgt_octave, tgt_desc, tgt_valid, tgt_blocked,
    T_c_w, scale_factors, fx, fy, cx, cy, width: float, height: float,
    radius: float, dist_threshold: float, check_rot: bool = True,
) -> MatchResult:
    """Relocalization top-up search (matcher.cpp:150-272): project a
    keyframe's map points into the frame, gate by the 0.8/1.2 distance band
    and the predicted-scale window [pred-1, pred+1], keep the best Hamming
    <= ``dist_threshold`` (100 for the first top-up, 60 for the second)."""
    R = T_c_w[:3, :3]
    t = T_c_w[:3, 3]
    pc = p_world @ R.T + t
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[:, 0] / safe_z + cx
    v = fy * pc[:, 1] / safe_z + cy
    ow = -R.T @ t
    dist = torch.linalg.vector_norm(p_world - ow, dim=-1)
    src_ok = (src_valid & (z > 0) & (u >= 0) & (u <= width) & (v >= 0) & (v <= height)
              # 0.8/1.2 invariance slack (mappoint.cpp:391-401)
              & (dist >= 0.8 * src_min_dist) & (dist <= 1.2 * src_max_dist))
    # predictScale (mappoint.cpp:182-199)
    ratio = src_max_dist / torch.clamp(dist, min=1e-9)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(scale_factors[1]))
    pred = pred.to(torch.int32).clamp(0, scale_factors.shape[0] - 1)
    r_scale = radius * scale_factors[pred.long()]

    du = torch.abs(tgt_uv_und[None, :, 0] - u[:, None])
    dv = torch.abs(tgt_uv_und[None, :, 1] - v[:, None])
    window = (du < r_scale[:, None]) & (dv < r_scale[:, None])
    oct_ok = (tgt_octave[None, :] >= (pred - 1)[:, None]) & (tgt_octave[None, :] <= (pred + 1)[:, None])
    allowed = window & oct_ok & src_ok[:, None] & (tgt_valid & ~tgt_blocked)[None, :]

    D = torch.where(allowed, hamming.distance_matrix(src_desc, tgt_desc), BIG)
    best = torch.argmin(D, dim=1)  # the first minimum, as jnp.argmin
    best_d = torch.gather(D, 1, best[:, None])[:, 0]
    matched = best_d <= dist_threshold
    if check_rot:
        bins = rotation.rotation_bins(src_angle, tgt_angle[best])
        matched = rotation.rotation_consistency_mask(bins, matched)
    idx = torch.where(matched, best.to(torch.int32), -1)
    return MatchResult(idx=idx, dist=best_d, count=matched.sum(dtype=torch.int32))
