"""trackLocalMap as fixed-shape tensor programs (port of
``vo_slam_test_tpu/slam_map/local_map.py``).

Local keyframe/point selection (visualOdometry.cpp:595-724), Frame::isInFrame
with scale prediction (frame.cpp:145-190, mappoint.cpp:182-199) and the
local-map projection search with the second-best ratio gate
(matcher.cpp:274-353). The search runs the masked Hamming top-2 kernel
(``csrc/match.cu``) at [MAX_LOCAL_PTS=4096, N=1024] on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..camera import Camera
from ..ops import match_cuda, match_pallas
from .insert import norm3
from .map_state import MapState, compact_ids, first_true, scatter_or

MAX_LOCAL_PTS = 4096
TH_HIGH = 100


def local_keyframe_mask(m: MapState, assign: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """assign: [N] i32 map point per current keypoint (-1). Returns
    (local_kf_mask [K] bool, ref_kf i32): the KFs observing a matched point,
    each one's best covisible neighbour, spanning parent and first child."""
    K = m.kf_valid.shape[0]
    has = assign >= 0
    obs = m.pt_obs_kf[assign.clamp(min=0).long()]          # [N,O]
    ok = has[:, None] & (obs >= 0)
    counts = torch.zeros(K + 1, dtype=torch.int32, device=assign.device)
    counts.index_add_(0, torch.where(ok, obs, K).reshape(-1).long(), ok.reshape(-1).to(torch.int32))
    counts = counts[:K] * m.kf_valid.to(torch.int32)
    seeds = counts > 0
    ref_kf = torch.argmax(counts).to(torch.int32)

    valid = m.kf_valid
    covis = torch.where(valid[None, :], m.covis, 0)
    best_nb = torch.argmax(covis, dim=1)
    nb_ok = torch.gather(covis, 1, best_nb[:, None])[:, 0] > 0
    nb_mask = scatter_or(K, torch.where(seeds & nb_ok, best_nb, K - 1), seeds & nb_ok)
    par = m.parent
    par_ok = seeds & (par >= 0)
    par_mask = scatter_or(K, torch.where(par_ok, par, K - 1), par_ok)
    kf_ids = torch.arange(K, dtype=torch.int32, device=assign.device)
    child_of = torch.where((par >= 0) & valid, par, -1)
    is_child = (child_of[None, :] == kf_ids[:, None]) & seeds[:, None]  # [K seeds, K kids]
    first_child = first_true(is_child, 1)
    has_child = torch.any(is_child, dim=1)
    ch_mask = scatter_or(K, torch.where(has_child, first_child, K - 1), has_child)

    local = (seeds | nb_mask | par_mask | ch_mask) & valid
    return local, ref_kf


def local_point_mask(m: MapState, local_kf: torch.Tensor) -> torch.Tensor:
    """[P] bool: points observed by any of the first 96 local keyframes."""
    P = m.pt_valid.shape[0]
    K = m.kf_valid.shape[0]
    ids = compact_ids(local_kf, min(96, K))
    rows = m.kf_mp[ids.clamp(min=0).long()]         # [C,N]
    on = (ids >= 0)[:, None] & (rows >= 0)
    return scatter_or(P, torch.where(on, rows, P - 1), on) & m.pt_valid


class FrustumInfo(NamedTuple):
    in_frame: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    ur: torch.Tensor
    pred_level: torch.Tensor
    view_cos: torch.Tensor


def predict_level(max_dist: torch.Tensor, dist: torch.Tensor, scale_factors: torch.Tensor
                  ) -> torch.Tensor:
    """predictScale (mappoint.cpp:182-199): ceil(log(maxDist/d)/log(scale))."""
    ratio = max_dist / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / torch.log(scale_factors[1]))
    return torch.clamp(lvl.to(torch.int32), 0, scale_factors.shape[0] - 1)


def frustum_check(m: MapState, T_c_w: torch.Tensor, cam: Camera, scale_factors: torch.Tensor
                  ) -> FrustumInfo:
    """Frame::isInFrame over every map point (frame.cpp:145-190)."""
    R = T_c_w[:3, :3]
    t = T_c_w[:3, 3]
    pc = m.pt_pos @ R.T + t
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[:, 0] / safe_z + cam.cx
    v = cam.fy * pc[:, 1] / safe_z + cam.cy
    ow = -R.T @ t
    line = m.pt_pos - ow
    dist = norm3(line)
    view_cos = torch.sum(line * m.pt_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    ok = (
        (z > 0) & (u >= 0) & (u <= cam.width) & (v >= 0) & (v <= cam.height)
        # scale-invariance band with the 0.8/1.2 slack (mappoint.cpp:391-401)
        & (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist)
        & (view_cos >= 0.5) & m.pt_valid
    )
    lvl = predict_level(m.pt_max_dist, dist, scale_factors)
    ur = u - cam.bf / safe_z
    return FrustumInfo(in_frame=ok, u=u, v=v, ur=ur, pred_level=lvl, view_cos=view_cos)


class LocalMatch(NamedTuple):
    assign: torch.Tensor        # [N_kp] i32 map-point id (-1 none)
    n_matches: torch.Tensor     # i32
    visible_mask: torch.Tensor  # [P] bool


def local_top2_args(m, T_c_w, candidate_mask, tgt_uv_und, tgt_u_right, tgt_octave, tgt_desc,
                    tgt_valid, tgt_blocked, scale_factors, th_radius, cam):
    """The whole-table pre-gate, compaction and isInFrame of
    ``search_local_points`` -> (the 15 arguments of ``masked_top2``,
    compacted point ids [MAX_LOCAL_PTS], gated candidate mask [P])."""
    P = m.pt_valid.shape[0]
    R = T_c_w[:3, :3]
    t = T_c_w[:3, 3]
    # cheap whole-table frustum pre-gate (z>0, inside the image) before the
    # compaction, so out-of-view points never take compacted slots
    pc_all = m.pt_pos @ R.T + t
    z_all = pc_all[:, 2]
    sz_all = torch.where(torch.abs(z_all) < 1e-9, 1e-9, z_all)
    u_all = cam.fx * pc_all[:, 0] / sz_all + cam.cx
    v_all = cam.fy * pc_all[:, 1] / sz_all + cam.cy
    candidate_mask = candidate_mask & (
        (z_all > 0) & (u_all >= 0) & (u_all <= cam.width) & (v_all >= 0) & (v_all <= cam.height))

    c_id = compact_ids(candidate_mask, MAX_LOCAL_PTS)
    sid = c_id.clamp(min=0).long()
    c_on = (c_id >= 0)
    c_pos = torch.where(c_on[:, None], m.pt_pos[sid], 0.0)
    c_norm = torch.where(c_on[:, None], m.pt_normal[sid], 0.0)
    c_min = torch.where(c_on, m.pt_min_dist[sid], 0.0)
    c_max = torch.where(c_on, m.pt_max_dist[sid], 0.0)
    c_desc = torch.where(c_on[:, None], m.pt_desc[sid], 0)

    pc = c_pos @ R.T + t
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    c_u = cam.fx * pc[:, 0] / safe_z + cam.cx
    c_v = cam.fy * pc[:, 1] / safe_z + cam.cy
    c_ur = c_u - cam.bf / safe_z
    ow = -R.T @ t
    line = c_pos - ow
    dist = norm3(line)
    c_cos = torch.sum(line * c_norm, dim=-1) / torch.clamp(dist, min=1e-9)
    in_frame = (
        (z > 0) & (c_u >= 0) & (c_u <= cam.width) & (c_v >= 0) & (c_v <= cam.height)
        & (dist >= 0.8 * c_min) & (dist <= 1.2 * c_max) & (c_cos >= 0.5)
    )
    c_lvl = predict_level(c_max, dist, scale_factors)
    c_ok = c_on & in_frame
    r_base = torch.where(c_cos > 0.998, 2.5, 4.0) * th_radius
    r_scale = r_base * scale_factors[c_lvl.long()]
    args = (c_desc, tgt_desc, c_u, c_v, r_scale, c_ur, r_scale, c_lvl - 1, c_lvl, c_ok,
            tgt_uv_und[:, 0].contiguous(), tgt_uv_und[:, 1].contiguous(), tgt_u_right,
            tgt_octave, tgt_valid & ~tgt_blocked)
    return args, c_id, candidate_mask


def search_local_points(
    m: MapState,
    T_c_w: torch.Tensor,
    candidate_mask: torch.Tensor,
    tgt_uv_und: torch.Tensor,
    tgt_u_right: torch.Tensor,
    tgt_octave: torch.Tensor,
    tgt_desc: torch.Tensor,
    tgt_valid: torch.Tensor,
    tgt_blocked: torch.Tensor,
    scale_factors: torch.Tensor,
    th_radius,
    cam: Camera = None,
    ratio: float = 0.8,
) -> LocalMatch:
    """matcher.cpp:274-353 as a compacted [MAX_LOCAL_PTS x N] search: the
    frustum check runs only on the compacted local candidates."""
    P = m.pt_valid.shape[0]
    N = tgt_valid.shape[0]
    args, c_id, candidate_mask = local_top2_args(
        m, T_c_w, candidate_mask, tgt_uv_und, tgt_u_right, tgt_octave, tgt_desc, tgt_valid,
        tgt_blocked, scale_factors, th_radius, cam)
    c_ok = args[9]
    best, best_d, second, second_d = match_cuda.masked_top2(*args, kernel=match_cuda.KERNEL_LOCAL)
    lvl_best = tgt_octave[best.long()]
    lvl_second = tgt_octave[second.long()]

    matched = best_d <= TH_HIGH
    ratio_fail = ((lvl_best == lvl_second)
                  & (best_d.to(torch.float32) > ratio * second_d.to(torch.float32))
                  & (second_d < match_pallas.BIG))
    matched = matched & ~ratio_fail

    # per-target dedup: later source wins (reference assignment order)
    src_ids = torch.arange(MAX_LOCAL_PTS, dtype=torch.int32, device=best.device)
    winner = torch.full((N + 1,), -1, dtype=torch.int32, device=best.device)
    winner.scatter_reduce_(0, torch.where(matched, best, N).long(),
                           torch.where(matched, src_ids, -1), "amax", include_self=True)
    winner = winner[:N]
    assign = torch.where(winner >= 0, c_id[winner.clamp(min=0).long()], -1)
    visible = scatter_or(P, torch.where(c_ok, c_id, P - 1), c_ok)
    visible = torch.cat([visible[:-1], torch.zeros(1, dtype=torch.bool, device=visible.device)])
    return LocalMatch(assign=assign, n_matches=matched.sum(dtype=torch.int32),
                      visible_mask=visible & candidate_mask)
