"""New map points by epipolar triangulation (port of
``vo_slam_test_tpu/slam_map/triangulate.py``).

LocalMapping::createNewMapPoints (localMapping.cpp:132-361) with
Matcher::searchForTriangulation + checkEpipolarConstrain (matcher.cpp:867-1010,
1306-1324): the new keyframe's unmatched keypoints against each of its 10 best
covisible neighbours whose baseline exceeds b, an epipolar-gated Hamming top-1
per neighbour (the kernel ``csrc/epi.cu`` on the card), the rotation filter, a
per-kp2 dedup, then SVD or depth triangulation with chi2 and scale gates.

Host reads: the JAX package skips a neighbour's search with ``lax.cond`` on
its gate; here the 10 gates and neighbour ids come back in one read per
keyframe event, and only the neighbours that pass are searched.
``torch.linalg.svd`` of the [N,4,4] systems checks its status on the host as
well on the card.
"""

from __future__ import annotations

import torch

from .. import lie
from ..camera import Camera
from ..matching.rotation import rotation_bins, rotation_consistency_mask
from ..ops import match_cuda
from .insert import allocate_point_slots, norm3, refresh_points, with_cross, with_row
from .map_state import (MapCaps, MapState, add_observations, covis_row_for, first_true, scatter_add,
                        scatter_or, scatter_set)

N_NEIGHBORS = 10
TH_LOW = 50


def _f12(T1, T2, K):
    """Fundamental matrix between cam1 and cam2 (localMapping.cpp:526-536):
    F12 = K^-T [t12]_x R12 K^-1 with T12 = T1 * T2^-1."""
    T12 = T1 @ lie.se3_inverse(T2)
    R12 = T12[:3, :3]
    t12 = T12[:3, 3]
    Kinv = torch.linalg.inv_ex(K)[0]
    return Kinv.T @ lie.hat(t12) @ R12 @ Kinv


def _pixel2world_batched(cam: Camera, uv, depth, T_c_w):
    """Per-row poses [n,4,4]: the batched form of ``Camera.pixel2world``."""
    pc = cam.pixel2camera(uv, depth)
    T_w_c = lie.se3_inverse(T_c_w)
    return torch.einsum("nij,nj->ni", T_w_c[:, :3, :3], pc) + T_w_c[:, :3, 3]


def create_new_map_points(
    m: MapState,
    kf_id: int,
    caps: MapCaps,
    cam: Camera,
    scale_factors: torch.Tensor,
    bow_group_div: int = 0,
) -> MapState:
    """bow_group_div: k^min(3, levels) of the vocabulary (0: none). When set,
    a candidate pair must share its featVec bucket (word // div), as the
    reference's searchForTriangulation walks featVec nodes in lockstep
    (matcher.cpp:903-965); a keypoint without a word stays unrestricted."""
    K_cap = m.kf_valid.shape[0]
    P = caps.max_pt
    N = caps.n_feat
    dev = m.device
    K_mat = cam.K
    # without a vocabulary every featVec group is unknown (-1), which the
    # kernel's group gate lets through
    no_group = torch.full((N,), -1, dtype=torch.int32, device=dev)

    def groups_of(words):
        if bow_group_div <= 0:
            return no_group
        return torch.where(words >= 0, torch.div(words, bow_group_div, rounding_mode="floor"), -1)

    g1 = groups_of(m.kf_word[kf_id])

    # ---- neighbour selection (top-10 covisible, localMapping.cpp:136) ------
    w_row = m.covis[kf_id] * m.kf_valid.to(torch.int32)
    order = torch.argsort(-w_row, stable=True)
    nb_ids = torch.where(w_row[order][:N_NEIGHBORS] > 0, order[:N_NEIGHBORS], -1).to(torch.int32)

    T1 = m.kf_pose[kf_id]
    ow1 = lie.se3_inverse(T1)[:3, 3]
    free1 = (m.kf_mp[kf_id] < 0) & m.kf_kp_valid[kf_id]          # unmatched kps
    uv1 = m.kf_uv_und[kf_id]
    oct1 = m.kf_octave[kf_id]
    ang1 = m.kf_angle[kf_id]
    ur1 = m.kf_u_right[kf_id]
    d1 = m.kf_depth[kf_id]
    desc1 = m.kf_desc[kf_id]
    ones = torch.ones(N, dtype=torch.float32, device=dev)
    pc1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy, ones], -1)
    ray1 = pc1 @ T1[:3, :3]            # R1^T * pc1 (world ray)

    # baseline gate of every neighbour slot (localMapping.cpp:172-174): the
    # one host read of this function
    T2_all = m.kf_pose[nb_ids.clamp(min=0).long()]
    ow2_all = lie.se3_inverse(T2_all)[:, :3, 3]
    gate = (nb_ids >= 0) & (norm3(ow2_all - ow1[None]) > cam.b)
    gates_h = torch.stack([gate.to(torch.int32), nb_ids]).tolist()

    def per_neighbor(nbs: int, T2):
        F12 = _f12(T1, T2, K_mat)
        free2 = (m.kf_mp[nbs] < 0) & m.kf_kp_valid[nbs]
        uv2 = m.kf_uv_und[nbs]
        oct2 = m.kf_octave[nbs]
        ur2 = m.kf_u_right[nbs]
        # epipole of cam1 in image 2 (matcher.cpp:888-892)
        e_uv = cam.camera2pixel(lie.transform_point(T2, ow1))
        dist_e2 = torch.sum((uv2 - e_uv[None, :]) ** 2, dim=-1)      # [N2]
        # epipolar line of each kp1 in image 2 (matcher.cpp:1306-1324)
        l2 = torch.cat([uv1, ones[:, None]], -1) @ F12              # [N,3]
        den = l2[:, 0] ** 2 + l2[:, 1] ** 2
        sf2 = scale_factors[oct2.long()]
        best2, best_d = match_cuda.masked_top1_epi(
            desc1, m.kf_desc[nbs], l2.contiguous(), den, g1, free1, ur1 < 0,
            uv2[:, 0].contiguous(), uv2[:, 1].contiguous(), 3.84 * sf2 ** 2,
            groups_of(m.kf_word[nbs]), free2, (ur2 < 0) & (dist_e2 < 100.0 * sf2),
        )
        has = best_d <= TH_LOW
        # rotation consistency (searchForTriangulation checkRot default)
        has = rotation_consistency_mask(rotation_bins(ang1, m.kf_angle[nbs][best2.long()]), has)
        # per-kp2 dedup: earliest kp1 wins (matcher.cpp:954-956)
        kp1_ids = torch.arange(N, dtype=torch.int32, device=dev)
        claim = torch.full((N + 1,), N, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, torch.where(has, best2, N).long(),
                              torch.where(has, kp1_ids, N), "amin", include_self=True)
        return has & (claim[best2.long()] == kp1_ids), best2

    has_rows, best2_rows = [], []
    for i, (g, nb) in enumerate(zip(*gates_h)):
        if g:
            has, best2 = per_neighbor(nb, T2_all[i])
        else:
            has = torch.zeros(N, dtype=torch.bool, device=dev)
            best2 = torch.zeros(N, dtype=torch.int32, device=dev)
        has_rows.append(has)
        best2_rows.append(best2)
    has_arr = torch.stack(has_rows)
    best2_arr = torch.stack(best2_rows)

    # each kp1 keeps its first valid neighbour (covisibility order)
    first_nb = first_true(has_arr, 0)                           # [N]
    any_nb = torch.any(has_arr, dim=0)
    nb_sel = nb_ids[first_nb]
    kp2_sel = torch.gather(best2_arr, 0, first_nb[None, :])[0]

    # ---- triangulate selected pairs ---------------------------------------
    nbs = nb_sel.clamp(min=0).long()
    k2 = kp2_sel.long()
    T2 = m.kf_pose[nbs]                                         # [N,4,4]
    uv2 = m.kf_uv_und[nbs, k2]
    oct2 = m.kf_octave[nbs, k2]
    ur2 = m.kf_u_right[nbs, k2]
    d2 = m.kf_depth[nbs, k2]
    ow2 = lie.se3_inverse(T2)[:, :3, 3]

    pc2 = torch.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy, ones], -1)
    ray2 = torch.einsum("nij,nj->ni", T2[:, :3, :3].transpose(1, 2), pc2)
    cos_ray = torch.sum(ray1 * ray2, -1) / torch.clamp(norm3(ray1) * norm3(ray2), min=1e-12)
    stereo1 = ur1 >= 0
    stereo2 = ur2 >= 0

    def cos_depth_of(d):
        return torch.cos(2.0 * torch.atan2(0.5 * cam.b, torch.clamp(d, min=1e-6)))

    cos_d1 = torch.where(stereo1, cos_depth_of(d1), 2.0)
    cos_d2 = torch.where(~stereo1 & stereo2, cos_depth_of(d2), 2.0)
    cos_depth = torch.minimum(cos_d1, cos_d2)
    use_svd = (cos_ray > 0) & (cos_ray < cos_depth) & (stereo1 | stereo2 | (cos_ray < 0.9998))

    # homogeneous DLT rows (localMapping.cpp:236-252), null vector by SVD
    P1 = T1[:3, :4]
    P2 = T2[:, :3, :4]
    A = torch.stack([
        pc1[:, 0, None] * P1[None, 2] - P1[None, 0],
        pc1[:, 1, None] * P1[None, 2] - P1[None, 1],
        pc2[:, 0, None] * P2[:, 2] - P2[:, 0],
        pc2[:, 1, None] * P2[:, 2] - P2[:, 1],
    ], dim=1)                                                    # [N,4,4]
    xh = torch.linalg.svd(A).Vh[:, 3, :]
    w_ok = torch.abs(xh[:, 3]) > 1e-8
    p_svd = xh[:, :3] / torch.where(w_ok, xh[:, 3], 1.0)[:, None]

    p_d1 = cam.pixel2world(uv1, torch.clamp(d1, min=1e-6), T1)
    p_d2 = _pixel2world_batched(cam, uv2, torch.clamp(d2, min=1e-6), T2)
    use_d1 = ~use_svd & stereo1 & (cos_d1 < cos_d2)
    use_d2 = ~use_svd & stereo2 & (cos_d2 < cos_d1)
    p3d = torch.where(use_svd[:, None], p_svd, torch.where(use_d1[:, None], p_d1, p_d2))
    ok = any_nb & ((use_svd & w_ok) | use_d1 | use_d2)

    # chi2 reprojection gates in both views (localMapping.cpp:270-321)
    def reproj_gate(T, uv, ur, octv, p):
        pc = torch.einsum("nij,nj->ni", T[:, :3, :3], p) + T[:, :3, 3]
        z = pc[:, 2]
        pos = z > 0
        invz = 1.0 / torch.where(pos, z, 1.0)
        u = cam.fx * pc[:, 0] * invz + cam.cx
        v = cam.fy * pc[:, 1] * invz + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inv_s2 = 1.0 / scale_factors[octv.long()] ** 2
        st = ur >= 0
        e2s = e2 + torch.where(st, (u - cam.bf * invz - ur) ** 2, 0.0)
        chi = torch.where(st, e2s, e2) * inv_s2
        return pos & (chi <= torch.where(st, 7.815, 5.991))

    ok = ok & reproj_gate(T1.expand(N, 4, 4), uv1, ur1, oct1, p3d)
    ok = ok & reproj_gate(T2, uv2, ur2, oct2, p3d)

    # scale consistency (localMapping.cpp:330-341)
    dist1 = norm3(p3d - ow1[None])
    dist2 = norm3(p3d - ow2)
    ok = ok & (dist1 > 1e-6) & (dist2 > 1e-6)
    ratio_d = dist2 / torch.clamp(dist1, min=1e-9)
    ratio_s = scale_factors[oct1.long()] / scale_factors[oct2.long()]
    sf = 1.5 * scale_factors[1]
    ok = ok & ~((ratio_d * sf < ratio_s) | (ratio_d > ratio_s * sf))

    # ---- allocate + write new points (recycling culled slots) -------------
    new_ids = allocate_point_slots(m, ok)
    in_cap = ok & (new_ids >= 0)
    rows = torch.where(in_cap, new_ids, P - 1)
    rl = rows.long()

    line = p3d - ow1[None]
    dist = norm3(line)
    normal = line / torch.clamp(dist, min=1e-9)[:, None]
    max_d = dist * scale_factors[oct1.long()]
    min_d = max_d / scale_factors[-1]

    def put(arr, vals):
        keep = in_cap[:, None] if vals.dim() > 1 else in_cap
        return scatter_set(arr, rl, torch.where(keep, vals, arr[rl]))

    m = m.replace(
        pt_pos=put(m.pt_pos, p3d),
        pt_normal=put(m.pt_normal, normal),
        pt_desc=put(m.pt_desc, desc1),
        pt_min_dist=put(m.pt_min_dist, min_d),
        pt_max_dist=put(m.pt_max_dist, max_d),
        pt_ref_kf=put(m.pt_ref_kf, torch.full_like(m.pt_ref_kf[rl], kf_id)),
        pt_valid=put(m.pt_valid, torch.ones_like(in_cap)),
        pt_gen=scatter_add(m.pt_gen, rl, in_cap.to(torch.int32)),
        pt_found=put(m.pt_found, torch.ones_like(m.pt_found[rl])),
        pt_visible=put(m.pt_visible, torch.ones_like(m.pt_visible[rl])),
        n_pt=torch.clamp(m.n_pt + in_cap.sum(dtype=torch.int32), max=P),
    )

    # bind keypoints in both keyframes + observations
    kp1_ids = torch.arange(N, dtype=torch.int32, device=dev)
    m = m.replace(kf_mp=with_row(m.kf_mp, kf_id,
                                 torch.maximum(m.kf_mp[kf_id], torch.where(in_cap, rows, -1))))
    m = add_observations(m, rows, kf_id, kp1_ids, in_cap)
    # neighbour side: (nb, kp2) -> point (unique by the kp2 dedup)
    nb_w = torch.where(in_cap, nb_sel, K_cap - 1).long()
    kp2_w = torch.where(in_cap, kp2_sel, N - 1).long()
    m = m.replace(kf_mp=scatter_set(m.kf_mp, (nb_w, kp2_w),
                                    torch.where(in_cap, rows, m.kf_mp[nb_w, kp2_w])))
    # per-point neighbour observation (one per point; points are unique rows)
    O = m.pt_obs_kf.shape[1]
    free = m.pt_obs_kf[rl] < 0
    slot = first_true(free, 1)
    can = in_cap & torch.any(free, dim=1)
    pr = torch.where(can, rows, P - 1).long()
    pcol = torch.where(can, slot, O - 1)
    m = m.replace(
        pt_obs_kf=scatter_set(m.pt_obs_kf, (pr, pcol), torch.where(can, nb_sel, m.pt_obs_kf[pr, pcol])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, (pr, pcol), torch.where(can, kp2_sel, m.pt_obs_kp[pr, pcol])),
        pt_obs_cnt=scatter_add(m.pt_obs_cnt, pr, can.to(torch.int32)),
    )

    # refresh stats of the new points; update covisibility row of kf_id
    m = refresh_points(m, scatter_or(P, rl, in_cap), scale_factors)
    row = m.kf_mp[kf_id]
    w = with_row(covis_row_for(m, scatter_or(P, row.clamp(min=0), row >= 0)), kf_id, 0)
    return m.replace(covis=with_cross(m.covis, kf_id, w))
