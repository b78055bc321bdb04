"""Map-point fusion (port of ``vo_slam_test_tpu/slam_map/fuse.py``).

Matcher::fuseMapPoints (matcher.cpp:1012-1133) and the two-hop orchestration
of LocalMapping::searchInNeighbors (localMapping.cpp:363-432), with
MapPoint::replaceMapPoint's observation rewiring (mappoint.cpp:214-253).

Candidate points are projected into the target keyframe; keypoints inside the
predicted-scale window pass the per-pair chi2 reprojection gate (5.991/7.815)
before the Hamming test (best <= TH_LOW=50). A match into an empty slot binds
the point; a match onto an occupied slot merges the two points, the one with
more observations winning. On the card the searches run in the chi2 mode of
the top-2 kernel (``fuse_into_keyframe``, [4096 x 1024]) and in its
neighbour-batched form (``fuse_curr_into_neighbors``, [16 x 1024 x 1024]).
"""

from __future__ import annotations

import torch

from ..camera import Camera
from ..ops import match_cuda
from .culling import _drop_last, erase_points
from .insert import Index, norm3, refresh_points, row_at, with_cross, with_row
from .local_map import predict_level
from .map_state import (MapCaps, MapState, compact_ids, covis_row_for, first_true, scatter_add,
                        scatter_or, scatter_set)

MAX_FUSE = 4096
TH_LOW = 50
MERGE_CAP = 1024  # fuse merges handled per batched pass; overflow pairs stay unmerged

_compact_ids = compact_ids


def _free_slot_order(free: torch.Tensor) -> torch.Tensor:
    """[n,O] bool -> [n,O] i32: out[:, r] = column of the r-th free slot
    (valid for r < number of free slots; 0 elsewhere)."""
    n, O = free.shape
    rank = torch.cumsum(free.to(torch.int32), dim=1) - 1
    rk = torch.where(free, rank, O).long()
    out = torch.zeros((n, O + 1), dtype=torch.int32, device=free.device)
    out.scatter_reduce_(1, rk, torch.arange(O, dtype=torch.int32, device=free.device).expand(n, O),
                        "amax", include_self=True)
    return out[:, :O]


def _project(pos, normal, min_d, max_d, R, t, cam: Camera, scale_factors):
    """Projection gates of fuseMapPoints for points [..., 3] seen through
    (R, t) -> (in-view mask, u, v, ur, predicted level)."""
    ow = -torch.einsum("...ji,...j->...i", R, t)
    pc = torch.einsum("...ij,...nj->...ni", R, pos) + t[..., None, :]
    z = pc[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / safe_z + cam.cx
    v = cam.fy * pc[..., 1] / safe_z + cam.cy
    ur = u - cam.bf / safe_z
    line = pos - ow[..., None, :]
    dist = norm3(line)
    view_ok = torch.sum(line * normal, dim=-1) >= 0.5 * dist
    ok = ((z > 0) & (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
          # 0.8/1.2 invariance slack (mappoint.cpp:391-401)
          & (dist >= 0.8 * min_d) & (dist <= 1.2 * max_d) & view_ok)
    return ok, u, v, ur, predict_level(max_d, dist, scale_factors)


def fuse_into_keyframe(
    m: MapState,
    kf_id: Index,
    cand_mask: torch.Tensor,   # [P] candidate points to fuse into kf_id
    caps: MapCaps,
    cam: Camera,
    scale_factors: torch.Tensor,
    threshold: float = 3.0,
    max_cand: int = MAX_FUSE,
) -> MapState:
    """Fuse the masked points into keyframe ``kf_id`` over a compacted
    [max_cand x N] chi2-gated search."""
    P = caps.max_pt
    N = caps.n_feat
    O = m.pt_obs_kf.shape[1]
    dev = m.device

    T = row_at(m.kf_pose, kf_id)
    # exclude points already observed by this keyframe (matcher.cpp:1029)
    seen_here = torch.any(m.pt_obs_kf == kf_id, dim=1)
    in_view, u, v, ur, pred = _project(m.pt_pos, m.pt_normal, m.pt_min_dist, m.pt_max_dist,
                                       T[:3, :3], T[:3, 3], cam, scale_factors)
    cand = cand_mask & m.pt_valid & ~seen_here & in_view

    ids = compact_ids(cand, max_cand)
    ok = ids >= 0
    sid = ids.clamp(min=0).long()
    c_pred = pred[sid]
    radius = threshold * scale_factors[c_pred.long()]
    c_ur = ur[sid]
    kp_oct = row_at(m.kf_octave, kf_id)
    kp_uv = row_at(m.kf_uv_und, kf_id)
    inv_sig2 = 1.0 / scale_factors[kp_oct.long()] ** 2
    best, best_d, _, _ = match_cuda.masked_top2(
        m.pt_desc[sid], row_at(m.kf_desc, kf_id),
        u[sid], v[sid], radius, c_ur, torch.zeros_like(c_ur),
        c_pred - 1, c_pred, ok,
        kp_uv[:, 0].contiguous(), kp_uv[:, 1].contiguous(), row_at(m.kf_u_right, kf_id), kp_oct,
        row_at(m.kf_kp_valid, kf_id), col_isig2=inv_sig2, chi2_gate=True,
    )
    matched = best_d <= TH_LOW

    # dedup per keypoint: lowest candidate slot wins
    src_ids = torch.arange(max_cand, dtype=torch.int32, device=dev)
    claim = torch.full((N + 1,), max_cand, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(0, torch.where(matched, best, N).long(),
                          torch.where(matched, src_ids, max_cand), "amin", include_self=True)
    matched = matched & (claim[best.long()] == src_ids)

    cand_pt = ids
    kp_sel = best
    org = row_at(m.kf_mp, kf_id)[kp_sel.long()]  # existing binding (-1 empty)
    org_live = (org >= 0) & m.pt_valid[org.clamp(min=0).long()]

    # --- case A: empty slot -> bind candidate (dummy lanes write col N) ------
    bindA = matched & ~org_live
    kp_w = torch.where(bindA, kp_sel, N)
    row_ext = torch.cat([row_at(m.kf_mp, kf_id), m.kf_mp.new_full((1,), -1)])
    row_new = scatter_set(row_ext, kp_w, cand_pt)[:N]
    m = m.replace(kf_mp=with_row(m.kf_mp, kf_id, row_new))
    free = m.pt_obs_kf[cand_pt.clamp(min=0).long()] < 0
    slot = first_true(free, 1)
    can_app = bindA & torch.any(free, dim=1)
    pr = torch.where(can_app, cand_pt, P - 1).long()
    pcol = torch.where(can_app, slot, O - 1)
    m = m.replace(
        pt_obs_kf=scatter_set(m.pt_obs_kf, (pr, pcol),
                              torch.where(can_app, kf_id, m.pt_obs_kf[pr, pcol])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, (pr, pcol),
                              torch.where(can_app, kp_sel, m.pt_obs_kp[pr, pcol])),
        pt_obs_cnt=scatter_add(m.pt_obs_cnt, torch.where(bindA, cand_pt, P - 1),
                               bindA.to(torch.int32)),
    )

    # --- case B: occupied slot -> merge, more observations wins --------------
    merge = matched & org_live & (org != cand_pt)
    org_s = org.clamp(min=0)
    cand_s = cand_pt.clamp(min=0)
    org_wins = m.pt_obs_cnt[org_s.long()] > m.pt_obs_cnt[cand_s.long()]
    winner = torch.where(org_wins, org_s, cand_s)
    loser = torch.where(org_wins, cand_s, org_s)
    return _replace_points(m, loser, winner, merge)


def _replace_points(m: MapState, loser: torch.Tensor, winner: torch.Tensor,
                    mask: torch.Tensor) -> MapState:
    """Rewire each loser's observations onto its winner, then erase the loser
    (mappoint.cpp:214-253). loser/winner: [n] point ids; mask: [n]."""
    P, O = m.pt_obs_kf.shape
    K, N = m.kf_mp.shape

    # found/visible transfer
    l_rows = torch.where(mask, loser, P - 1).long()
    w_rows = torch.where(mask, winner, P - 1).long()
    m = m.replace(
        pt_found=scatter_add(m.pt_found, w_rows, torch.where(mask, m.pt_found[l_rows], 0)),
        pt_visible=scatter_add(m.pt_visible, w_rows, torch.where(mask, m.pt_visible[l_rows], 0)),
    )

    lkf = m.pt_obs_kf[l_rows]                       # [n,O]
    lkp = m.pt_obs_kp[l_rows]
    has = mask[:, None] & (lkf >= 0)
    wkf = m.pt_obs_kf[w_rows]                       # [n,O]
    dup = torch.any(lkf[:, :, None] == wkf[:, None, :], dim=2) & has
    move = has & ~dup

    # rebind (move) or clear (dup) every touched keyframe slot; dummy lanes
    # go one past the end of the keypoint axis (column N, sliced away)
    kf_w = torch.where(has, lkf, K - 1)
    kp_w = torch.where(has, lkp, N)
    new_val = torch.where(move, winner[:, None], -1)
    kf_mp_ext = torch.cat([m.kf_mp, m.kf_mp.new_full((K, 1), -1)], dim=1)
    m = m.replace(kf_mp=scatter_set(kf_mp_ext, (kf_w, kp_w), new_val)[:, :N].contiguous())

    # append moved observations into the winner's free slots: the r-th move
    # of a row lands in the r-th free slot
    rank = torch.cumsum(move.to(torch.int32), dim=1) - 1      # [n,O]
    free = wkf < 0
    forder = _free_slot_order(free)
    nfree = free.sum(dim=1, dtype=torch.int32)
    can = move & (rank < nfree[:, None])
    slot = torch.gather(forder, 1, rank.clamp(0, O - 1).long())
    pr = torch.where(can, winner[:, None], P - 1).long()
    pc_ = torch.where(can, slot, O - 1)
    m = m.replace(
        pt_obs_kf=scatter_set(m.pt_obs_kf, (pr, pc_), torch.where(can, lkf, m.pt_obs_kf[pr, pc_])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, (pr, pc_), torch.where(can, lkp, m.pt_obs_kp[pr, pc_])),
        pt_obs_cnt=scatter_add(m.pt_obs_cnt, w_rows,
                               torch.where(mask, can.sum(dim=1, dtype=torch.int32), 0)),
    )
    # erase losers (at most one per merge row)
    bad = _drop_last(scatter_or(P, l_rows, mask))
    return erase_points(m, bad, max_erase=min(loser.shape[0], 1024))


def fuse_curr_into_neighbors(
    m: MapState,
    kf_id: Index,
    nb_ids: torch.Tensor,      # [B] neighbour keyframe ids, -1 padded
    caps: MapCaps,
    cam: Camera,
    scale_factors: torch.Tensor,
    threshold: float = 3.0,
) -> MapState:
    """Fuse the current keyframe's points into all B neighbours in one pass:
    the B [N x N] searches are one launch of the neighbour-batched kernel.
    All B searches read the pre-fuse map (the JAX package's documented
    deviation from the reference's sequential loop)."""
    P = caps.max_pt
    N = caps.n_feat
    O = m.pt_obs_kf.shape[1]
    B = nb_ids.shape[0]
    dev = m.device

    row = row_at(m.kf_mp, kf_id)               # [N] candidate point per slot
    pid = row.clamp(min=0).long()
    base_ok = (row >= 0) & m.pt_valid[pid]
    p_desc = m.pt_desc[pid]                    # [N,8]
    p_obs = m.pt_obs_kf[pid]                   # [N,O]
    p_max = m.pt_max_dist[pid]

    nb = nb_ids.clamp(min=0).long()            # [B]
    nb_ok = nb_ids >= 0
    T = m.kf_pose[nb]                          # [B,4,4]
    in_view, u, v, ur, pred = _project(m.pt_pos[pid], m.pt_normal[pid], m.pt_min_dist[pid], p_max,
                                       T[:, :3, :3], T[:, :3, 3], cam, scale_factors)
    # exclude points already observed by each neighbour (matcher.cpp:1029)
    seen = torch.any(p_obs[None, :, :] == nb[:, None, None], dim=-1)  # [B,N]
    cand = base_ok[None] & nb_ok[:, None] & ~seen & in_view
    radius = threshold * scale_factors[pred.long()]

    kp_uv = m.kf_uv_und[nb]                    # [B,N,2]
    kp_oct = m.kf_octave[nb]
    kp_ok = m.kf_kp_valid[nb] & nb_ok[:, None]
    inv_sig2 = 1.0 / scale_factors[kp_oct.long()] ** 2
    best, best_d, _, _ = match_cuda.masked_top2_nb(
        p_desc[None].expand(B, N, 8), m.kf_desc[nb],
        u, v, radius, ur, torch.zeros_like(ur),
        pred - 1, pred, cand,
        kp_uv[..., 0].contiguous(), kp_uv[..., 1].contiguous(), m.kf_u_right[nb], kp_oct, kp_ok,
        col_isig2=inv_sig2, chi2_gate=True,
    )
    matched = best_d <= TH_LOW                 # [B,N]

    # per-neighbour dedup: lowest candidate slot wins
    src_ids = torch.arange(N, dtype=torch.int32, device=dev)
    claim = torch.full((B, N + 1), N, dtype=torch.int32, device=dev)
    claim.scatter_reduce_(1, torch.where(matched, best, N).long(),
                          torch.where(matched, src_ids[None], N), "amin", include_self=True)
    matched = matched & (torch.gather(claim, 1, best.long()) == src_ids[None])

    cand_pt = row[None].expand(B, N)
    org = m.kf_mp[nb[:, None], best.long()]    # [B,N]
    org_live = (org >= 0) & m.pt_valid[org.clamp(min=0).long()]

    # --- case A: empty slot -> bind candidate (dummy lanes write col N) ----
    bindA = matched & ~org_live
    kp_w = torch.where(bindA, best, N)
    nb_rows = nb[:, None].expand(B, N)
    kf_mp_ext = torch.cat([m.kf_mp, m.kf_mp.new_full((m.kf_mp.shape[0], 1), -1)], dim=1)
    m = m.replace(kf_mp=scatter_set(kf_mp_ext, (nb_rows, kp_w), cand_pt)[:, :N].contiguous())
    # a candidate may bind in several neighbours: its r-th bind (over the
    # neighbour axis) lands in its r-th free observation slot
    free = m.pt_obs_kf[pid] < 0                # [N,O]
    forder = _free_slot_order(free)
    nfree = free.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(bindA.to(torch.int32), dim=0) - 1   # [B,N]
    can_app = bindA & (rank < nfree[None])
    slot = forder[src_ids[None].expand(B, N).long(), rank.clamp(0, O - 1).long()]
    pr = torch.where(can_app, cand_pt, P - 1).long()
    pcol = torch.where(can_app, slot, O - 1)
    m = m.replace(
        pt_obs_kf=scatter_set(m.pt_obs_kf, (pr, pcol),
                              torch.where(can_app, nb_rows.to(torch.int32), m.pt_obs_kf[pr, pcol])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, (pr, pcol),
                              torch.where(can_app, best, m.pt_obs_kp[pr, pcol])),
        pt_obs_cnt=scatter_add(m.pt_obs_cnt, pr, can_app.to(torch.int32)),
    )

    # --- case B: occupied slot -> merge, more observations wins -----------
    merge = matched & org_live & (org != cand_pt)
    org_s = org.clamp(min=0)
    cand_s = cand_pt.clamp(min=0)
    org_wins = m.pt_obs_cnt[org_s.long()] > m.pt_obs_cnt[cand_s.long()]
    winner = torch.where(org_wins, org_s, cand_s)
    loser = torch.where(org_wins, cand_s, org_s)
    # compact the (rare) merges to MERGE_CAP rows, then let each point take
    # part in at most one merge row per pass (first row wins)
    mid = compact_ids(merge.reshape(-1), MERGE_CAP)
    mok = mid >= 0
    ms_ = mid.clamp(min=0).long()
    l_ids = torch.where(mok, loser.reshape(-1)[ms_], P - 1)
    w_ids = torch.where(mok, winner.reshape(-1)[ms_], P - 1)
    rows = torch.arange(MERGE_CAP, dtype=torch.int32, device=dev)
    row_of = torch.where(mok, rows, MERGE_CAP)
    first = torch.full((P,), MERGE_CAP, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, l_ids.long(), row_of, "amin", include_self=True)
    first.scatter_reduce_(0, w_ids.long(), row_of, "amin", include_self=True)
    keep = mok & (first[l_ids.long()] == rows) & (first[w_ids.long()] == rows)
    return _replace_points(m, torch.where(keep, l_ids, P - 1), torch.where(keep, w_ids, P - 1),
                           keep)


def two_hop_neighbors(m: MapState, kf_id: Index) -> torch.Tensor:
    """[K] mask: the 10 best covisibles and the 5 best covisibles of each
    (localMapping.cpp:365-390), excluding kf_id. Stable sorts, as JAX's."""
    K = m.kf_valid.shape[0]
    w = torch.where(m.kf_valid[None, :], m.covis, 0)
    first = torch.argsort(-row_at(w, kf_id), stable=True)[:10]
    first_ok = row_at(w, kf_id)[first] > 0
    mask = scatter_or(K, torch.where(first_ok, first, K - 1), first_ok)
    second = torch.argsort(-w[first], dim=1, stable=True)[:, :5]   # [10,5]
    sec_ok = (torch.gather(w[first], 1, second) > 0) & first_ok[:, None]
    mask = mask | scatter_or(K, torch.where(sec_ok, second, K - 1), sec_ok)
    mask = mask & (torch.arange(K, device=mask.device) != kf_id)
    return mask & m.kf_valid


def search_in_neighbors(m: MapState, kf_id: Index, caps: MapCaps, cam: Camera,
                        scale_factors: torch.Tensor) -> MapState:
    """Two-hop fuse around a new keyframe (localMapping.cpp:363-432): the
    KF's points into every neighbour, every neighbour's points into the KF,
    then refresh the touched points and the covisibility row."""
    P = caps.max_pt
    nb_mask = two_hop_neighbors(m, kf_id)
    nb_ids = compact_ids(nb_mask, 16)  # [16], -1 padded

    m = fuse_curr_into_neighbors(m, kf_id, nb_ids, caps, cam, scale_factors)

    rows_on = nb_mask[:, None] & (m.kf_mp >= 0)
    nb_pts = scatter_or(P, torch.where(rows_on, m.kf_mp, P - 1), rows_on)
    m = fuse_into_keyframe(m, kf_id, nb_pts, caps, cam, scale_factors)

    row2 = row_at(m.kf_mp, kf_id)
    touched = scatter_or(P, row2.clamp(min=0), row2 >= 0)
    m = refresh_points(m, touched, scale_factors)
    w = with_row(covis_row_for(m, touched), kf_id, 0)
    return m.replace(covis=with_cross(m.covis, kf_id, w))
