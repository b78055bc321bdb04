"""Map-point and keyframe culling (port of
``vo_slam_test_tpu/slam_map/culling.py``).

- cull_map_points: the recent-point filter (localMapping.cpp:496-524): erase
  when foundRatio < 0.25, or when older than 2 keyframes with obs <= 3.
- cull_keyframes: redundancy erasure (localMapping.cpp:434-494): a connected
  keyframe dies when > 90% of its close tracked points are seen >= 3 more
  times at the same-or-finer (level+1) octave elsewhere; its observations go,
  its covisibility is zeroed and its children are reparented, with Tcp
  recorded for trajectory recovery (keyframe.cpp:400-491).

The reparenting is the JAX package's ``fori_loop`` over the culled
keyframes around a ``fori_loop`` of greedy attach steps, each a
``utils.graphs.fori_loop`` (one WHILE node in a capture, its body captured
once); nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

from .. import lie
from ..camera import Camera
from ..utils import graphs
from .insert import Index, row_at
from .map_state import MapCaps, MapState, compact_ids, pick, scatter_add, scatter_or, scatter_set


def _drop_last(mask: torch.Tensor) -> torch.Tensor:
    """``mask.at[-1].set(False)`` for a [P] bool mask."""
    return torch.cat([mask[:-1], torch.zeros(1, dtype=torch.bool, device=mask.device)])


def cull_map_points(m: MapState, curr_kf, caps: MapCaps) -> MapState:
    recent = m.pt_valid & (m.pt_ref_kf >= 0) & (curr_kf <= m.pt_ref_kf + 3)
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible, min=1).to(torch.float32)
    bad = recent & (found_ratio < 0.25)
    bad = bad | (recent & (curr_kf > m.pt_ref_kf + 2) & (m.pt_obs_cnt <= 3))
    return erase_points(m, bad)


MAX_ERASE = 4096  # dying points handled per erase call; overflow stays valid


def erase_points(m: MapState, bad: torch.Tensor, max_erase: int = MAX_ERASE) -> MapState:
    """Invalidate points and unbind their keypoint slots in every observer
    (mappoint eraseMapPoint, mappoint.cpp:362-381), over the first
    ``max_erase`` dying points."""
    K, N = m.kf_mp.shape
    P, O = m.pt_obs_kf.shape
    bad = bad & m.pt_valid
    ids = compact_ids(bad, max_erase)
    ok = ids >= 0
    sid = ids.clamp(min=0).long()
    bad_eff = _drop_last(scatter_or(P, torch.where(ok, sid, P - 1), ok))

    obs_kf = m.pt_obs_kf[sid]   # [E,O]
    obs_kp = m.pt_obs_kp[sid]
    kill = ok[:, None] & (obs_kf >= 0)
    kf_w = torch.where(kill, obs_kf, K - 1).reshape(-1).long()
    kp_w = torch.where(kill, obs_kp, N - 1).reshape(-1).long()
    # only clear where the slot actually references the dying point
    pt_of = sid[:, None].expand(kill.shape).reshape(-1)
    old = m.kf_mp[kf_w, kp_w]
    hit = kill.reshape(-1) & (old == pt_of)
    rows = torch.where(ok, sid, P - 1)
    return m.replace(
        kf_mp=scatter_set(m.kf_mp, (kf_w, kp_w), torch.where(hit, -1, old)),
        pt_valid=m.pt_valid & ~bad_eff,
        pt_obs_kf=scatter_set(m.pt_obs_kf, rows, torch.where(ok[:, None], -1, m.pt_obs_kf[rows])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, rows, torch.where(ok[:, None], -1, m.pt_obs_kp[rows])),
        pt_obs_cnt=scatter_set(m.pt_obs_cnt, rows, torch.where(ok, 0, m.pt_obs_cnt[rows])),
    )


def cull_keyframes(m: MapState, curr_kf: Index, caps: MapCaps, cam: Camera) -> MapState:
    """Erase redundant keyframes connected to curr_kf."""
    K, N = m.kf_mp.shape
    P = caps.max_pt
    dev = m.device
    min_obs = 3
    kf_ar = torch.arange(K, device=dev)

    connected = (row_at(m.covis, curr_kf) > 0) & m.kf_valid
    connected = connected & (kf_ar != 0) & (kf_ar != curr_kf)  # never KF 0 (:445)
    # keyframes with a loop edge are never erased (keyframe.cpp:528-556)
    connected = connected & ~torch.any(m.loop_edges, dim=1)

    C = min(32, K)
    cand_ids = compact_ids(connected, C)
    cid = cand_ids.clamp(min=0).long()
    c_ok = cand_ids >= 0

    pt = m.kf_mp[cid]                               # [C,N]
    has = (pt >= 0) & m.kf_kp_valid[cid]
    close = has & (m.kf_depth[cid] > 0) & (m.kf_depth[cid] <= cam.th_depth)
    safe_pt = pt.clamp(min=0).long()

    # compact the points bound to a candidate to E rows
    E = 8192
    O = m.pt_obs_kf.shape[1]
    bound = _drop_last(scatter_or(P, torch.where(has, pt, P - 1), has)) & m.pt_valid
    eids = compact_ids(bound, E)
    e_ok = eids >= 0
    esafe = eids.clamp(min=0).long()
    # inverse map point id -> compact slot (E = absent)
    eslot = torch.full((P,), E, dtype=torch.int32, device=dev)
    eslot = scatter_set(eslot, torch.where(e_ok, esafe, P - 1),
                        torch.where(e_ok, torch.arange(E, dtype=torch.int32, device=dev), E))

    obs_kf_e = m.pt_obs_kf[esafe]                   # [E,O]
    obs_kp_e = m.pt_obs_kp[esafe]
    obs_ok_e = e_ok[:, None] & (obs_kf_e >= 0)
    oct_e = m.kf_octave[obs_kf_e.clamp(min=0).long(), obs_kp_e.clamp(min=0).long()]

    # cum[e, l] = #observers with octave <= l
    n_lvl = 8
    lv = torch.arange(n_lvl, device=dev)
    cum = ((oct_e[:, :, None] <= lv[None, None, :]) & obs_ok_e[:, :, None]).sum(
        dim=1, dtype=torch.int32)                   # [E, n_lvl]
    cum_p = torch.cat([cum, torch.zeros((1, n_lvl), dtype=torch.int32, device=dev)])
    lvl = torch.clamp(m.kf_octave[cid] + 1, 0, n_lvl - 1).long()  # [C,N]
    es = eslot[safe_pt].long()
    cnt = cum_p[es, lvl] - 1                        # [C,N]
    well_obs = close & (m.pt_obs_cnt[safe_pt] > min_obs) & (cnt >= min_obs) & (es < E)

    mp_cnt = close.sum(dim=1, dtype=torch.int32)
    re_obs = well_obs.sum(dim=1, dtype=torch.int32)
    cull_c = c_ok & (re_obs.to(torch.float32) > 0.9 * mp_cnt.to(torch.float32)) & (mp_cnt > 0)
    cull = scatter_or(K, torch.where(cull_c, cid, K - 1), cull_c) & connected

    # ---- erase culled keyframes' observations ------------------------------
    E2 = 4096
    kill_bound = has & cull_c[:, None]              # [C,N]
    bound2 = _drop_last(scatter_or(P, torch.where(kill_bound, pt, P - 1), kill_bound))
    kids = compact_ids(bound2, E2)
    k_ok = kids >= 0
    ksafe = kids.clamp(min=0).long()
    obs_kf_k = m.pt_obs_kf[ksafe]                   # [E2,O]
    obs_kp_k = m.pt_obs_kp[ksafe]
    obs_ok_k = k_ok[:, None] & (obs_kf_k >= 0)
    kill_k = cull[obs_kf_k.clamp(min=0).long()] & obs_ok_k
    krows = torch.where(k_ok, ksafe, P - 1)
    m = m.replace(
        pt_obs_kf=scatter_set(m.pt_obs_kf, krows, torch.where(kill_k, -1, obs_kf_k)),
        pt_obs_kp=scatter_set(m.pt_obs_kp, krows, torch.where(kill_k, -1, obs_kp_k)),
        pt_obs_cnt=scatter_add(m.pt_obs_cnt, krows, -kill_k.sum(dim=1, dtype=torch.int32)),
    )
    # points left with obs <= 2 from an erase die too (mappoint.cpp:353)
    touched = _drop_last(scatter_or(P, krows, torch.any(kill_k, dim=1)))
    m = erase_points(m, touched & (m.pt_obs_cnt <= 2) & m.pt_valid)

    # Tcp for trajectory recovery + spanning-tree reparenting
    parent = m.parent
    safe_par = parent.clamp(min=0).long()
    T_cp = m.kf_pose @ lie.se3_inverse(m.kf_pose[safe_par])
    kf_tcp = torch.where(cull[:, None, None], T_cp, m.kf_tcp)
    # fallback baseline: the culled KF's parent, or its grandparent if that
    # parent died in the same batch
    par_of_parent = parent[safe_par]
    new_parent = torch.where(
        (parent >= 0) & cull[safe_par],
        torch.where(cull[par_of_parent.clamp(min=0).long()], -1, par_of_parent),
        parent,
    )
    # greedy covisible re-selection (keyframe.cpp:431-483) for the first CU
    # culled keyframes, CH attach steps each
    CU, CH = 4, 8
    culled_ids = compact_ids(cull_c, CU)   # candidate slots of the culled KFs
    culled_ids = torch.where(culled_ids >= 0, cand_ids[culled_ids.clamp(min=0).long()], -1)
    live_after = m.kf_valid & ~cull
    covis_w = torch.where(live_after[:, None] & live_after[None, :], m.covis, 0)

    def step(_, st):
        new_parent, children, cand = st
        Wm = torch.where(children[:, None] & cand[None, :], covis_w, 0)
        best = torch.argmax(Wm)
        bx = best // K
        bw = (best % K).to(torch.int32)
        ok = Wm.max() > 0
        at_bx = kf_ar == bx
        took = at_bx & ok
        return torch.where(took, bw, new_parent), children & ~took, cand | took

    def reparent_one(i, new_parent):
        ci = pick(culled_ids, i)
        c = ci.clamp(min=0)
        do = ci >= 0
        gp = pick(parent, c)
        gp_ok = (gp >= 0) & ~pick(cull, gp.clamp(min=0))
        children = do & (parent == c) & live_after
        cand = (kf_ar == gp.clamp(min=0)) & gp_ok & do
        return graphs.fori_loop(0, CH, step, (new_parent, children, cand))[0]

    new_parent = graphs.fori_loop(0, CU, reparent_one, new_parent)
    return m.replace(
        kf_valid=m.kf_valid & ~cull,
        kf_mp=torch.where(cull[:, None], -1, m.kf_mp),
        covis=torch.where(cull[:, None] | cull[None, :], 0, m.covis),
        parent=new_parent,
        kf_tcp=kf_tcp,
        cull_parent=torch.where(cull, parent, m.cull_parent),
        cull_parent_gen=torch.where(
            cull, torch.where(parent >= 0, m.kf_gen[safe_par], -1), m.cull_parent_gen),
        cull_gen=torch.where(cull, m.kf_gen, m.cull_gen),
        loop_edges=m.loop_edges & ~cull[:, None] & ~cull[None, :],
    )
