"""Loop closing: detection, Sim3 verification, correction, essential graph
(port of ``vo_slam_test_tpu/pipeline/loop_closing.py``).

The reference's LoopClosing thread (loopClosing.cpp):

- ``detect_step``: BoW scores of the new keyframe against the whole map, the
  minimum-covisible-score gate (:68-83), Map::detectLoopCandidates and the
  consistency groups over consecutive detections (:95-174), kept as
  fixed-shape group masks;
- ``close_step`` / ``_close_multi``: keyframe-to-keyframe BoW matching, the
  batched Horn Sim3 RANSAC (>= 20 inliers), searchBySim3's enlargement of the
  match set, LM Sim3 refinement (>= 20), the projection of the candidate's
  neighbourhood through the corrected pose with the >= 40 gate (:178-348);
  then correctLoop (:350-492): the correction propagated to the current
  keyframe's covisible group and its points, the loop points fused into the
  corrected group (one chi2-gated top-2 launch per group keyframe,
  ``slam_map/fuse.py::fuse_into_keyframe``), and the essential-graph Sim3
  pose graph (``solvers/pose_graph.py``) with edge measurements from the
  pre-correction poses and the new loop connections from the corrected ones;
  map points follow their reference keyframes (optimizer_ceres.cpp:1281-1301).

Host reads: the JAX package branches on device scalars with ``lax.cond``;
here a branch that decides which kernels run is a host value. Detection runs
on the device and its confirmed candidates are read back once per keyframe
event (``SlamSystem`` does it); each Sim3 attempt reads its gate values and
its accept decision once, with the ids of the group it would correct.

Deviation (the JAX package's DEVIATIONS.md D1): the reference runs 5 RANSAC
iterations per candidate per loop round; the batched solver evaluates 128
hypotheses once per confirmed candidate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from .. import lie
from ..bow import retrieval as bow_ret
from ..camera import Camera
from ..matching import bow_match
from ..ops import hamming
from ..slam_map import fuse
from ..slam_map.insert import norm3
from ..slam_map.map_state import (MapCaps, MapState, compact_ids, first_true, scatter_or,
                                  scatter_set)
from ..solvers import pose_graph, sim3
from ..utils import prng

MAX_GROUPS = 32
MAX_CANDS = 8          # candidate groups tracked per detection round
MIN_KF_GAP = 10        # >= 10 keyframes since the last loop (loopClosing.cpp:62)
CONSISTENCY = 3        # consecutive consistent detections (:149)
BIG = 1 << 20          # Hamming distance of a pair the window excludes
GROUP_FUSE = 16        # corrected-group keyframes the loop points fuse into


@dataclasses.dataclass
class LoopState:
    groups: torch.Tensor         # [G,K] bool previous candidate groups
    counts: torch.Tensor         # [G] i32 consistency counts
    n_groups: torch.Tensor       # i32
    last_loop_seq: torch.Tensor  # i32 kf_seq of the last accepted loop keyframe:
                                 # the gap gate counts insertion order
                                 # (keyframe.cpp id_), not slots, which stop
                                 # being creation-ordered once slots recycle

    def replace(self, **kw) -> "LoopState":
        return dataclasses.replace(self, **kw)


def empty_loop_state(caps: MapCaps, device) -> LoopState:
    return LoopState(
        groups=torch.zeros((MAX_GROUPS, caps.max_kf), dtype=torch.bool, device=device),
        counts=torch.zeros((MAX_GROUPS,), dtype=torch.int32, device=device),
        n_groups=torch.zeros((), dtype=torch.int32, device=device),
        # the reference initializes lastLoopKFId_ = 0 (loopClosing.cpp:14),
        # so the first 10 keyframes can never close a loop
        last_loop_seq=torch.zeros((), dtype=torch.int32, device=device),
    )


def advance_consistency(cand_groups, top_ok, prev_groups, prev_counts, n_prev):
    """One round of the reference's consistency-group update
    (loopClosing.cpp:95-174), vectorized:

    - intersections [C,G] between candidate groups and previous groups;
    - a candidate's consistency count is max(prevCnt) + 1 over intersecting
      previous groups (the reference's currCnt >= 3 test on EVERY
      intersecting group confirms the same set);
    - the next round's group list follows the vbConsistentGroup dedup: each
      previous group is claimed by the first candidate intersecting it (one
      entry per claimed group, count prevCnt + 1), a candidate intersecting
      nothing pushes its own group with count 0, and one whose intersecting
      groups were all claimed already pushes nothing.

    Returns (groups [G,K], counts [G], n_groups, cand_counts [C])."""
    G = prev_groups.shape[0]
    C, K = cand_groups.shape
    dev = cand_groups.device
    inter = (torch.any(cand_groups[:, None, :] & prev_groups[None, :, :], dim=2)
             & (torch.arange(G, device=dev)[None, :] < n_prev))             # [C,G]
    prev_best = torch.where(inter, prev_counts[None, :], -1).max(dim=1).values
    cand_counts = torch.where(top_ok, torch.where(prev_best >= 0, prev_best + 1, 0), 0
                              ).to(torch.int32)

    claimed = torch.any(inter, dim=0)                                       # [G]
    first_i = first_true(inter, 0)                                          # [G]
    gA = cand_groups[first_i] & claimed[:, None]
    cA = torch.where(claimed, prev_counts + 1, 0).to(torch.int32)
    none = top_ok & ~torch.any(inter, dim=1)                                # [C]
    gB = cand_groups & none[:, None]
    all_valid = torch.cat([claimed, none])                                  # [G+C]
    all_groups = torch.cat([gA, gB]) & all_valid[:, None]
    all_counts = torch.cat([cA, torch.zeros((C,), dtype=torch.int32, device=dev)])
    pos = torch.cumsum(all_valid.to(torch.int32), 0) - 1
    slot = torch.where(all_valid & (pos < G), pos, G).long()
    hits = torch.zeros((G + 1, K), dtype=torch.int32, device=dev)
    groups = hits.index_add_(0, slot, all_groups.to(torch.int32))[:G] > 0
    counts = scatter_set(torch.zeros((G + 1,), dtype=torch.int32, device=dev), slot,
                         torch.where(all_valid, all_counts, 0))[:G]
    n_groups = torch.clamp(all_valid.sum(dtype=torch.int32), max=G)
    return groups, counts, n_groups, cand_counts


def detect_step(m: MapState, ls: LoopState, did_kf: bool, kf_id: int, caps: MapCaps
                ) -> Tuple[LoopState, torch.Tensor, torch.Tensor]:
    """-> (new loop state, confirmed candidate keyframe ids [MAX_CANDS] best
    score first, -1 padded, their kf_gen at detection time). All on the
    device; a frame without a new keyframe returns the state unchanged."""
    dev = m.device
    if not (did_kf and kf_id >= 0):
        pad = torch.full((MAX_CANDS,), -1, dtype=torch.int32, device=dev)
        return ls, pad, pad
    kf = kf_id
    K = caps.max_kf
    scores, shared = bow_ret.scores_vs_keyframes(
        m.kf_bow_word[kf], m.kf_bow_weight[kf], m.kf_bow_word, m.kf_bow_weight,
        m.kf_valid.to(torch.float32))
    covis_kfs = (m.covis[kf] > 0) & m.kf_valid
    min_score = torch.where(covis_kfs, scores, torch.inf).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    cand_mask = bow_ret.loop_candidates(scores, shared, m.covis, m.kf_valid, kf, min_score)

    # consistency groups: vbConsistentGroup semantics, see advance_consistency
    top_scores, top_ids = prng.top_k(torch.where(cand_mask, scores, -torch.inf), MAX_CANDS)
    top_ok = torch.isfinite(top_scores)
    self_row = torch.nn.functional.one_hot(top_ids, K).to(torch.bool)
    cand_groups = (self_row | ((m.covis[top_ids] > 0) & m.kf_valid[None, :])) & top_ok[:, None]
    groups, counts, n_groups, new_counts = advance_consistency(
        cand_groups, top_ok, ls.groups, ls.counts, ls.n_groups)
    gap_ok = m.kf_seq[kf] >= ls.last_loop_seq + MIN_KF_GAP
    conf_mask = top_ok & (new_counts >= CONSISTENCY) & gap_ok
    # every enough-consistent candidate, best score first: the reference's
    # computeSim3 tries each until one verifies (loopClosing.cpp:178-348)
    top_ids = top_ids.to(torch.int32)
    out_cands = torch.where(conf_mask, top_ids, -1)
    out_gens = torch.where(conf_mask, m.kf_gen[top_ids.long()], -1)
    return ls.replace(groups=groups, counts=counts, n_groups=n_groups), out_cands, out_gens


def _gates_and_group(m, ls, kf, cd, gen_ok, caps, cam, scale_factors, groups_curr, groups_cand):
    """The Sim3 verification of candidate ``cd`` for keyframe ``kf`` on the
    device -> (gate tensors, what the correction needs)."""
    K, P = caps.max_kf, caps.max_pt
    ids = torch.arange(K, device=m.device)
    row1, row2 = m.kf_mp[kf], m.kf_mp[cd]
    live1 = (row1 >= 0) & m.pt_valid[row1.clamp(min=0).long()]
    live2 = (row2 >= 0) & m.pt_valid[row2.clamp(min=0).long()]

    # keyframe-to-keyframe BoW matching (matcher.cpp:561-677, ratio 0.75):
    # per keypoint of kf, the matched point of cd
    res = bow_match.search_by_bow_kf_frame(
        kf_desc=m.kf_desc[cd], kf_groups=groups_cand, kf_mp=row2, kf_angle=m.kf_angle[cd],
        kf_pt_valid=live2, f_desc=m.kf_desc[kf], f_groups=groups_curr,
        f_angle=m.kf_angle[kf], f_valid=m.kf_kp_valid[kf] & live1, ratio=0.75)
    match2 = res.assign
    pair_ok = (match2 >= 0) & live1

    # camera-frame coordinates of the matched point pairs
    T1, T2 = m.kf_pose[kf], m.kf_pose[cd]
    pc1 = m.pt_pos[row1.clamp(min=0).long()] @ T1[:3, :3].T + T1[:3, 3]
    uv1 = cam.camera2pixel(pc1)
    sig1 = scale_factors[m.kf_octave[kf].long()] ** 2

    def side2(pt_ids, kp_ids):
        pc = m.pt_pos[pt_ids.clamp(min=0).long()] @ T2[:3, :3].T + T2[:3, 3]
        sig = scale_factors[m.kf_octave[cd][kp_ids.clamp(min=0).long()].long()] ** 2
        return pc, cam.camera2pixel(pc), sig

    pc2, uv2, sig2 = side2(match2, res.src_kp)
    s12, T12, inl_r, n_ransac = sim3.ransac_sim3(
        pc1, pc2, uv1, uv2, 9.21 * sig1, 9.21 * sig2, pair_ok,
        cam.fx, cam.fy, cam.cx, cam.cy, seed=kf)

    # searchBySim3 enlarges the match set before the refinement
    # (matcher.cpp:679-865; computeSim3's order, loopClosing.cpp:253-274): the
    # >= 20 refine gate counts these extra matches
    pc2_own = m.pt_pos[row2.clamp(min=0).long()] @ T2[:3, :3].T + T2[:3, 3]
    sb_kp, sb_ok = _search_by_sim3(m, kf, cd, T12, s12, pc1, pc2_own, live1, live2, cam,
                                   scale_factors)
    sb_new = sb_ok & (match2 < 0) & live1
    match2 = torch.where(pair_ok, match2,
                         torch.where(sb_new, row2[sb_kp.clamp(min=0).long()], -1))
    cand_kp = torch.where(pair_ok, res.src_kp, torch.where(sb_new, sb_kp, -1))
    pc2, uv2, sig2 = side2(match2, cand_kp)
    _, T12b, _, n_ref = sim3.refine_sim3(
        T12, s12, pc1, pc2, uv1, uv2, 1.0 / sig1, 1.0 / sig2, (inl_r & pair_ok) | sb_new,
        cam.fx, cam.fy, cam.cx, cam.cy)

    # corrected pose of the current keyframe: T1_corr = T12 * T2
    T1_corr = lie.orthonormalize(T12b @ T2)

    # the candidate's neighbourhood's points through the corrected pose
    # (the >= 40 gate)
    nb_cand = ((m.covis[cd] > 0) & m.kf_valid) | (ids == cd)
    rows_on = nb_cand[:, None] & (m.kf_mp >= 0)
    loop_pts = scatter_or(P, torch.where(rows_on, m.kf_mp, P - 1), rows_on) & m.pt_valid
    proj, proj_ok = _project_points(m, loop_pts, T1_corr, cam, scale_factors)
    total = (_sim3_projection_match(m, proj, proj_ok, kf, scale_factors, 7.5) >= 0).sum(
        dtype=torch.int32)
    # the >= 10 keyframe gap checked here again, as the JAX package does
    # (there detection for the next keyframe may run before this close)
    gap_ok = m.kf_seq[kf] >= ls.last_loop_seq + MIN_KF_GAP
    accept = gen_ok & gap_ok & (res.count >= 20) & (n_ransac >= 20) & (n_ref >= 20) & (total >= 40)
    group = ((m.covis[kf] > 0) & m.kf_valid) | (ids == kf)
    gates = dict(accept=accept, gen_ok=gen_ok, gap_ok=gap_ok, n_bow=res.count,
                 n_ransac=n_ransac, n_ref=n_ref, total=total,
                 live1=live1.sum(dtype=torch.int32), live2=live2.sum(dtype=torch.int32),
                 cand_seq=m.kf_seq[cd], kf_seq=m.kf_seq[kf])
    return gates, dict(T1=T1, T1_corr=T1_corr, nb_cand=nb_cand, loop_pts=loop_pts, group=group)


def _correct(m: MapState, kf: int, cd: int, group_ids: Sequence[int], c, caps: MapCaps,
             cam: Camera, scale_factors: torch.Tensor) -> MapState:
    """correctLoop (loopClosing.cpp:350-492) after an accepted Sim3."""
    K = caps.max_kf
    ids = torch.arange(K, device=m.device)
    pre_pose = m.kf_pose  # the essential graph's measurements
    group = c["group"]
    # the current covisible group takes the correction:
    # T_i_corr = (T_i * T1^-1) * T1_corr
    T_i_c = torch.einsum("kij,jl->kil", m.kf_pose, lie.se3_inverse(c["T1"]))
    T_corr_all = torch.einsum("kij,jl->kil", T_i_c, c["T1_corr"])
    new_poses = torch.where(group[:, None, None], lie.orthonormalize(T_corr_all), m.kf_pose)
    m = m.replace(kf_pose=new_poses)

    # the group's points follow their reference keyframe: p' = T_new^-1 T_old p
    ref = m.pt_ref_kf.clamp(min=0).long()
    m = m.replace(pt_pos=torch.where((group[ref] & m.pt_valid)[:, None],
                                     _move_points(m.pt_pos, pre_pose[ref], new_poses[ref]),
                                     m.pt_pos))

    # fuse the loop points into the corrected group (searchAndFuse :496-516)
    for g in group_ids:
        m = fuse.fuse_into_keyframe(m, g, c["loop_pts"], caps, cam, scale_factors, threshold=4.0)

    # essential graph: parents, strong covisibles, old loop edges, the new edge
    par_ok = (m.parent >= 0) & m.kf_valid
    edge_mask = scatter_or(K * K, ids * K + m.parent.clamp(min=0), par_ok).reshape(K, K)
    edge_mask = edge_mask | edge_mask.T
    edge_mask = edge_mask | ((m.covis >= 100) & m.kf_valid[:, None] & m.kf_valid[None, :])
    new_edge = (((ids[:, None] == kf) & (ids[None, :] == cd))
                | ((ids[:, None] == cd) & (ids[None, :] == kf)))
    edge_mask = edge_mask | m.loop_edges | new_edge

    # measurements S_i S_j^-1 from the pre-correction poses for every edge
    # that existed (they carry the drift, optimizer_ceres.cpp:1141-1236 uses
    # NonCorrectedSim3); the new loop connections (corrected group <->
    # candidate neighbourhood, loopClosing.cpp:461-479) take the corrected
    # relative. Within the group pre and post relatives are the same.
    post = m.kf_pose
    nb_cand = c["nb_cand"]
    use_post = (group[:, None] & nb_cand[None, :]) | (nb_cand[:, None] & group[None, :])
    meas_pre = torch.einsum("iab,jbc->ijac", pre_pose, lie.se3_inverse(pre_pose))
    meas_post = torch.einsum("iab,jbc->ijac", post, lie.se3_inverse(post))
    meas = torch.where(use_post[:, :, None, None], meas_post, meas_pre)
    s_opt, R_opt, t_opt = pose_graph.solve_pose_graph(
        torch.ones((K,), device=m.device), post[:, :3, :3], post[:, :3, 3], m.kf_valid,
        edge_mask, torch.ones((K, K), device=m.device), meas[:, :, :3, :3], meas[:, :, :3, 3],
        cd, iters=20)
    pg_pose = lie.rt_to_mat(R_opt, t_opt / torch.clamp(s_opt, min=1e-9)[:, None])
    pg_pose = torch.where(m.kf_valid[:, None, None], pg_pose, m.kf_pose)

    # every point follows its reference keyframe (optimizer_ceres.cpp:1281-1301)
    refp = m.pt_ref_kf.clamp(min=0).long()
    p2 = _move_points(m.pt_pos, post[refp], pg_pose[refp])
    return m.replace(kf_pose=pg_pose, pt_pos=torch.where(m.pt_valid[:, None], p2, m.pt_pos),
                     loop_edges=m.loop_edges | new_edge)


def _move_points(pos, T_old, T_new):
    """Points [P,3] seen from T_old [P,4,4] put where T_new sees them."""
    p_cam = torch.einsum("pij,pj->pi", T_old[:, :3, :3], pos) + T_old[:, :3, 3]
    T_inv = lie.se3_inverse(T_new)
    return torch.einsum("pij,pj->pi", T_inv[:, :3, :3], p_cam) + T_inv[:, :3, 3]


_GATE_KEYS = ("accept", "gen_ok", "gap_ok", "n_bow", "n_ransac", "n_ref", "total", "live1",
              "live2", "cand_seq", "kf_seq")


def _close_one(m: MapState, ls: LoopState, kf: int, cd: int, gen_ok: torch.Tensor,
               caps: MapCaps, cam: Camera, scale_factors: torch.Tensor,
               groups_curr: torch.Tensor, groups_cand: torch.Tensor
               ) -> Tuple[MapState, LoopState, bool, Dict[str, int]]:
    """One candidate's Sim3 verification and, on accept, the loop correction:
    the body of the reference's computeSim3 iteration (loopClosing.cpp:
    178-348) and correctLoop. One host read: the gate values with the ids of
    the group the correction would fuse into -> (map, loop state, accepted,
    the gate values as ints)."""
    gates, c = _gates_and_group(m, ls, kf, cd, gen_ok, caps, cam, scale_factors,
                                groups_curr, groups_cand)
    group_ids = compact_ids(c["group"], GROUP_FUSE)
    vals = torch.cat([torch.stack([gates[k].to(torch.int64) for k in _GATE_KEYS]),
                      group_ids.to(torch.int64)]).tolist()
    dg = dict(zip(_GATE_KEYS, vals))
    accept = bool(dg.pop("accept"))
    if accept:
        m = _correct(m, kf, cd, [g for g in vals[len(_GATE_KEYS):] if g >= 0], c, caps, cam,
                     scale_factors)
        ls = ls.replace(last_loop_seq=m.kf_seq[kf].clone())
    return m, ls, accept, dg


def close_step(m: MapState, ls: LoopState, kf_id: int, cand_kf: int, caps: MapCaps, cam: Camera,
               scale_factors: torch.Tensor, voc_groups_curr: torch.Tensor,
               voc_groups_cand: torch.Tensor, kf_gen_expect=None, cand_gen_expect=None,
               diag: bool = False):
    """Sim3 verification and loop correction for one candidate -> (map, loop
    state, accepted) and, with ``diag``, the gate values (n_bow / n_ransac /
    n_ref / total against the 20 / 20 / 20 / 40 gates). The generation
    guards reject a candidate whose slot was culled and recycled since its
    detection."""
    kf, cd = max(int(kf_id), 0), max(int(cand_kf), 0)
    gen_ok = m.kf_valid[kf] & m.kf_valid[cd]
    if kf_gen_expect is not None:
        gen_ok = gen_ok & (m.kf_gen[kf] == kf_gen_expect)
    if cand_gen_expect is not None:
        gen_ok = gen_ok & (m.kf_gen[cd] == cand_gen_expect)
    m, ls, accept, dg = _close_one(m, ls, kf, cd, gen_ok, caps, cam, scale_factors,
                                   voc_groups_curr, voc_groups_cand)
    return (m, ls, accept, dg) if diag else (m, ls, accept)


def _close_multi(m: MapState, ls: LoopState, kf: int, kf_ok: torch.Tensor,
                 cand_kfs: Sequence[int], cand_gens: Sequence[int], group_div: int,
                 caps: MapCaps, cam: Camera, scale_factors: torch.Tensor
                 ) -> Tuple[MapState, LoopState, bool, int, List[Tuple[int, bool, Dict[str, int]]]]:
    """Try the confirmed candidates of one keyframe in order until a Sim3
    verification succeeds: the reference's computeSim3 candidate loop
    (loopClosing.cpp:178-348) -> (map, loop state, accepted, the winning
    candidate or -1, every attempt as (candidate, accepted, gate values))."""
    def groups(k):
        words = m.kf_word[k]
        return torch.where(words >= 0, torch.div(words, group_div, rounding_mode="floor"), -1)

    g_curr = groups(kf)
    attempts = []
    for cand, gen in zip(cand_kfs, cand_gens):
        if cand < 0:
            continue
        gen_ok = kf_ok & m.kf_valid[cand] & (m.kf_gen[cand] == gen)
        m, ls, accept, dg = _close_one(m, ls, kf, cand, gen_ok, caps, cam, scale_factors,
                                       g_curr, groups(cand))
        attempts.append((cand, accept, dg))
        if accept:
            return m, ls, True, cand, attempts
    return m, ls, False, -1, attempts


def close_step_multi(m: MapState, ls: LoopState, kf_id: int, kf_gen_expect: int,
                     cand_kfs, cand_gens, group_div: int, caps: MapCaps, cam: Camera,
                     scale_factors: torch.Tensor):
    """``_close_multi`` behind the keyframe's generation guard -> (map, loop
    state, accepted, the winning candidate or -1)."""
    kf = max(int(kf_id), 0)
    kf_ok = m.kf_valid[kf] & (m.kf_gen[kf] == kf_gen_expect)
    m, ls, done, which, _ = _close_multi(
        m, ls, kf, kf_ok, torch.as_tensor(cand_kfs).tolist(), torch.as_tensor(cand_gens).tolist(),
        group_div, caps, cam, scale_factors)
    return m, ls, done, which


def _search_by_sim3(m, kf, cd, T12, s12, pc1, pc2, live1, live2, cam, scale_factors,
                    radius: float = 7.5):
    """Matcher::searchBySim3 (matcher.cpp:679-865): each side's points
    projected into the other keyframe through the Sim3 estimate, a window
    search by Hamming distance (TH_HIGH) and the pairs both directions agree
    on -> (cand keypoint per kf keypoint [N] i32 (-1 none), ok [N])."""
    N = live1.shape[0]
    R12, t12 = T12[:3, :3], T12[:3, 3]

    def window_match(uv_pred, pred_lvl, valid_src, src_desc, tgt_kf):
        kp_uv, kp_oct, kp_ok = m.kf_uv_und[tgt_kf], m.kf_octave[tgt_kf], m.kf_kp_valid[tgt_kf]
        r = radius * scale_factors[pred_lvl.long()]
        du = torch.abs(kp_uv[None, :, 0] - uv_pred[:, 0:1])
        dv = torch.abs(kp_uv[None, :, 1] - uv_pred[:, 1:2])
        window = (du < r[:, None]) & (dv < r[:, None])
        oct_ok = ((kp_oct[None, :] >= (pred_lvl - 1)[:, None])
                  & (kp_oct[None, :] <= pred_lvl[:, None]))
        allowed = window & oct_ok & valid_src[:, None] & kp_ok[None, :]
        D = torch.where(allowed, hamming.distance_matrix(src_desc, m.kf_desc[tgt_kf]), BIG)
        best = torch.argmin(D, dim=1)  # the first minimum, as jnp.argmin
        best_d = torch.gather(D, 1, best[:, None])[:, 0]
        return torch.where(best_d <= 100, best.to(torch.int32), -1)

    # forward: kf's points into cd's image through S21; the scale predicted
    # from the observing octave (the reference's distance band; the observing
    # octave is the fixed-shape stand-in)
    p2_pred = ((pc1 - t12) @ R12) / torch.clamp(s12, min=1e-9)
    uv2_pred = cam.camera2pixel(p2_pred)
    in2 = (p2_pred[:, 2] > 0) & cam.in_image(uv2_pred)
    m12 = window_match(uv2_pred, m.kf_octave[kf], live1 & in2, m.kf_desc[kf], cd)

    # backward: cd's points into kf's image through S12
    p1_pred = s12 * pc2 @ R12.T + t12
    uv1_pred = cam.camera2pixel(p1_pred)
    in1 = (p1_pred[:, 2] > 0) & cam.in_image(uv1_pred)
    m21 = window_match(uv1_pred, m.kf_octave[cd], live2 & in1, m.kf_desc[cd], kf)

    # bidirectional agreement (matcher.cpp:833-860)
    agree = (m12 >= 0) & (m21[m12.clamp(min=0).long()]
                          == torch.arange(N, dtype=torch.int32, device=m12.device))
    return torch.where(agree, m12, -1), agree


def _project_points(m, mask, T, cam, scale_factors):
    """Masked points through T with the frustum and distance gates ->
    ((u, v, predicted level), valid)."""
    R, t = T[:3, :3], T[:3, 3]
    pc = m.pt_pos @ R.T + t
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[:, 0] / safe_z + cam.cx
    v = cam.fy * pc[:, 1] / safe_z + cam.cy
    dist = norm3(m.pt_pos - (-R.T @ t))
    ok = (mask & (z > 0) & (u >= 0) & (u <= cam.width) & (v >= 0) & (v <= cam.height)
          # 0.8/1.2 invariance slack (mappoint.cpp:391-401)
          & (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist))
    ratio = m.pt_max_dist / torch.clamp(dist, min=1e-9)
    pred = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-9))
                                  / torch.log(scale_factors[1])).to(torch.int32),
                       0, scale_factors.shape[0] - 1)
    return (u, v, pred), ok


def _sim3_projection_match(m, proj, valid, kf, scale_factors, radius):
    """Hamming match of the projected loop points against kf's keypoints
    (matcher.cpp:356-447, searchByProjection with the Sim3-corrected pose)
    -> matched keypoint per compacted point [MAX_FUSE] (-1 none)."""
    u, v, pred = proj
    ids = compact_ids(valid, fuse.MAX_FUSE)
    ok = ids >= 0
    sid = ids.clamp(min=0).long()
    c_u, c_v, c_pred = u[sid], v[sid], pred[sid]
    r_scale = radius * scale_factors[c_pred.long()]
    kp_uv, kp_oct, kp_ok = m.kf_uv_und[kf], m.kf_octave[kf], m.kf_kp_valid[kf]
    du = torch.abs(kp_uv[None, :, 0] - c_u[:, None])
    dv = torch.abs(kp_uv[None, :, 1] - c_v[:, None])
    window = (du < r_scale[:, None]) & (dv < r_scale[:, None])
    oct_ok = (kp_oct[None, :] >= (c_pred - 1)[:, None]) & (kp_oct[None, :] <= (c_pred + 1)[:, None])
    allowed = window & oct_ok & ok[:, None] & kp_ok[None, :]
    D = torch.where(allowed, hamming.distance_matrix(m.pt_desc[sid], m.kf_desc[kf]), BIG)
    best = torch.argmin(D, dim=1)
    best_d = torch.gather(D, 1, best[:, None])[:, 0]
    return torch.where(best_d <= 100, best.to(torch.int32), -1)
