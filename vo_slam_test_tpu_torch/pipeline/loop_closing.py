"""Loop closing: detection, Sim3 verification, correction, essential graph
(port of ``vo_slam_test_tpu/pipeline/loop_closing.py``).

The reference's LoopClosing thread (loopClosing.cpp):

- ``detect_step``: BoW scores of the new keyframe against the whole map, the
  minimum-covisible-score gate (:68-83), Map::detectLoopCandidates and the
  consistency groups over consecutive detections (:95-174), kept as
  fixed-shape group masks;
- ``close_detected`` / ``_close_multi`` (``close_step`` for one candidate):
  keyframe-to-keyframe BoW matching, the
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

Host reads: the JAX package branches on device scalars with ``lax.cond``,
and so does this module, through ``utils.graphs.cond``: detection, the close
on the best confirmed candidate, each Sim3 slot on ``cand >= 0``, the
correction on the accept and each of its ``GROUP_FUSE`` loop-fuse slots; its
loops are ``utils.graphs`` loops, as the JAX package's: the ``MAX_CANDS``
slots a ``scan`` with an early exit, the loop fuse a ``fori_loop``, each LM
pass a ``while_capped``. In a step program nothing is read back and the
outcome stays on the device (``CloseOut``); eager, each cond and each loop's
exit test reads its predicate (the candidates are read once).

Deviation (the JAX package's DEVIATIONS.md D1): the reference runs 5 RANSAC
iterations per candidate per loop round; the batched solver evaluates 128
hypotheses once per confirmed candidate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import lie
from ..bow import retrieval as bow_ret
from ..camera import Camera
from ..matching import bow_match
from ..ops import hamming
from ..slam_map import fuse
from ..slam_map.insert import norm3, row_at
from ..slam_map.map_state import (MapCaps, MapState, compact_ids, first_true, pick,
                                  scatter_or, scatter_set)
from ..solvers import pose_graph, sim3
from ..utils import graphs, prng

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


def detect_step(m: MapState, ls: LoopState, did_kf, kf_id, caps: MapCaps
                ) -> Tuple[LoopState, torch.Tensor, torch.Tensor]:
    """-> (new loop state, confirmed candidate keyframe ids [MAX_CANDS] best
    score first, -1 padded, their kf_gen at detection time). All on the
    device. ``did_kf``/``kf_id`` are host values (eager) or device values (a
    step program): detection runs under a ``graphs.cond`` on ``did_kf &
    (kf_id >= 0)`` (the JAX package's ``lax.cond``), and a frame without a new
    keyframe returns the state unchanged."""
    dev = m.device
    pad = torch.full((MAX_CANDS,), -1, dtype=torch.int32, device=dev)

    def detect(ls):
        kf = graphs.on_device(graphs.where(kf_id >= 0, kf_id, 0), torch.int64, dev)
        K = caps.max_kf
        scores, shared = bow_ret.scores_vs_keyframes(
            pick(m.kf_bow_word, kf), pick(m.kf_bow_weight, kf), m.kf_bow_word, m.kf_bow_weight,
            m.kf_valid.to(torch.float32))
        covis_kfs = (pick(m.covis, kf) > 0) & m.kf_valid
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
        gap_ok = pick(m.kf_seq, kf) >= ls.last_loop_seq + MIN_KF_GAP
        conf_mask = top_ok & (new_counts >= CONSISTENCY) & gap_ok
        # every enough-consistent candidate, best score first: the reference's
        # computeSim3 tries each until one verifies (loopClosing.cpp:178-348)
        top_ids = top_ids.to(torch.int32)
        out_cands = torch.where(conf_mask, top_ids, -1)
        out_gens = torch.where(conf_mask, m.kf_gen[top_ids.long()], -1)
        return ls.replace(groups=groups, counts=counts, n_groups=n_groups), out_cands, out_gens

    return graphs.cond(did_kf & (kf_id >= 0), detect, lambda ls: (ls, pad, pad), (ls,),
                       name="detect")


def _gates_and_group(m, ls, kf, cd, gen_ok, caps, cam, scale_factors, groups_curr, groups_cand):
    """The Sim3 verification of candidate ``cd`` for keyframe ``kf`` (Python
    ints, or 0-d device tensors in a step program) on the device -> (the gate
    values [11] i32 in ``GATE_KEYS`` order, what the correction needs)."""
    K, P = caps.max_kf, caps.max_pt
    ids = torch.arange(K, device=m.device)
    row1, row2 = row_at(m.kf_mp, kf), row_at(m.kf_mp, cd)
    live1 = (row1 >= 0) & m.pt_valid[row1.clamp(min=0).long()]
    live2 = (row2 >= 0) & m.pt_valid[row2.clamp(min=0).long()]
    oct1, oct2 = row_at(m.kf_octave, kf), row_at(m.kf_octave, cd)

    # keyframe-to-keyframe BoW matching (matcher.cpp:561-677, ratio 0.75):
    # per keypoint of kf, the matched point of cd
    res = bow_match.search_by_bow_kf_frame(
        kf_desc=row_at(m.kf_desc, cd), kf_groups=groups_cand, kf_mp=row2,
        kf_angle=row_at(m.kf_angle, cd), kf_pt_valid=live2, f_desc=row_at(m.kf_desc, kf),
        f_groups=groups_curr, f_angle=row_at(m.kf_angle, kf),
        f_valid=row_at(m.kf_kp_valid, kf) & live1, ratio=0.75)
    match2 = res.assign
    pair_ok = (match2 >= 0) & live1

    # camera-frame coordinates of the matched point pairs
    T1, T2 = row_at(m.kf_pose, kf), row_at(m.kf_pose, cd)
    pc1 = m.pt_pos[row1.clamp(min=0).long()] @ T1[:3, :3].T + T1[:3, 3]
    uv1 = cam.camera2pixel(pc1)
    sig1 = scale_factors[oct1.long()] ** 2

    def side2(pt_ids, kp_ids):
        pc = m.pt_pos[pt_ids.clamp(min=0).long()] @ T2[:3, :3].T + T2[:3, 3]
        sig = scale_factors[oct2[kp_ids.clamp(min=0).long()].long()] ** 2
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
    nb_cand = ((row_at(m.covis, cd) > 0) & m.kf_valid) | (ids == cd)
    rows_on = nb_cand[:, None] & (m.kf_mp >= 0)
    loop_pts = scatter_or(P, torch.where(rows_on, m.kf_mp, P - 1), rows_on) & m.pt_valid
    proj, proj_ok = _project_points(m, loop_pts, T1_corr, cam, scale_factors)
    total = (_sim3_projection_match(m, proj, proj_ok, kf, scale_factors, 7.5) >= 0).sum(
        dtype=torch.int32)
    # the >= 10 keyframe gap checked here again, as the JAX package does
    # (there detection for the next keyframe may run before this close)
    seq_kf, seq_cd = row_at(m.kf_seq, kf), row_at(m.kf_seq, cd)
    gap_ok = seq_kf >= ls.last_loop_seq + MIN_KF_GAP
    accept = gen_ok & gap_ok & (res.count >= 20) & (n_ransac >= 20) & (n_ref >= 20) & (total >= 40)
    group = ((row_at(m.covis, kf) > 0) & m.kf_valid) | (ids == kf)
    gates = torch.stack([x.to(torch.int32) for x in (
        accept, gen_ok, gap_ok, res.count, n_ransac, n_ref, total,
        live1.sum(dtype=torch.int32), live2.sum(dtype=torch.int32), seq_cd, seq_kf)])
    return gates, dict(T1=T1, T1_corr=T1_corr, nb_cand=nb_cand, loop_pts=loop_pts, group=group)


def _correct(m: MapState, kf, cd, c, caps: MapCaps, cam: Camera,
             scale_factors: torch.Tensor) -> MapState:
    """correctLoop (loopClosing.cpp:350-492) after an accepted Sim3; ``kf``
    and ``cd`` Python ints or 0-d device tensors."""
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

    # fuse the loop points into the corrected group (searchAndFuse :496-516):
    # a fori_loop over GROUP_FUSE slots, each under a cond on its keyframe id
    # (the JAX package's fori_loop of conds)
    group_ids = compact_ids(group, GROUP_FUSE)

    def fuse_slot(i, m):
        g = pick(group_ids, i)
        return graphs.cond(g >= 0, lambda m: fuse.fuse_into_keyframe(
            m, torch.clamp(g, min=0), c["loop_pts"], caps, cam, scale_factors, threshold=4.0),
            lambda m: m, (m,))

    m = graphs.fori_loop(0, GROUP_FUSE, fuse_slot, m)

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


GATE_KEYS = ("accept", "gen_ok", "gap_ok", "n_bow", "n_ransac", "n_ref", "total", "live1",
             "live2", "cand_seq", "kf_seq")


def _apply(m: MapState, ls: LoopState, kf, cd, accept, c, caps: MapCaps, cam: Camera,
           scale_factors: torch.Tensor) -> Tuple[MapState, LoopState]:
    """The correction under a cond on ``accept`` (the JAX package's
    ``lax.cond(accept, do_correct, ...)``), and the loop keyframe's insertion
    number recorded when it ran."""
    m = graphs.cond(accept, lambda m: _correct(m, kf, cd, c, caps, cam, scale_factors),
                    lambda m: m, (m,))
    return m, ls.replace(last_loop_seq=graphs.where(accept, row_at(m.kf_seq, kf).clone(),
                                                    ls.last_loop_seq))


@dataclasses.dataclass
class CloseOut:
    """A keyframe's close on the device: every slot of the candidate scan
    (``MAX_CANDS``, best score first) and its outcome."""

    closed: torch.Tensor    # bool: a Sim3 verification succeeded and corrected the map
    which: torch.Tensor     # i32: the winning candidate keyframe (-1 none)
    tried: torch.Tensor     # [C] bool: the slot ran its verification
    accepted: torch.Tensor  # [C] bool: the slot's verification passed every gate
    gates: torch.Tensor     # [C, 11] i32: the slot's gate values, GATE_KEYS (0 untried)

    @staticmethod
    def none(device, n: int = MAX_CANDS) -> "CloseOut":
        """The outcome of a frame whose detection confirmed nothing."""
        false = torch.zeros((n,), dtype=torch.bool, device=device)
        return CloseOut(closed=false[0], which=torch.full((), -1, dtype=torch.int32, device=device),
                        tried=false, accepted=false,
                        gates=torch.zeros((n, len(GATE_KEYS)), dtype=torch.int32, device=device))

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return self.closed, self.which, self.tried, self.accepted, self.gates


def fold_attempts(cands, tried, accepted, gates) -> List[Tuple[int, bool, Dict[str, int]]]:
    """A close's slots on the host (``cands`` [C] ints, ``tried`` and
    ``accepted`` [C] bools, ``gates`` C * 11 ints, flat) -> (candidate,
    accepted, gate values without ``accept``) per slot that ran, in order."""
    n = len(GATE_KEYS)
    return [(c, bool(a), dict(zip(GATE_KEYS[1:], gates[n * i + 1:n * (i + 1)])))
            for i, (c, t, a) in enumerate(zip(cands, tried, accepted)) if t]


def close_step(m: MapState, ls: LoopState, kf_id: int, cand_kf: int, caps: MapCaps, cam: Camera,
               scale_factors: torch.Tensor, voc_groups_curr: torch.Tensor,
               voc_groups_cand: torch.Tensor, kf_gen_expect=None, cand_gen_expect=None,
               diag: bool = False):
    """Sim3 verification and loop correction for one candidate (eager: the
    ``VO_LOOP_DIAG`` path and the tests) -> (map, loop state, accepted) and,
    with ``diag``, the gate values (n_bow / n_ransac / n_ref / total against
    the 20 / 20 / 20 / 40 gates), read back at once. The generation guards
    reject a candidate whose slot was culled and recycled since its
    detection."""
    kf, cd = max(int(kf_id), 0), max(int(cand_kf), 0)
    gen_ok = m.kf_valid[kf] & m.kf_valid[cd]
    if kf_gen_expect is not None:
        gen_ok = gen_ok & (m.kf_gen[kf] == kf_gen_expect)
    if cand_gen_expect is not None:
        gen_ok = gen_ok & (m.kf_gen[cd] == cand_gen_expect)
    gates, c = _gates_and_group(m, ls, kf, cd, gen_ok, caps, cam, scale_factors,
                                voc_groups_curr, voc_groups_cand)
    vals = graphs.fetch(gates)
    accept = bool(vals[0])
    m, ls = _apply(m, ls, kf, cd, accept, c, caps, cam, scale_factors)
    return (m, ls, accept, dict(zip(GATE_KEYS[1:], vals[1:]))) if diag else (m, ls, accept)


def _close_multi(m: MapState, ls: LoopState, kf, kf_ok: torch.Tensor, cand_kfs: torch.Tensor,
                 cand_gens: torch.Tensor, group_div: int, caps: MapCaps, cam: Camera,
                 scale_factors: torch.Tensor) -> Tuple[MapState, LoopState, CloseOut]:
    """Try the confirmed candidates of one keyframe in order until a Sim3
    verification succeeds, then correct: the reference's computeSim3
    candidate loop (loopClosing.cpp:178-348) and correctLoop, the JAX
    package's ``lax.scan`` with an early-exit flag -> (map, loop state,
    CloseOut).

    ``kf`` is a Python int or a 0-d device tensor, ``cand_kfs`` [C] the
    candidates (-1 padded, on the device) and ``cand_gens`` [C] their kf_gen
    at detection. The slots are a ``graphs.scan`` whose early exit fires
    once an attempt is accepted or no candidate is left; slot i verifies
    under a ``graphs.cond`` on ``cand >= 0``, the winner's correction inputs
    are kept by selects, and one correction runs under a cond on the accept.
    This is the JAX package's scan exactly: a rejected attempt leaves the map
    and the loop state as they were, and nothing runs after an accept, so
    every verification sees the map before the close and at most one
    correction runs. Slots that never run keep ``CloseOut.none``'s values."""
    dev = m.device
    K, P, C = caps.max_kf, caps.max_pt, cand_gens.shape[0]
    cands = cand_kfs.to(torch.int32)

    def groups(k):
        words = row_at(m.kf_word, k)
        return torch.where(words >= 0, torch.div(words, group_div, rounding_mode="floor"), -1)

    g_curr = groups(kf)
    out = CloseOut.none(dev, C)
    eye = torch.eye(4, device=dev)
    no_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
    win = dict(T1=eye, T1_corr=eye, nb_cand=no_kf, loop_pts=torch.zeros((P,), dtype=torch.bool,
                                                                     device=dev),
               group=no_kf, cd=torch.zeros((), dtype=torch.int32, device=dev))
    # left[j]: a candidate at slot j or later (left[C] False)
    valid = (cands >= 0).to(torch.int32)
    left = torch.cat([torch.flip(torch.cumsum(torch.flip(valid, [0]), 0), [0]) > 0,
                      torch.zeros((1,), dtype=torch.bool, device=dev)])

    def slot(i, carry, x):
        done, which, _, win = carry
        cand, gen = x
        cd = torch.clamp(cand, min=0)

        def attempt():
            gen_ok = kf_ok & row_at(m.kf_valid, cd) & (row_at(m.kf_gen, cd) == gen)
            g, c = _gates_and_group(m, ls, kf, cd, gen_ok, caps, cam, scale_factors, g_curr,
                                    groups(cd))
            return g, dict(c, cd=cd)

        live = cand >= 0
        g, c = graphs.cond(live, attempt, lambda: (out.gates[0], win))
        acc = g[0] > 0  # an accept only where the slot ran, hence before any other
        win = {k: torch.where(acc, c[k], v) for k, v in win.items()}
        return ((done | acc, torch.where(acc, cd, which), pick(left, i + 1), win),
                (live, acc, g))

    (done, which, _, win), (tried, accepted, gates) = graphs.scan(
        slot, (out.closed, out.which, left[0], win), (cands, cand_gens),
        ys=(out.tried, out.accepted, out.gates), until=lambda c: c[0] | ~c[2])
    m, ls = _apply(m, ls, kf, win["cd"], done, win, caps, cam, scale_factors)
    return m, ls, CloseOut(closed=done, which=which, tried=tried, accepted=accepted, gates=gates)


def close_detected(m: MapState, ls: LoopState, go, kf_id, cand_kfs: torch.Tensor,
                   cand_gens: torch.Tensor, group_div: int, caps: MapCaps, cam: Camera,
                   scale_factors: torch.Tensor) -> Tuple[MapState, LoopState, Optional[CloseOut]]:
    """The close after a keyframe event's detection (``go``: the event
    happened), under a cond on its best confirmed candidate (the JAX
    package's ``lax.cond(cand[0] >= 0)``, ``_background_one``) -> (map, loop
    state, CloseOut). Eager (host ``go``/``kf_id``) the candidates are read
    back once, and a frame without a confirmed candidate returns None for
    the outcome. The close runs inside the span ``close_step``."""
    if not graphs.traced() and not graphs.host_bool(go):
        return m, ls, None
    cands = graphs.fetch(cand_kfs)
    if not graphs.traced() and cands[0] < 0:
        return m, ls, None
    kf = graphs.where(kf_id >= 0, kf_id, 0)
    none = CloseOut.none(m.device, cand_gens.shape[0])

    def close(m, ls):
        with graphs.span("close_step"):
            return _close_multi(m, ls, kf, row_at(m.kf_valid, kf), cand_kfs, cand_gens,
                                group_div, caps, cam, scale_factors)

    return graphs.cond(cands[0] >= 0, close, lambda m, ls: (m, ls, none), (m, ls), name="close")


def close_step_multi(m: MapState, ls: LoopState, kf_id: int, kf_gen_expect: int,
                     cand_kfs, cand_gens, group_div: int, caps: MapCaps, cam: Camera,
                     scale_factors: torch.Tensor):
    """``_close_multi`` behind the keyframe's generation guard (eager: the
    diagnostics' and the tests' entry) -> (map, loop state, accepted, the
    winning candidate or -1), read back at once."""
    kf = max(int(kf_id), 0)
    kf_ok = m.kf_valid[kf] & (m.kf_gen[kf] == kf_gen_expect)
    gens = torch.as_tensor(cand_gens, dtype=torch.int32).to(m.device)
    cands = torch.as_tensor(cand_kfs, dtype=torch.int32).to(m.device)
    m, ls, out = _close_multi(m, ls, kf, kf_ok, cands, gens, group_div, caps, cam,
                              scale_factors)
    done, which = graphs.fetch(out.closed, out.which)
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
        kp_uv, kp_oct = row_at(m.kf_uv_und, tgt_kf), row_at(m.kf_octave, tgt_kf)
        kp_ok = row_at(m.kf_kp_valid, tgt_kf)
        r = radius * scale_factors[pred_lvl.long()]
        du = torch.abs(kp_uv[None, :, 0] - uv_pred[:, 0:1])
        dv = torch.abs(kp_uv[None, :, 1] - uv_pred[:, 1:2])
        window = (du < r[:, None]) & (dv < r[:, None])
        oct_ok = ((kp_oct[None, :] >= (pred_lvl - 1)[:, None])
                  & (kp_oct[None, :] <= pred_lvl[:, None]))
        allowed = window & oct_ok & valid_src[:, None] & kp_ok[None, :]
        D = torch.where(allowed, hamming.distance_matrix(src_desc, row_at(m.kf_desc, tgt_kf)),
                        BIG)
        best = torch.argmin(D, dim=1)  # the first minimum, as jnp.argmin
        best_d = torch.gather(D, 1, best[:, None])[:, 0]
        return torch.where(best_d <= 100, best.to(torch.int32), -1)

    # forward: kf's points into cd's image through S21; the scale predicted
    # from the observing octave (the reference's distance band; the observing
    # octave is the fixed-shape stand-in)
    p2_pred = ((pc1 - t12) @ R12) / torch.clamp(s12, min=1e-9)
    uv2_pred = cam.camera2pixel(p2_pred)
    in2 = (p2_pred[:, 2] > 0) & cam.in_image(uv2_pred)
    m12 = window_match(uv2_pred, row_at(m.kf_octave, kf), live1 & in2, row_at(m.kf_desc, kf), cd)

    # backward: cd's points into kf's image through S12
    p1_pred = s12 * pc2 @ R12.T + t12
    uv1_pred = cam.camera2pixel(p1_pred)
    in1 = (p1_pred[:, 2] > 0) & cam.in_image(uv1_pred)
    m21 = window_match(uv1_pred, row_at(m.kf_octave, cd), live2 & in1, row_at(m.kf_desc, cd), kf)

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
    kp_uv, kp_oct, kp_ok = (row_at(m.kf_uv_und, kf), row_at(m.kf_octave, kf),
                            row_at(m.kf_kp_valid, kf))
    du = torch.abs(kp_uv[None, :, 0] - c_u[:, None])
    dv = torch.abs(kp_uv[None, :, 1] - c_v[:, None])
    window = (du < r_scale[:, None]) & (dv < r_scale[:, None])
    oct_ok = (kp_oct[None, :] >= (c_pred - 1)[:, None]) & (kp_oct[None, :] <= (c_pred + 1)[:, None])
    allowed = window & oct_ok & ok[:, None] & kp_ok[None, :]
    D = torch.where(allowed, hamming.distance_matrix(m.pt_desc[sid], row_at(m.kf_desc, kf)), BIG)
    best = torch.argmin(D, dim=1)
    best_d = torch.gather(D, 1, best[:, None])[:, 0]
    return torch.where(best_d <= 100, best.to(torch.int32), -1)
