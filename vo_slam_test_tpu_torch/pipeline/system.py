"""Tracking against the map and the local-mapping chain (port of
``vo_slam_test_tpu/pipeline/system.py``).

Each frame runs two steps, as the JAX package's ``SlamSystem.track`` does:

- ``_slam_step``: ORB extraction, the reference's fallback chain
  trackWithMotion (visualOdometry.cpp:225-255) -> trackReferenceKeyFrame (BoW
  against the reference keyframe, :257-277) -> relocalization (BoW candidate
  retrieval, RANSAC absolute pose and projection top-ups, :313-395), then
  trackLocalMap (:279-311), the keyframe policy (:397-461) and the keyframe
  insertion (:463-517). The two fallbacks need a vocabulary
  (``SlamSystem(vocabulary=...)``); without one only motion tracking runs;
- ``background_step``: the local-mapping chain ``_mapping_step`` in the
  reference's order (localMapping.cpp:16-66): map-point culling,
  triangulation, fuse, local BA, keyframe culling; then, with a vocabulary,
  the LoopClosing pass (``pipeline/loop_closing.py``): loop detection and,
  for a confirmed candidate, the Sim3 verification and loop correction,
  serially after detection, as the JAX package's ``_background_one`` runs
  them (loopClosing.cpp:17-37). ``enable_global_ba`` adds the upstream
  global BA after each accepted closure.

Relocalization follows the JAX package: by default the top ``RELOC_K``
candidates are evaluated and the one with the most observed inliers wins
(Horn 3D-3D when at least half its BoW matches carry depth, else EPnP), with
one top-up cascade on the winner; ``reloc_parity=True`` evaluates up to
``RELOC_PARITY_K`` candidates, always with EPnP and a cascade each, and takes
the first success in keyframe-insertion order (the reference's loop).

``SlamSystem(..., chunk=K)`` is the JAX package's throughput mode: frames are
buffered and each full chunk is tracked frame after frame (``track_chunk``)
before its keyframe events are mapped in order (``background_chunk``), so
mapping results reach tracking at chunk ends. Within a chunk an event's local
BA is skipped when a later frame of the chunk also made a keyframe
(``chunk_ba_stops``, the reference's interruptBA raised by a queued
keyframe). A partial chunk is tracked frame by frame at ``results()``.

With ``VO_LOOP_DIAG=1`` in the environment when a ``SlamSystem`` is made (the
JAX package's diagnostic switch), the background step only detects: the
confirmed candidates stay on the device, are packed per frame and copied to
the host every ``drain_chunk`` frames (and once more at ``results()``), and
each candidate's Sim3 verification and correction then runs from the host
(``close_step(..., diag=True)`` behind the keyframe's and the candidate's
generation guards) until one is accepted; ``loop_attempts`` then holds
(frame, candidate, accepted, gate values) per attempt. With ``drain_chunk``
> 1 a batch whose copy has not landed waits for a later drain. Either way
every attempt's gate values are kept in ``SlamSystem.loop_gates``.

Host reads per frame: the JAX package branches with ``lax.cond`` on device
scalars; here every branch that decides which kernels run is a host bool.
A tracked frame reads back the r=15 match count (the r=30 retry) and, in
``insert_keyframe``, the keyframe decision with its slot (one read). A
keyframe event adds the triangulation's neighbour gates (one read) and one
read per local-BA LM iteration (its exit test). Without a vocabulary a lost
frame's motion attempt runs and is discarded (``torch.where``). With one, the
frame first reads the motion gate, then ``a1.ok`` and, if it failed, the
reference-keyframe attempt's ``ok``; only then does the relocalization
attempt run, which reads its candidates, their solver choice and counts, and
the top-up cascade's gates. With loop closing on, a keyframe event reads its
confirmed loop candidates (one read) and each Sim3 attempt its gates (one).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import lie, resolve_device
from ..bow import retrieval as bow_ret
from ..bow import vocabulary as bow_voc
from ..camera import Camera
from ..config import SlamConfig
from ..frontend.extractor import extract_fused, upload
from ..frontend.frame import FrameFeatures
from ..matching import bow_match, matcher
from ..ops.pyramid import PyramidSpec
from ..slam_map import culling, fuse, local_map, triangulate
from ..slam_map import insert as map_insert
from ..slam_map.map_state import (MapCaps, MapState, empty_map, pick, scatter_or,
                                  winner_per_target)
from ..solvers import epnp, global_ba, local_ba, pose_only, ransac
from ..utils import prng
from . import loop_closing
from .tracking import TrackStats, _spawn_temp_points

RELOC_K = 3         # BoW relocalization candidates evaluated per lost frame
RELOC_PARITY_K = 8  # candidate cap in reloc parity mode (the reference iterates
                    # all candidates, visualOdometry.cpp:313-395), evaluated
                    # first-success in keyframe-insertion order
DRAIN_CHUNK = 8  # frames between loop-candidate readbacks on the VO_LOOP_DIAG path
DESC_ARCHIVE_CAP = 4096  # frames whose descriptors create_vocabulary may read


@dataclasses.dataclass
class SlamTrackState:
    frame_id: int               # host frame counter
    feats: FrameFeatures        # last frame features
    assign_real: torch.Tensor   # [N] i32 map point per last-frame kp (-1)
    assign_gen: torch.Tensor    # [N] i32 pt_gen at bind time
    T_cr: torch.Tensor          # [4,4] last frame pose relative to its ref KF
    ref_kf: torch.Tensor        # i32 ref keyframe of the last frame
    T_cl: torch.Tensor          # [4,4] motion model
    motion_valid: torch.Tensor  # bool
    initialized: bool           # host-known: False only before the first frame
    lost: torch.Tensor          # bool: state LOST (visualOdometry.h:18-22)
    last_kf_frame: int          # frame id of the last inserted KF
    last_was_kf: bool           # host-known: the insert decision is read back
    last_reloc_frame: int       # -10000 = never (no relocalization yet)


@dataclasses.dataclass
class SlamOut:
    T_c_w: torch.Tensor
    T_cr: torch.Tensor
    ref_kf: torch.Tensor
    ref_gen: torch.Tensor       # kf_gen of ref_kf at track time (slot reuse)
    ok: torch.Tensor
    n_features: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    made_kf: bool
    relocalized: torch.Tensor   # bool: the relocalization attempt tracked this frame
    kp_uv: torch.Tensor         # [N,2] raw pixel coords (HUD overlay)
    kp_state: torch.Tensor      # [N] i32: 0 untracked, 1 map-tracked, 2 VO-tracked
    # the relocalization attempt's winning candidate as (keyframe slot, BoW
    # matches, RANSAC inliers, observed inliers), when it had candidates
    reloc_winner: Optional[Tuple[int, int, int, int]] = None


class HudOut(NamedTuple):
    """One frame's HUD inputs on the host (``viz.drawer.save_hud_frames``)."""

    kp_uv: np.ndarray     # [N,2] f32 raw pixel coords
    kp_state: np.ndarray  # [N] i32: 0 untracked, 1 map-tracked, 2 VO-tracked
    ok: bool


@dataclasses.dataclass
class _Attempt:
    """Uniform result of a tracking attempt."""

    T: torch.Tensor          # [4,4]
    kp_pt: torch.Tensor      # [N] i32 map point per curr kp (inliers only)
    kp_temp: torch.Tensor    # [N] bool temp match (inlier)
    kp_pw: torch.Tensor      # [N,3] point position per kp
    n_match: torch.Tensor    # i32
    ok: torch.Tensor         # bool

    def where(self, cond: torch.Tensor, other: "_Attempt") -> "_Attempt":
        """Field-wise ``torch.where(cond, self, other)``."""
        return _Attempt(**{f.name: torch.where(cond, getattr(self, f.name), getattr(other, f.name))
                           for f in dataclasses.fields(self)})


def _observed(m: MapState, assign: torch.Tensor) -> torch.Tensor:
    return (assign >= 0) & (m.pt_obs_cnt[assign.clamp(min=0).long()] > 0)


def _solve_and_cull(m, feats, T_init, kp_pt, kp_temp, kp_pw, inv_level_sigma2, cam):
    """Pose-only solve + outlier culling + observed-inlier count."""
    has = (kp_pt >= 0) | kp_temp
    obs = pose_only.PoseObs(
        p_world=kp_pw, uv=feats.uv_und,
        u_right=torch.where(has, feats.u_right, -1.0),
        inv_sigma2=inv_level_sigma2[feats.octave.long()], valid=has,
    )
    T, inl, _ = pose_only.solve_pose_only(
        T_init, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, fast=True)
    kp_pt = torch.where(inl, kp_pt, -1)
    kp_temp = kp_temp & inl
    n_obs = _observed(m, kp_pt).sum(dtype=torch.int32)
    return T, kp_pt, kp_temp, n_obs


def _attempt_motion(state: SlamTrackState, m: MapState, feats: FrameFeatures, T_last, cam,
                    scale_factors, inv_level_sigma2) -> _Attempt:
    """trackWithMotion: project the last frame's map points (and temporary
    depth points) into the current frame, r=15 then r=30, and solve."""
    N = feats.valid.shape[0]
    safe_last = state.assign_real.clamp(min=0).long()
    real_last = ((state.assign_real >= 0) & m.pt_valid[safe_last]
                 & (m.pt_gen[safe_last] == state.assign_gen))
    temp_pw_all, temp_valid = _spawn_temp_points(state.feats, T_last, cam)
    temp_valid = temp_valid & ~real_last & (not state.last_was_kf)
    last_pw = torch.where(real_last[:, None], m.pt_pos[safe_last], temp_pw_all)
    last_has = real_last | temp_valid
    src_desc = torch.where(real_last[:, None], m.pt_desc[safe_last], state.feats.desc)
    T_pred = torch.where(state.motion_valid, state.T_cl @ T_last, T_last)

    def search(radius):
        return matcher.search_by_projection_frame(
            p_world=last_pw, src_desc=src_desc, src_octave=state.feats.octave,
            src_angle=state.feats.angle, src_valid=last_has,
            tgt_uv_und=feats.uv_und, tgt_u_right=feats.u_right,
            tgt_octave=feats.octave, tgt_angle=feats.angle, tgt_desc=feats.desc,
            tgt_valid=feats.valid, tgt_blocked=torch.zeros_like(feats.valid),
            T_c_w=T_pred, T_l_w=T_last, scale_factors=scale_factors,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, b=cam.b,
            width=float(cam.width), height=float(cam.height), radius=radius,
        )

    res = search(15.0)
    if int(res.count) < 20:  # host read: widen the window
        res = search(30.0)
    winner = winner_per_target(res.idx, N)
    has_m = winner >= 0
    w_safe = winner.clamp(min=0).long()
    kp_pt = torch.where(has_m, state.assign_real[w_safe], -1)
    kp_temp = has_m & (kp_pt < 0)
    kp_pw = last_pw[w_safe]
    T1, kp_pt, kp_temp, n_obs = _solve_and_cull(
        m, feats, T_pred, kp_pt, kp_temp, kp_pw, inv_level_sigma2, cam)
    ok = (res.count >= 20) & (n_obs >= 10)
    return _Attempt(T=T1, kp_pt=kp_pt, kp_temp=kp_temp, kp_pw=kp_pw, n_match=res.count, ok=ok)


def reloc_topup_cascade(topup1, topup2, T_in, kp_in, n_in):
    """The relocalization top-up gates, visualOdometry.cpp:352-384 (the
    caller's gate is n0 < 50):

      add1 <- searchByProjection(r=10, th=100); if n0 + add1 >= 50:
        n1 <- solvePoseOnly (the top-up's state adopted)
        if 30 < n1 < 50:
          add2 <- searchByProjection(r=3, th=60); if n1 + add2 >= 50:
            n2 <- solvePoseOnly (the second top-up adopted)
      anything else keeps the previous stage's state.

    topup1/topup2: (T, kp) -> (T', kp', n', add), the projection search and
    the pose-only solve after it (n' the observed inliers after the solve,
    add the new matches). Each gate is a host read, and the second top-up
    runs only when its gate passes. -> (T, kp, n) of the adopted stage."""
    T_a, kp_a, n_a, add1 = topup1(T_in, kp_in)
    reach_a, n_a_h = torch.stack([torch.as_tensor(n_in + add1), torch.as_tensor(n_a)]).tolist()
    if reach_a < 50:
        return T_in, kp_in, n_in
    if 30 < n_a_h < 50:
        T_b, kp_b, n_b, add2 = topup2(T_a, kp_a)
        if int(n_a + add2) >= 50:
            return T_b, kp_b, n_b
    return T_a, kp_a, n_a


def _attempt_ref(state: SlamTrackState, m: MapState, feats: FrameFeatures, groups_c, voc,
                 T_last, cam, inv_level_sigma2) -> _Attempt:
    """trackReferenceKeyFrame: BoW matches against the reference keyframe
    (ratio 0.7), solved from the last pose."""
    kf = state.ref_kf
    row = pick(m.kf_mp, kf)
    res = bow_match.search_by_bow_kf_frame(
        kf_desc=pick(m.kf_desc, kf), kf_groups=bow_voc.feature_groups(voc, pick(m.kf_word, kf)),
        kf_mp=row, kf_angle=pick(m.kf_angle, kf), kf_pt_valid=m.pt_valid[row.clamp(min=0).long()],
        f_desc=feats.desc, f_groups=groups_c, f_angle=feats.angle, f_valid=feats.valid, ratio=0.7)
    no_tmp = torch.zeros_like(feats.valid)
    kp_pw = m.pt_pos[res.assign.clamp(min=0).long()]
    T2, kp_pt, _, n_obs = _solve_and_cull(m, feats, T_last, res.assign, no_tmp, kp_pw,
                                          inv_level_sigma2, cam)
    ok = (res.count >= 15) & (n_obs >= 10)
    return _Attempt(T=T2, kp_pt=kp_pt, kp_temp=no_tmp, kp_pw=kp_pw, n_match=res.count, ok=ok)


def _attempt_reloc(m: MapState, feats: FrameFeatures, bow, voc, frame_id: int, reloc_parity: bool,
                   cam, scale_factors, inv_level_sigma2
                   ) -> Tuple[_Attempt, bool, Optional[Tuple[int, int, int, int]]]:
    """Relocalization (visualOdometry.cpp:313-395) -> (attempt, ok read back,
    the winner's (slot, n_bow, n_ransac, n_obs) or None without candidates).

    Candidates are read back once. With none, the slot ``top_k`` returns
    first is evaluated as the JAX package evaluates it (its BoW matches are
    the frame's match count and its solve the frame's pose), and the attempt
    fails. Candidate i of the BoW ranking draws its RANSAC hypotheses from
    seed frame_id * K + i, as the JAX package's do."""
    uniq_c, wgt_c, groups_c = bow
    N = feats.valid.shape[0]
    P = m.pt_valid.shape[0]
    no_tmp = torch.zeros_like(feats.valid)
    score, shared = bow_ret.scores_vs_keyframes(uniq_c, wgt_c, m.kf_bow_word, m.kf_bow_weight,
                                                m.kf_valid.to(torch.float32))
    cand = bow_ret.reloc_candidates(score, shared, m.covis, m.kf_valid)
    n_cand_k = RELOC_PARITY_K if reloc_parity else RELOC_K
    c_scores, c_kfs_all = prng.top_k(torch.where(cand, score, -torch.inf), n_cand_k)
    c_kfs = torch.where(torch.isfinite(c_scores), c_kfs_all, -1)
    kfs, ranked, seqs = torch.stack(
        [c_kfs, c_kfs_all, m.kf_seq[c_kfs_all].to(torch.int64)]).tolist()
    live = [i for i in range(n_cand_k) if kfs[i] >= 0]
    any_cand = bool(live)
    if not any_cand:
        # the JAX package's winner without a passing candidate: top-k slot 0
        kfs, live = ranked, [0]
    p_cam = cam.pixel2camera(feats.uv_und, torch.clamp(feats.depth, min=1e-3))
    inv_sig = inv_level_sigma2[feats.octave.long()]

    def topup(kf, row, pt_live, T_in, kp_in, radius, th):
        in_set = scatter_or(P, kp_in.clamp(min=0), kp_in >= 0)
        safe = row.clamp(min=0).long()
        res2 = matcher.search_by_projection_kf(
            p_world=m.pt_pos[safe], src_desc=m.pt_desc[safe], src_angle=m.kf_angle[kf],
            src_min_dist=0.8 * m.pt_min_dist[safe], src_max_dist=1.2 * m.pt_max_dist[safe],
            src_pt=row, src_valid=(row >= 0) & pt_live & ~in_set[safe],
            tgt_uv_und=feats.uv_und, tgt_angle=feats.angle, tgt_octave=feats.octave,
            tgt_desc=feats.desc, tgt_valid=feats.valid, tgt_blocked=kp_in >= 0,
            T_c_w=T_in, scale_factors=scale_factors, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            width=float(cam.width), height=float(cam.height), radius=radius, dist_threshold=th)
        winner = winner_per_target(res2.idx, N)
        add_pt = torch.where(winner >= 0, row[winner.clamp(min=0).long()], -1)
        kp_new = torch.where(kp_in >= 0, kp_in, add_pt)
        T_out, kp_out, _, n_out = _solve_and_cull(
            m, feats, T_in, kp_new, no_tmp, m.pt_pos[kp_new.clamp(min=0).long()],
            inv_level_sigma2, cam)
        return T_out, kp_out, n_out, res2.count

    def cascade(kf, row, pt_live, T3, kp3, n_obs):
        return reloc_topup_cascade(
            lambda T, kp: topup(kf, row, pt_live, T, kp, 10.0, 100.0),
            lambda T, kp: topup(kf, row, pt_live, T, kp, 3.0, 60.0), T3, kp3, n_obs)

    def bow_matches(i):
        row = m.kf_mp[kfs[i]]
        pt_live = m.pt_valid[row.clamp(min=0).long()]
        res = bow_match.search_by_bow_kf_frame(
            kf_desc=m.kf_desc[kfs[i]], kf_groups=bow_voc.feature_groups(voc, m.kf_word[kfs[i]]),
            kf_mp=row, kf_angle=m.kf_angle[kfs[i]], kf_pt_valid=pt_live, f_desc=feats.desc,
            f_groups=groups_c, f_angle=feats.angle, f_valid=feats.valid, ratio=0.75)
        return row, pt_live, res

    def solve(i, res, horn: bool):
        has = res.assign >= 0
        p_world = m.pt_pos[res.assign.clamp(min=0).long()]
        seed = frame_id * n_cand_k + i
        if horn:
            Tr, _, n_ransac = ransac.ransac_pose_3d3d(
                p_world, p_cam, feats.uv_und, has & (feats.depth > 0), has,
                cam.fx, cam.fy, cam.cx, cam.cy, seed)
        else:
            Tr, _, n_ransac = epnp.ransac_pnp(prng.prng_key(seed), p_world, feats.uv_und, has,
                                              inv_sig, cam)
        T3, kp3, _, n_obs = _solve_and_cull(m, feats, Tr, res.assign, no_tmp, p_world,
                                            inv_level_sigma2, cam)
        return T3, kp3, n_obs, n_ransac

    done = {}  # top-k index -> (T, kp, n_obs, n_bow, n_ransac) on the device
    if reloc_parity:
        # the reference's loop: always EPnP, a cascade per candidate, the
        # first success in keyframe-insertion order wins
        win = None
        for i in sorted(live, key=lambda j: seqs[j]):
            row, pt_live, res = bow_matches(i)
            T3, kp3, n_obs, n_ransac = solve(i, res, horn=False)
            n_bow_h, n_ransac_h, n_obs_h = torch.stack([res.count, n_ransac, n_obs]).tolist()
            if n_obs_h < 50:
                T3, kp3, n_obs = cascade(kfs[i], row, pt_live, T3, kp3, n_obs)
                n_obs_h = int(n_obs)
            done[i] = (T3, kp3, n_obs, res.count, n_ransac, (n_bow_h, n_ransac_h, n_obs_h))
            if n_bow_h >= 15 and n_ransac_h >= 10 and n_obs_h >= 50:
                win = i
                break
        win = live[0] if win is None else win  # none passed: the best-scoring
        T4, kp4, n_obs4, n_bow, n_ransac, (n_bow_h, n_ransac_h, n_obs_h) = done[win]
    else:
        # the top RELOC_K by score, Horn 3D-3D when half the matches carry
        # depth; the most observed inliers among the passing ones wins
        matches = {i: bow_matches(i) for i in live}
        has = {i: res.assign >= 0 for i, (_, _, res) in matches.items()}
        rich = torch.stack([2 * (has[i] & (feats.depth > 0)).sum() >= has[i].sum()
                            for i in live]).tolist()
        for i, horn in zip(live, rich):
            res = matches[i][2]
            T3, kp3, n_obs, n_ransac = solve(i, res, horn)
            done[i] = (T3, kp3, n_obs, res.count, n_ransac)
        counts = torch.stack([torch.stack([done[i][3], done[i][4], done[i][2]])
                              for i in live]).tolist()
        rank = [n_obs if (n_bow >= 15 and n_ransac >= 10) else -1
                for n_bow, n_ransac, n_obs in counts]
        j = rank.index(max(rank))  # the first maximum, as jnp.argmax
        win = live[j]
        T4, kp4, n_obs4, n_bow, n_ransac = done[win]
        n_bow_h, n_ransac_h, n_obs_h = counts[j]
        if n_obs_h < 50:  # one cascade, on the winner
            row, pt_live, _ = matches[win]
            T4, kp4, n_obs4 = cascade(kfs[win], row, pt_live, T4, kp4, n_obs4)
            n_obs_h = int(n_obs4)
    ok = (n_bow >= 15) & (n_ransac >= 10) & (n_obs4 >= 50) & any_cand
    att = _Attempt(T=T4, kp_pt=torch.where(ok, kp4, -1), kp_temp=no_tmp,
                   kp_pw=m.pt_pos[kp4.clamp(min=0).long()], n_match=n_bow, ok=ok)
    ok_h = any_cand and n_bow_h >= 15 and n_ransac_h >= 10 and n_obs_h >= 50
    return att, ok_h, (kfs[win], n_bow_h, n_ransac_h, n_obs_h) if any_cand else None


def _track_attempts_bow(state: SlamTrackState, m: MapState, feats: FrameFeatures, bow, voc,
                        reloc_parity: bool, T_last, cam, scale_factors, inv_level_sigma2):
    """The fallback chain with a vocabulary -> (attempt, relocalized on the
    host, the reloc winner or None). Motion tracking needs an armed motion
    model (visualOdometry.cpp:227-231); each fallback runs only after the
    host has read that the attempts before it failed."""
    frame_id = state.frame_id
    can_motion = ~state.lost & state.motion_valid
    lost_h, can_h = torch.stack([state.lost, can_motion]).tolist()
    if can_h and frame_id >= state.last_reloc_frame + 2:
        a1 = _attempt_motion(state, m, feats, T_last, cam, scale_factors, inv_level_sigma2)
        if bool(a1.ok):
            return a1, False, None
    if not lost_h:
        a2 = _attempt_ref(state, m, feats, bow[2], voc, T_last, cam, inv_level_sigma2)
        if bool(a2.ok):
            return a2, False, None
    return _attempt_reloc(m, feats, bow, voc, frame_id, reloc_parity, cam, scale_factors,
                          inv_level_sigma2)


def _slam_step(
    state: SlamTrackState,
    m: MapState,
    gray: torch.Tensor,
    depth_img: torch.Tensor,
    timestamp: float,
    cam: Camera,
    caps: MapCaps,
    spec: PyramidSpec,
    budgets,
    scale_factors: torch.Tensor,
    inv_level_sigma2: torch.Tensor,
    fast_hi: float,
    fast_lo: float,
    max_frame_gap: int,
    voc: Optional[bow_voc.Vocabulary] = None,
    reloc_parity: bool = False,
) -> Tuple[SlamTrackState, MapState, SlamOut, int]:
    """One frame of tracking with the map -> (state, map, out, new keyframe
    id or -1). ``voc``: the vocabulary; None runs motion tracking alone."""
    frame_id = state.frame_id
    dev = gray.device
    feats = extract_fused(gray, depth_img, cam, spec, budgets, fast_hi, fast_lo)
    n_feats = feats.valid.sum(dtype=torch.int32)
    N = caps.n_feat
    P = caps.max_pt
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    words_c = uniq_c = wgt_c = None
    if voc is not None:
        words_c = bow_voc.transform(voc, feats.desc, feats.valid)
        uniq_c, wgt_c = bow_ret.bow_vector(words_c, voc.idf)
        bow = (uniq_c, wgt_c, bow_voc.feature_groups(voc, words_c))

    def insert_kf(m, T, assign, do):
        already = _observed(m, assign)
        create = map_insert.spawn_mask_depth_sorted(feats, already, cam.th_depth)
        return map_insert.insert_keyframe(
            m, caps, feats, T, timestamp, frame_id, assign, create, cam, scale_factors,
            words_c, uniq_c, wgt_c, do=do)

    if not state.initialized:
        # the first frame initializes the map: identity pose, no bindings.
        # (The JAX package runs the tracking attempts here too; on the empty
        # map they find nothing and every count is 0.)
        no_pt = torch.full((N,), -1, dtype=torch.int32, device=dev)
        m, new_kf = insert_kf(m, eye, no_pt, True)
        made = new_kf >= 0
        ref_kf_out = torch.full((), max(new_kf, 0), dtype=torch.int32, device=dev)
        assign_out = m.kf_mp[max(new_kf, 0)] if made else no_pt
        false = torch.zeros((), dtype=torch.bool, device=dev)
        st = SlamTrackState(
            frame_id=frame_id + 1, feats=feats, assign_real=assign_out,
            assign_gen=torch.where(assign_out >= 0, m.pt_gen[assign_out.clamp(min=0).long()], -1),
            T_cr=eye @ lie.se3_inverse(m.kf_pose[max(new_kf, 0)]), ref_kf=ref_kf_out, T_cl=eye,
            motion_valid=false, initialized=True, lost=false,
            last_kf_frame=frame_id if made else state.last_kf_frame,
            last_was_kf=made, last_reloc_frame=state.last_reloc_frame,
        )
        out = SlamOut(
            T_c_w=eye, T_cr=st.T_cr, ref_kf=ref_kf_out, ref_gen=m.kf_gen[max(new_kf, 0)],
            ok=torch.ones((), dtype=torch.bool, device=dev), n_features=n_feats,
            n_matches=zero, n_inliers=zero, made_kf=made, relocalized=false,
            kp_uv=feats.uv, kp_state=torch.zeros((N,), dtype=torch.int32, device=dev),
        )
        return st, m, out, new_kf

    # ======================== TRACK ========================================
    T_last = state.T_cr @ pick(m.kf_pose, state.ref_kf)
    fail = _Attempt(T=T_last, kp_pt=torch.full((N,), -1, dtype=torch.int32, device=dev),
                    kp_temp=torch.zeros((N,), dtype=torch.bool, device=dev),
                    kp_pw=torch.zeros((N, 3), device=dev), n_match=zero,
                    ok=torch.zeros((), dtype=torch.bool, device=dev))
    reloc_winner = None
    if voc is None:
        # without a vocabulary there is no ref-KF or relocalization fallback,
        # and motion tracking is attempted from T_last directly; a lost
        # frame's attempt runs and is discarded (a select, not a host read)
        can_motion = ~state.lost & (frame_id >= state.last_reloc_frame + 2)
        a1 = _attempt_motion(state, m, feats, T_last, cam, scale_factors, inv_level_sigma2)
        att = a1.where(can_motion & a1.ok, fail)
        relocalized = fail.ok
        reloc_frame = state.last_reloc_frame
    else:
        att, reloc_h, reloc_winner = _track_attempts_bow(
            state, m, feats, bow, voc, reloc_parity, T_last, cam, scale_factors, inv_level_sigma2)
        relocalized = att.ok if reloc_h else fail.ok
        reloc_frame = frame_id if reloc_h else state.last_reloc_frame
    track_pre = att.ok
    kp_pw_cur = torch.where((att.kp_pt >= 0)[:, None], m.pt_pos[att.kp_pt.clamp(min=0).long()],
                            att.kp_pw)

    # ---------------- trackLocalMap -----------------------------------------
    member = scatter_or(P, att.kp_pt.clamp(min=0), att.kp_pt >= 0)
    local_kf, ref_kf = local_map.local_keyframe_mask(m, att.kp_pt)
    ref_kf = torch.where(torch.any(att.kp_pt >= 0), ref_kf, state.ref_kf)
    cand_pts = local_map.local_point_mask(m, local_kf) & ~member
    blocked = _observed(m, att.kp_pt)
    th_rad = 5.0 if frame_id < reloc_frame + 2 else 3.0
    lm = local_map.search_local_points(
        m, att.T, cand_pts, feats.uv_und, feats.u_right, feats.octave, feats.desc,
        feats.valid, blocked, scale_factors, th_rad, cam=cam)
    kp_pt2 = torch.where(lm.assign >= 0, lm.assign, att.kp_pt)
    kp_temp2 = att.kp_temp & (lm.assign < 0)
    kp_pw2 = torch.where((kp_pt2 >= 0)[:, None], m.pt_pos[kp_pt2.clamp(min=0).long()], kp_pw_cur)

    has2 = (kp_pt2 >= 0) | kp_temp2
    obs2 = pose_only.PoseObs(
        p_world=kp_pw2, uv=feats.uv_und,
        u_right=torch.where(has2, feats.u_right, -1.0),
        inv_sigma2=inv_level_sigma2[feats.octave.long()], valid=has2,
    )
    T2, inl2, _ = pose_only.solve_pose_only(
        att.T, obs2, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, fast=True)
    real2 = kp_pt2 >= 0
    inlier_real = real2 & inl2
    observed_inliers = (inlier_real & (m.pt_obs_cnt[kp_pt2.clamp(min=0).long()] > 0)).sum(
        dtype=torch.int32)
    gate = 50 if frame_id < reloc_frame + max_frame_gap else 30
    ok = track_pre & (observed_inliers >= gate)

    vis_pts = scatter_or(P, kp_pt2.clamp(min=0), real2) | lm.visible_mask
    found_pts = scatter_or(P, kp_pt2.clamp(min=0), inlier_real)
    m = m.replace(pt_visible=m.pt_visible + vis_pts.to(torch.int32),
                  pt_found=m.pt_found + found_pts.to(torch.int32))

    T_new = torch.where(ok, T2, att.T)
    assign_final = torch.where(inlier_real, kp_pt2, -1)

    # ---------------- keyframe policy ---------------------------------------
    kf_cnt = m.kf_valid.sum(dtype=torch.int32)
    min_obs = torch.where(kf_cnt <= 2, 2, 3)
    ref_row = pick(m.kf_mp, ref_kf)
    ref_obs = m.pt_obs_cnt[ref_row.clamp(min=0).long()]
    ref_matches = ((ref_row >= 0) & (ref_obs >= min_obs)).sum(dtype=torch.int32)
    ref_ratio = observed_inliers.to(torch.float32) / torch.clamp(ref_matches, min=1).to(torch.float32)
    ref_weak = (ref_ratio < 0.25) | (ref_matches < 100)

    close = (feats.depth > 0) & (feats.depth < cam.th_depth) & feats.valid
    total_cnt = close.sum(dtype=torch.int32)
    map_cnt = (close & _observed(m, assign_final)).sum(dtype=torch.int32)
    map_ratio = map_cnt.to(torch.float32) / (total_cnt.to(torch.float32) + 1e-5)
    map_threshold = torch.where(observed_inliers > 300, 0.20, 0.35)
    track_weak = map_ratio < 0.3
    ref_threshold = torch.where(kf_cnt < 2, 0.40, 0.75)
    track_verify = (ref_ratio < ref_threshold) | (map_ratio < map_threshold)
    need_kf = ok & (track_weak | ref_weak | track_verify)
    need_kf = need_kf & ~((frame_id < reloc_frame + max_frame_gap) & (kf_cnt > max_frame_gap))
    need_kf = need_kf & ((m.n_kf < caps.max_kf) | torch.any(~m.kf_valid))

    # the insert reads the decision back (one host read) and runs only then
    m, new_kf = insert_kf(m, T_new, assign_final, need_kf)
    made = new_kf >= 0
    if made:
        ref_kf_out = torch.full((), new_kf, dtype=torch.int32, device=dev)
        assign_out = m.kf_mp[new_kf]
    else:
        ref_kf_out, assign_out = ref_kf, assign_final

    T_cr = T_new @ lie.se3_inverse(pick(m.kf_pose, ref_kf_out))
    T_cl = torch.where(ok, T_new @ lie.se3_inverse(T_last), eye)
    st = SlamTrackState(
        frame_id=frame_id + 1, feats=feats, assign_real=assign_out,
        assign_gen=torch.where(assign_out >= 0, m.pt_gen[assign_out.clamp(min=0).long()], -1),
        T_cr=T_cr, ref_kf=ref_kf_out, T_cl=T_cl, motion_valid=ok, initialized=True, lost=~ok,
        last_kf_frame=frame_id if made else state.last_kf_frame,
        last_was_kf=made, last_reloc_frame=reloc_frame,
    )
    # HUD flags (drawer.cpp:430-459): map-tracked when the point has
    # observers, VO-tracked for fresh/temp points; only in state OK
    hud_observed = m.pt_obs_cnt[kp_pt2.clamp(min=0).long()] > 0
    hud_map = inlier_real & hud_observed
    hud_vo = (inlier_real & ~hud_observed) | (kp_temp2 & inl2)
    kp_state = torch.where(ok & feats.valid,
                           torch.where(hud_map, 1, torch.where(hud_vo, 2, 0)), 0).to(torch.int32)
    out = SlamOut(
        T_c_w=T_new, T_cr=T_cr, ref_kf=ref_kf_out, ref_gen=pick(m.kf_gen, ref_kf_out), ok=ok,
        n_features=n_feats, n_matches=att.n_match, n_inliers=observed_inliers, made_kf=made,
        relocalized=relocalized, kp_uv=feats.uv, kp_state=kp_state, reloc_winner=reloc_winner,
    )
    return st, m, out, new_kf


def _mapping_step(m: MapState, did_kf: bool, kf_id: int, caps: MapCaps, cam: Camera,
                  scale_factors: torch.Tensor, interrupt_ba: bool = False,
                  bow_group_div: int = 0) -> Tuple[MapState, int, int]:
    """The local-mapping chain for one new keyframe, in the order of
    LocalMapping::run (localMapping.cpp:16-66): cullingMapPoints ->
    createNewMapPoints -> searchInNeighbors (fuse) -> local BA ->
    cullingKeyFrames. ``bow_group_div``: the triangulation's featVec bucket
    divisor (0 without a vocabulary). Returns (map, BA iterations pass 1,
    pass 2)."""
    if not (did_kf and kf_id >= 0):
        return m, 0, 0
    m = culling.cull_map_points(m, kf_id, caps)
    m = triangulate.create_new_map_points(m, kf_id, caps, cam, scale_factors,
                                          bow_group_div=bow_group_div)
    m = fuse.search_in_neighbors(m, kf_id, caps, cam, scale_factors)
    m, n1, n2 = local_ba.local_bundle_adjust_iters(
        m, kf_id, caps, cam, 1.0 / (scale_factors * scale_factors), stop=interrupt_ba)
    m = culling.cull_keyframes(m, kf_id, caps, cam)
    return m, n1, n2


@dataclasses.dataclass
class BackgroundOut:
    """What one keyframe event's background work reports to the host."""

    ba_n1: int = 0          # local-BA LM iterations, pass 1
    ba_n2: int = 0          # pass 2
    attempted: bool = False  # detection confirmed a loop candidate
    closed: bool = False     # a Sim3 verification succeeded and corrected the map
    which: int = -1          # the winning candidate keyframe (-1 none)
    # (candidate, accepted, gate values) per Sim3 attempt
    attempts: List[Tuple[int, bool, dict]] = dataclasses.field(default_factory=list)
    # without the inline close: the detection's confirmed candidates [MAX_CANDS]
    # and their kf_gen at detection, on the device (-1 rows without an event)
    cands: Optional[torch.Tensor] = None
    cand_gens: Optional[torch.Tensor] = None


def background_step(m: MapState, loop_state: loop_closing.LoopState, did_kf: bool, kf_id: int,
                    interrupt_ba: bool, caps: MapCaps, cam: Camera, scale_factors: torch.Tensor,
                    with_loop: bool = False, bow_group_div: int = 0, inline_close: bool = True
                    ) -> Tuple[MapState, loop_closing.LoopState, BackgroundOut]:
    """The work the reference runs off the tracking thread, for one frame:
    the local-mapping chain, then (``with_loop``) loop detection and, for a
    confirmed candidate, the Sim3 verification and correction of every
    confirmed candidate in turn until one is accepted, serially after
    detection (the reference's LoopClosing thread order, loopClosing.cpp:
    17-37). The confirmed candidates are read back once per keyframe event.
    Without ``inline_close`` (the VO_LOOP_DIAG path) detection runs on every
    frame and its candidates stay on the device in ``cands``/``cand_gens``:
    nothing is read back and nothing is verified here."""
    m, n1, n2 = _mapping_step(m, did_kf, kf_id, caps, cam, scale_factors,
                              interrupt_ba=interrupt_ba, bow_group_div=bow_group_div)
    out = BackgroundOut(ba_n1=n1, ba_n2=n2)
    if with_loop and not inline_close:
        loop_state, out.cands, out.cand_gens = loop_closing.detect_step(
            m, loop_state, did_kf and kf_id >= 0, kf_id, caps)
    elif with_loop and did_kf and kf_id >= 0:
        loop_state, cand, cand_gen = loop_closing.detect_step(m, loop_state, did_kf, kf_id, caps)
        cands, gens = torch.stack([cand, cand_gen]).tolist()
        if cands[0] >= 0:
            m, loop_state, out.closed, out.which, out.attempts = loop_closing._close_multi(
                m, loop_state, kf_id, m.kf_valid[kf_id], cands, gens, bow_group_div, caps, cam,
                scale_factors)
            out.attempted = True
    return m, loop_state, out


def track_chunk(state: SlamTrackState, m: MapState, frames, cam: Camera, caps: MapCaps,
                spec: PyramidSpec, budgets, scale_factors: torch.Tensor,
                inv_level_sigma2: torch.Tensor, fast_hi: float, fast_lo: float,
                max_frame_gap: int, voc: Optional[bow_voc.Vocabulary] = None,
                reloc_parity: bool = False):
    """K frames ``(gray, depth, timestamp)`` of tracking in order (the JAX
    package's ``lax.scan`` over ``_slam_step``), without mapping in between
    -> (state, map, [SlamOut], [new keyframe id or -1], [the frame's
    FrameFeatures])."""
    outs, new_kfs, feats = [], [], []
    for gray, depth, ts in frames:
        state, m, out, new_kf = _slam_step(
            state, m, gray, depth, ts, cam, caps, spec, budgets, scale_factors,
            inv_level_sigma2, fast_hi, fast_lo, max_frame_gap, voc, reloc_parity)
        outs.append(out)
        new_kfs.append(new_kf)
        feats.append(state.feats)
    return state, m, outs, new_kfs, feats


def chunk_ba_stops(did_kf) -> torch.Tensor:
    """[K] bool: event k must skip its local BA because a later frame of the
    same chunk created a keyframe (the reference's interruptBA raised by a
    queued new keyframe, localMapping.cpp:538-541, read at the solver's entry,
    optimizer_ceres.cpp:594)."""
    d = torch.as_tensor(did_kf, dtype=torch.int32).reshape(-1)
    later_incl = torch.flip(torch.cumsum(torch.flip(d, [0]), 0), [0])  # KFs at index >= k
    return (later_incl - d) > 0


def background_chunk(m: MapState, loop_state: loop_closing.LoopState, did_kf: List[bool],
                     kf_id: List[int], interrupt_ba: bool, caps: MapCaps, cam: Camera,
                     scale_factors: torch.Tensor, with_loop: bool = False, bow_group_div: int = 0,
                     inline_close: bool = True
                     ) -> Tuple[MapState, loop_closing.LoopState, List[BackgroundOut]]:
    """``background_step`` for every frame of a tracked chunk, in creation
    order, with ``stops = chunk_ba_stops(did_kf) | interrupt_ba`` as each
    event's interruptBA -> (map, loop state, one BackgroundOut per frame)."""
    stops = (chunk_ba_stops(did_kf) | bool(interrupt_ba)).tolist()
    outs = []
    for did, kid, stop in zip(did_kf, kf_id, stops):
        m, loop_state, out = background_step(m, loop_state, did, kid, stop, caps, cam,
                                             scale_factors, with_loop, bow_group_div, inline_close)
        outs.append(out)
    return m, loop_state, outs


def recover_frame_pose(
    ref: int, gen: int, T_cr: np.ndarray, T_c_w_raw: np.ndarray,
    kf_pose, kf_valid, kf_gen, cull_parent, cull_parent_gen, cull_gen, kf_tcp,
) -> np.ndarray:
    """Per-frame pose from (T_cr, ref KF), walking the Tcp parent chain
    through culled keyframes (vo_run.cpp:207-226). Every hop carries the
    expected generation of the slot it lands on; a mismatch means slot reuse
    severed the chain, and the raw tracked pose is returned."""
    T_rp = np.eye(4, dtype=np.float32)
    hops = 0
    while ref >= 0 and hops < 64:
        if kf_valid[ref] and kf_gen[ref] == gen:
            return T_cr @ T_rp @ kf_pose[ref]
        if cull_gen[ref] != gen:
            break  # archive overwritten by a later generation's cull
        T_rp = T_rp @ kf_tcp[ref]
        gen = int(cull_parent_gen[ref])
        ref = int(cull_parent[ref])
        hops += 1
    return T_c_w_raw


class SlamSystem:
    """Tracking + local mapping over an RGB-D stream: one frame at a time
    (``chunk=1``) or in chunks of ``chunk`` frames. ``vocabulary`` turns on
    BoW tracking against the reference keyframe, relocalization and loop
    closing (and the featVec buckets of triangulation); ``reloc_parity``
    picks the reference's relocalization loop (module docstring);
    ``enable_global_ba`` runs the upstream global BA (keyframe 0 fixed)
    after each accepted loop closure. ``drain_chunk``: frames between the
    loop-candidate readbacks of the VO_LOOP_DIAG path (module docstring)."""

    def __init__(self, cfg: SlamConfig, caps: MapCaps = MapCaps(),
                 device: Optional[Union[str, torch.device]] = None, chunk: int = 1,
                 vocabulary: Optional[bow_voc.Vocabulary] = None, reloc_parity: bool = False,
                 enable_global_ba: bool = False, drain_chunk: int = DRAIN_CHUNK):
        self.cfg = cfg
        self.caps = caps
        self.device = resolve_device(device)
        self.camera = Camera.from_config(cfg, self.device)
        self.spec = PyramidSpec(self.camera.width, self.camera.height,
                                cfg.level_pyramid, cfg.scale_factor)
        self.budgets = self.spec.budget(cfg.num_of_features)
        self.scale_factors = torch.as_tensor(self.spec.scales, device=self.device)
        self.inv_level_sigma2 = torch.as_tensor(self.spec.inv_level_sigma2, device=self.device)
        self.fast_hi = float(cfg.ini_fast_threshold)
        self.fast_lo = float(cfg.min_fast_threshold)
        self.max_frame_gap = int(cfg.camera_fps)
        self.map = empty_map(caps, self.device)
        self.state = self._empty_state()
        self.voc = None if vocabulary is None else vocabulary.to(self.device)
        self.use_bow = vocabulary is not None
        self.reloc_parity = bool(reloc_parity)
        # loop closing runs with a vocabulary, as in the JAX package; the
        # reference stops at the essential graph (SURVEY §2), so the upstream
        # global BA after a closure is opt-in
        self.enable_loop_closing = self.use_bow
        self.enable_global_ba = bool(enable_global_ba)
        self.loop_state = loop_closing.empty_loop_state(caps, self.device)
        # (frame, winning candidate or -1, accepted) per keyframe event whose
        # detection confirmed a candidate, as the JAX package records them;
        # loop_gates: (frame, candidate, accepted, gate values) per Sim3 attempt
        self.loop_closures: List[int] = []
        self.loop_attempts: List[Tuple[int, int, bool]] = []
        self.loop_gates: List[Tuple[int, int, bool, dict]] = []
        # featVec bucket divisor of triangulation (matcher.cpp:903-965):
        # word // k^levels_up at levels_up = 3
        self._bow_group_div = vocabulary.k ** min(3, vocabulary.levels) if vocabulary else 0
        # per-frame (desc, valid) device tensors for create_vocabulary, which
        # reads the lost frames' descriptors too (map.cpp:79-83)
        self._frame_desc: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.chunk = int(chunk)
        self._chunk_buf: List = []  # buffered (gray, depth, timestamp) on the device
        # interruptBA (localMapping.cpp:538-541): a forced value for tests
        # (True skips each local BA at its entry); None = lowered, so every
        # keyframe event runs local BA (in chunks, chunk_ba_stops still
        # skips the events a later keyframe of the chunk overtakes)
        self._force_interrupt_ba: Optional[bool] = None
        # (frame, LM iterations pass 1, pass 2) per keyframe event; events
        # whose local BA was skipped at its entry (both counts 0)
        self.ba_iters: List[Tuple[int, int, int]] = []
        self.n_ba_interrupts = 0
        # VO_LOOP_DIAG=1: no inline close; the detections are drained from
        # the host every drain_chunk frames and each candidate is verified
        # with its gate values recorded in loop_attempts
        self._inline_close = not int(os.environ.get("VO_LOOP_DIAG", "0"))
        self._drain_every = max(1, int(drain_chunk))
        self._pending_loop: List = []    # (frame ids, packed [B, 2C+2] i32 on the device)
        self._inflight_drain: List = []  # (frame ids, host copy, CUDA event or None)
        self._outs: List[SlamOut] = []
        self.timestamps: List[float] = []
        self._frame_id = 0

    def _ba_interrupt(self) -> bool:
        """The forced interruptBA value, else lowered (the JAX package's
        default: every keyframe event runs local BA)."""
        return bool(self._force_interrupt_ba)

    def _empty_state(self) -> SlamTrackState:
        N = self.caps.n_feat
        dev = self.device
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        return SlamTrackState(
            frame_id=0, feats=FrameFeatures.empty(dev, N),
            assign_real=torch.full((N,), -1, dtype=torch.int32, device=dev),
            assign_gen=torch.full((N,), -1, dtype=torch.int32, device=dev),
            T_cr=eye, ref_kf=torch.zeros((), dtype=torch.int32, device=dev), T_cl=eye,
            motion_valid=false, initialized=False, lost=false,
            last_kf_frame=-10_000, last_was_kf=False, last_reloc_frame=-10_000,
        )

    def track(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> None:
        """gray u8 (H, W); depth f32 meters, or u16 raw scaled by the
        config's depth scale on the device. With ``chunk`` > 1 the frame is
        uploaded and buffered; a full chunk is tracked and mapped at once."""
        gray_d = upload(gray, self.device)
        depth_d = upload(depth, self.device)
        if not torch.is_floating_point(depth_d):
            depth_d = depth_d.to(torch.float32) * (1.0 / float(self.cfg.camera_depthScale))
        if self.chunk > 1:
            self._chunk_buf.append((gray_d, depth_d, timestamp))
            if len(self._chunk_buf) >= self.chunk:
                self._dispatch_chunk()
            return
        self._track_one(gray_d, depth_d, timestamp)

    def _archive(self, feats: FrameFeatures) -> None:
        if len(self._frame_desc) < DESC_ARCHIVE_CAP:
            self._frame_desc.append((feats.desc, feats.valid))

    def _track_one(self, gray_d: torch.Tensor, depth_d: torch.Tensor, timestamp: float) -> None:
        self.state, self.map, out, new_kf = _slam_step(
            self.state, self.map, gray_d, depth_d, timestamp, self.camera, self.caps,
            self.spec, self.budgets, self.scale_factors, self.inv_level_sigma2,
            self.fast_hi, self.fast_lo, self.max_frame_gap, self.voc, self.reloc_parity,
        )
        self.map, self.loop_state, bg = background_step(
            self.map, self.loop_state, out.made_kf, new_kf, self._ba_interrupt(), self.caps,
            self.camera, self.scale_factors, self.enable_loop_closing, self._bow_group_div,
            self._inline_close)
        self._fold_background([(self._frame_id, out.made_kf, bg)])
        if self.enable_loop_closing and not self._inline_close:
            self._queue_loop([self._frame_id], bg.cands[None], bg.cand_gens[None],
                             out.ref_kf.reshape(1), out.ref_gen.reshape(1))
        self._archive(self.state.feats)
        self._outs.append(out)
        self.timestamps.append(timestamp)
        self._frame_id += 1

    def _dispatch_chunk(self) -> None:
        """Track the buffered frames, then map their keyframe events."""
        buf, self._chunk_buf = self._chunk_buf, []
        self.state, self.map, outs, new_kfs, feats = track_chunk(
            self.state, self.map, buf, self.camera, self.caps, self.spec, self.budgets,
            self.scale_factors, self.inv_level_sigma2, self.fast_hi, self.fast_lo,
            self.max_frame_gap, self.voc, self.reloc_parity)
        did = [o.made_kf for o in outs]
        self.map, self.loop_state, bgs = background_chunk(
            self.map, self.loop_state, did, new_kfs, self._ba_interrupt(), self.caps, self.camera,
            self.scale_factors, self.enable_loop_closing, self._bow_group_div, self._inline_close)
        self._fold_background([(self._frame_id + k, made, bg)
                               for k, (made, bg) in enumerate(zip(did, bgs))])
        if self.enable_loop_closing and not self._inline_close:
            self._queue_loop(list(range(self._frame_id, self._frame_id + len(buf))),
                             torch.stack([bg.cands for bg in bgs]),
                             torch.stack([bg.cand_gens for bg in bgs]),
                             torch.stack([o.ref_kf for o in outs]),
                             torch.stack([o.ref_gen for o in outs]))
        for f in feats:
            self._archive(f)
        self._outs += outs
        self.timestamps += [t for _, _, t in buf]
        self._frame_id += len(buf)

    def _fold_background(self, events) -> None:
        """Record (frame, made a keyframe, BackgroundOut) per frame of one
        background dispatch; after it, the global BA for each closure when
        enabled (the JAX package runs it when it collects the closure)."""
        for frame, made, bg in events:
            if made:
                self.ba_iters.append((frame, bg.ba_n1, bg.ba_n2))
                if not (bg.ba_n1 or bg.ba_n2):
                    self.n_ba_interrupts += 1
            if bg.attempted:
                self.loop_attempts.append((frame, bg.which, bg.closed))
                self.loop_gates += [(frame, c, a, g) for c, a, g in bg.attempts]
            if bg.closed:
                self.loop_closures.append(frame)
                if self.enable_global_ba:
                    self.map = global_ba.global_bundle_adjust(
                        self.map, self.caps, self.camera, 0,
                        inv_level_sigma2=self.inv_level_sigma2)

    def _queue_loop(self, frame_ids, cands, cand_gens, ref_kfs, ref_gens) -> None:
        """Queue one batch of per-frame detections (device tensors with
        leading dim B) for a later readback; drain every ``drain_chunk``
        frames."""
        packed = torch.cat([cands.to(torch.int32), cand_gens.to(torch.int32),
                            ref_kfs.to(torch.int32)[:, None], ref_gens.to(torch.int32)[:, None]],
                           dim=1)  # [B, 2 MAX_CANDS + 2]
        self._pending_loop.append((frame_ids, packed))
        if sum(len(f) for f, _ in self._pending_loop) >= self._drain_every:
            self._drain_loop_queue()

    def _drain_loop_queue(self, final: bool = False) -> None:
        """Verify the candidates of the batches whose copies have landed, then
        start the copy of the queued batch. With ``drain_chunk`` > 1 (and not
        ``final``) a batch still copying is left for a later drain rather
        than waited for; with 1 the previous batch is waited for, so a
        closure runs one frame after its detection."""
        may_defer = self._drain_every > 1 and not final
        while self._inflight_drain:
            frame_ids, host, landed = self._inflight_drain[0]
            if may_defer and landed is not None and not landed.query():
                break
            self._inflight_drain.pop(0)
            self._process_drain(frame_ids, host, landed)
        if self._pending_loop:
            batch, self._pending_loop = self._pending_loop, []
            packed = torch.cat([p for _, p in batch])
            if packed.device.type == "cuda":
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record()
            else:
                host, landed = packed, None
            self._inflight_drain.append(([f for fids, _ in batch for f in fids], host, landed))
        if final:
            for frame_ids, host, landed in self._inflight_drain:
                self._process_drain(frame_ids, host, landed)
            self._inflight_drain = []

    def _process_drain(self, frame_ids, host: torch.Tensor, landed) -> None:
        """Verify each frame's queued candidates (one landed batch)."""
        if landed is not None:
            landed.synchronize()
        arr = host.numpy()
        k = (arr.shape[1] - 2) // 2
        for frame, row in zip(frame_ids, arr.tolist()):
            self._process_one_diag(frame, row[:k], row[k:2 * k], row[2 * k], row[2 * k + 1])

    def _process_one_diag(self, frame: int, cands, gens, kf_id: int, kf_gen: int) -> None:
        """One frame's candidates in order, each through ``close_step`` with
        its gate values, until one is accepted (then global BA, if enabled)."""
        groups_curr = bow_voc.feature_groups(self.voc, self.map.kf_word[max(kf_id, 0)])
        for cand, gen in zip(cands, gens):
            if cand < 0:
                continue
            self.map, self.loop_state, ok, gates = loop_closing.close_step(
                self.map, self.loop_state, kf_id, cand, self.caps, self.camera,
                self.scale_factors, groups_curr,
                bow_voc.feature_groups(self.voc, self.map.kf_word[cand]),
                kf_gen_expect=kf_gen, cand_gen_expect=gen, diag=True)
            self.loop_attempts.append((frame, cand, ok, gates))
            self.loop_gates.append((frame, cand, ok, gates))
            if not ok:
                continue
            self.loop_closures.append(frame)
            if self.enable_global_ba:
                self.map = global_ba.global_bundle_adjust(
                    self.map, self.caps, self.camera, 0, inv_level_sigma2=self.inv_level_sigma2)
            break

    def _flush(self) -> None:
        """Track the frames of an incomplete chunk one at a time."""
        buf, self._chunk_buf = self._chunk_buf, []
        for gray_d, depth_d, ts in buf:
            self._track_one(gray_d, depth_d, ts)

    def results(self):
        """Blocks; returns (trajectory T_w_c [F,4,4], stats, kf_traj)."""
        self._flush()
        if self.enable_loop_closing and not self._inline_close:
            self._drain_loop_queue(final=True)
        keys = ("kf_pose", "kf_valid", "kf_gen", "cull_parent",
                "cull_parent_gen", "cull_gen", "kf_tcp")
        arrays = {k: getattr(self.map, k).cpu().numpy() for k in keys}

        def stacked(name):
            return torch.stack([getattr(o, name) for o in self._outs]).cpu().numpy()

        ref_kf, ref_gen, T_cr, T_c_w = (stacked(k) for k in ("ref_kf", "ref_gen", "T_cr", "T_c_w"))
        n_f, n_m, n_i, ok = (stacked(k) for k in ("n_features", "n_matches", "n_inliers", "ok"))
        traj, stats = [], []
        for i in range(len(self._outs)):
            T = recover_frame_pose(int(ref_kf[i]), int(ref_gen[i]), T_cr[i], T_c_w[i], **arrays)
            traj.append(np.linalg.inv(T))
            stats.append(TrackStats(n_features=int(n_f[i]), n_matches=int(n_m[i]),
                                    n_inliers=int(n_i[i]), ok=bool(ok[i])))
        kf_ts = self.map.kf_timestamp.cpu().numpy()
        kf_traj = [(float(kf_ts[k]), np.linalg.inv(arrays["kf_pose"][k]))
                   for k in range(arrays["kf_pose"].shape[0]) if arrays["kf_valid"][k]]
        return np.stack(traj), stats, kf_traj

    def hud_outputs(self, frames: Sequence[int]) -> List[HudOut]:
        """The named frames' HUD inputs (keypoints, their tracking state, ok)
        read to the host in one copy per field."""
        if not frames:
            return []
        outs = [self._outs[i] for i in frames]
        uv = torch.stack([o.kp_uv for o in outs]).cpu().numpy()
        state = torch.stack([o.kp_state for o in outs]).cpu().numpy()
        ok = torch.stack([o.ok for o in outs]).cpu().numpy()
        return [HudOut(kp_uv=u, kp_state=k, ok=bool(b)) for u, k, b in zip(uv, state, ok)]

    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.map.pt_valid.sum())

    @property
    def reloc_frames(self) -> List[int]:
        """Frames that the relocalization attempt tracked (one read)."""
        if not self._outs:
            return []
        flags = torch.stack([o.relocalized for o in self._outs]).tolist()
        return [i for i, f in enumerate(flags) if f]

    def create_vocabulary(self, k: int = 10, levels: int = 4, seed: int = 0) -> bow_voc.Vocabulary:
        """A scene vocabulary from the live keyframes' descriptors and those
        of the lost frames (map.cpp:60-99; lost frames archived as at
        visualOdometry.cpp:115-121), on this system's device."""
        kf_descs, lost_descs = self._vocabulary_descriptors()
        descs = kf_descs + lost_descs
        if not descs:
            raise RuntimeError("no keyframes to build a vocabulary from")
        return bow_voc.build_vocabulary(np.concatenate(descs), k=k, levels=levels, seed=seed,
                                        device=self.device)

    def _vocabulary_descriptors(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """(keyframe descriptor arrays, lost-frame descriptor arrays), uint32."""
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_desc = self.map.kf_desc.cpu().numpy().view(np.uint32)
        kp_valid = self.map.kf_kp_valid.cpu().numpy()
        kf_descs = [kf_desc[kf][kp_valid[kf]] for kf in np.nonzero(kf_valid)[0]]
        n = len(self._frame_desc)
        oks = torch.stack([o.ok for o in self._outs[:n]]).tolist() if n else []
        lost_descs = []
        for ok, (desc, valid) in zip(oks, self._frame_desc):
            if not ok:
                d = desc[valid].cpu().numpy().view(np.uint32)
                if d.size:
                    lost_descs.append(d)
        return kf_descs, lost_descs
