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

Spans (``utils.graphs``: recorded only inside ``graphs.counting()``; with a
torch profiler recording, each also opens a ``record_function`` range of its
name). Inside the programs, device stages: the tracking program's
``extract``, ``bow``, ``attempts``, ``local_map`` and ``keyframe``; the
background program's ``cull_points``, ``triangulate``, ``fuse``,
``local_ba``, ``cull_keyframes``, ``loop_detect`` and ``loop_close`` (the
close itself ``close_step``), each replay a ``program`` span; the paths the
reference takes are named nodes (``retry_r30``, ``motion``, ``ref_kf``,
``reloc``, ``kf_insert``, ``mapping``, ``local_ba_lm``, ``close``, ...). On
the host, per frame (``SlamSystem.spans``): ``track``, ``stage``,
``first_frame``, ``track_replay`` and ``background_replay`` (each around a
program's run, the launch call itself ``launch``), ``outputs``,
``background``, ``settle``, ``results``, ``close_step`` and
``global_bundle``. ``SlamSystem.trace()`` puts both on the host's clock. The
``background``, ``close_step`` and ``global_bundle`` ranges are the work the
reference runs off the tracking thread, named as the JAX package's programs:
``vo_slam_test_tpu_torch.bench`` sums the device time of the kernels launched
inside them.

Host reads. The JAX package builds each step as one program whose branches
are ``lax.cond`` on device scalars. Here the branches are
``utils.graphs.cond`` / ``while_capped``, and what they cost depends on the
path (the frame counter, the last keyframe's frame and its flag live on the
device on every path, as in the JAX package):

- through the step programs (``graphs=True``; the card's default): a chunk
  (or, with ``chunk=1``, a frame) replays two captured CUDA graphs, the
  tracking program (``_slam_step`` as the body of a ``graphs.scan`` over the
  chunk's frames, the JAX package's ``track_chunk``) and the background
  program (``background_step`` as a ``scan`` body over the chunk's events,
  its ``background_chunk``); each loop is one WHILE node whose body is
  captured once, and the branches are IF nodes: the r=30 retry, the
  keyframe insert at a device slot, the mapping chain on ``made_kf & (kf_id
  >= 0)``, each triangulation neighbour slot (inside the slots' WHILE
  node), local BA's interruptBA entry; local BA's LM passes, pose-only LM
  and keyframe culling's reparenting (a WHILE node in a WHILE node) are
  WHILE nodes. With a vocabulary the
  tracking program also holds BoW and the fallback chain (motion tracking,
  the reference keyframe, relocalization with each candidate slot, its
  solver choice and the top-up cascade's gates as conds; ``last_reloc_frame``
  and the winner stay on the device), and the background program holds loop
  detection and the close (the Sim3 candidate scan, a WHILE node with an
  early exit and each slot under its cond, the Sim3 and essential-graph LM
  loops, the correction with the loop fuse's ``fori_loop``) under their
  conds. Nothing is read back until ``results()``; with global
  BA one read after each dispatch's background replays folds the closures
  and runs global BA after each (the JAX package reads its close results
  then), itself a third program (``solvers/global_ba.py::program``: its LM
  and CG loops are WHILE nodes, the map goes in and out through its static
  buffers). The frames and timestamps are staged into the tracking program's
  [K] buffers on the device, and both programs take their trip range as
  device ints, so one pair serves a full chunk (one replay each), the first
  chunk (its first frame, which flips the host flag ``initialized``, runs
  outside in ``select`` mode; each program's first trip is its warm-up, in
  ``select`` mode, and the next call captures the rest) and ``results()``'s
  partial chunk (frame by frame); ``chunk_ba_stops`` is computed on the
  device inside the background program. The programs (``track_program``,
  ``background_program``) close over no system: the camera's tensors, the
  vocabulary's and the scale tables are their traced inputs, and the
  statics are bound by keyword, so they are the process's for a static
  configuration, warmed up and captured once, as the JAX package's jits are
  compiled once per process (``utils.graphs.program``);
- eager (``graphs=False``, the CPU's default): the same functions, each
  ``cond`` reading its predicate back.
  Without a vocabulary a tracked frame reads the r=15 match count (the r=30
  retry) and, in ``insert_keyframe``, the keyframe decision with its slot
  (one read); a lost frame's motion attempt runs and is discarded
  (``torch.where``). With a vocabulary the frame reads the motion gate and
  then ``a1.ok`` with the LOST flag (one read each), the reference keyframe's
  ``ok`` only after it ran, and a relocalization its candidates' liveness,
  each live candidate's solver choice, the cascade's gates and the winner. A
  keyframe event adds the triangulation's neighbour gates (one read) and one
  read per local-BA LM iteration (its exit test); with loop closing on it
  reads its confirmed loop candidates (one read), and a close reads each
  slot's gate (one a candidate tried), the accept, the group it fuses into
  and its outcome (one each).
"""

from __future__ import annotations

import dataclasses
import functools
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
from ..slam_map.map_state import (MapCaps, MapState, empty_map, first_true, pick,
                                  scatter_or, winner_per_target)
from ..solvers import epnp, global_ba, local_ba, pose_only, ransac
from ..utils import graphs as graphs_mod
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
    """The tracking state. ``frame_id``, ``last_kf_frame``, ``last_was_kf``
    and ``last_reloc_frame`` are 0-d device tensors on every path, as the JAX
    package keeps them; ``initialized`` stays on the host: it is False only
    before the first frame."""

    frame_id: torch.Tensor      # i32 frame counter
    feats: FrameFeatures        # last frame features
    assign_real: torch.Tensor   # [N] i32 map point per last-frame kp (-1)
    assign_gen: torch.Tensor    # [N] i32 pt_gen at bind time
    T_cr: torch.Tensor          # [4,4] last frame pose relative to its ref KF
    ref_kf: torch.Tensor        # i32 ref keyframe of the last frame
    T_cl: torch.Tensor          # [4,4] motion model
    motion_valid: torch.Tensor  # bool
    initialized: bool           # host-known: False only before the first frame
    lost: torch.Tensor          # bool: state LOST (visualOdometry.h:18-22)
    last_kf_frame: torch.Tensor  # i32 frame id of the last inserted KF
    last_was_kf: torch.Tensor   # bool: the last frame inserted a KF
    last_reloc_frame: torch.Tensor  # i32 frame of the last relocalization (-10000: never)


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
    made_kf: Union[bool, torch.Tensor]  # host bool when eager (read with the insert); a
                                        # device bool under graphs until results()
    relocalized: torch.Tensor   # bool: the relocalization attempt tracked this frame
    kp_uv: torch.Tensor         # [N,2] raw pixel coords (HUD overlay)
    kp_state: torch.Tensor      # [N] i32: 0 untracked, 1 map-tracked, 2 VO-tracked
    # the relocalization attempt's winning candidate (keyframe slot, BoW
    # matches, RANSAC inliers, observed inliers): with a vocabulary an i32 [4]
    # on the device (slot -1: no candidate or no attempt) on every path, until
    # results() folds it to a Python tuple or None; None without a vocabulary
    reloc_winner: Union[None, Tuple[int, int, int, int], torch.Tensor] = None


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
    temp_valid = temp_valid & ~real_last & ~state.last_was_kf
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
    # widen the window: one host read when eager, a conditional node in a
    # captured step (the JAX package's lax.cond)
    res = graphs_mod.cond(res.count < 20, lambda: search(30.0), lambda: res, name="retry_r30")
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
    add the new matches). The second top-up runs under a ``graphs.cond`` on
    its gate (the JAX package's ``lax.cond``: one host read when eager, a
    conditional node in a captured step); the adoptions are selects. -> (T,
    kp, n) of the adopted stage."""
    T_a, kp_a, n_a, add1 = topup1(T_in, kp_in)
    use_a = (n_in + add1) >= 50

    def second(T_b, kp_b, n_b):
        T_c, kp_c, n_c, add2 = topup2(T_b, kp_b)
        use_b = (n_b + add2) >= 50
        return (torch.where(use_b, T_c, T_b), torch.where(use_b, kp_c, kp_b),
                torch.where(use_b, n_c, n_b))

    T_f, kp_f, n_f = graphs_mod.cond(use_a & (n_a > 30) & (n_a < 50), second,
                                     lambda T, kp, n: (T, kp, n), (T_a, kp_a, n_a))
    return (torch.where(use_a, T_f, T_in), torch.where(use_a, kp_f, kp_in),
            torch.where(use_a, n_f, n_in))


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


def _attempt_reloc(m: MapState, feats: FrameFeatures, bow, voc, frame_id: torch.Tensor,
                   reloc_parity: bool, cam, scale_factors, inv_level_sigma2
                   ) -> Tuple[_Attempt, torch.Tensor]:
    """Relocalization (visualOdometry.cpp:313-395) -> (attempt, the winner's
    (keyframe slot, n_bow, n_ransac, n_obs) as an i32 [4], slot -1 without
    candidates), all on the device.

    The JAX package evaluates its top-k candidates as one ``vmap``
    (``vo_slam_test_tpu/pipeline/system.py:339-460``); here each candidate
    slot runs under a ``graphs.cond`` on its liveness and writes its attempt
    into a [K, ...] buffer, and the winner is picked from it by index. With no
    candidate the slot ``top_k`` returns first runs as the JAX package
    evaluates it (its BoW matches are the frame's match count and its solve
    the frame's pose), and the attempt fails. Candidate i of the BoW ranking
    draws its RANSAC hypotheses from the seed frame_id * K + i (mod 2^32),
    computed on the device. Default mode (``RELOC_K``): Horn 3D-3D or EPnP by
    a cond on ``depth_rich``, the most observed inliers among the passing
    candidates wins (the first maximum), and one top-up cascade runs on the
    winner under a cond on n_obs < 50. Parity mode (``RELOC_PARITY_K``): the
    candidates in keyframe-insertion order (sorted on the device), each under
    ``live & ~won`` with EPnP and its own cascade; the first success wins,
    else the best-scoring candidate."""
    uniq_c, wgt_c, groups_c = bow
    N = feats.valid.shape[0]
    P = m.pt_valid.shape[0]
    dev = feats.valid.device
    no_tmp = torch.zeros_like(feats.valid)
    score, shared = bow_ret.scores_vs_keyframes(uniq_c, wgt_c, m.kf_bow_word, m.kf_bow_weight,
                                                m.kf_valid.to(torch.float32))
    cand = bow_ret.reloc_candidates(score, shared, m.covis, m.kf_valid)
    K = RELOC_PARITY_K if reloc_parity else RELOC_K
    c_scores, c_kfs = prng.top_k(torch.where(cand, score, -torch.inf), K)
    c_ok = torch.isfinite(c_scores)
    any_cand = c_ok.any()
    slots = torch.arange(K, device=dev)
    live = c_ok | ((slots == 0) & ~any_cand)  # the JAX package's winner without a candidate
    p_cam = cam.pixel2camera(feats.uv_und, torch.clamp(feats.depth, min=1e-3))
    inv_sig = inv_level_sigma2[feats.octave.long()]
    frame64 = frame_id.to(torch.int64)

    def topup(kf, row, pt_live, T_in, kp_in, radius, th):
        in_set = scatter_or(P, kp_in.clamp(min=0), kp_in >= 0)
        safe = row.clamp(min=0).long()
        res2 = matcher.search_by_projection_kf(
            p_world=m.pt_pos[safe], src_desc=m.pt_desc[safe], src_angle=pick(m.kf_angle, kf),
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

    def cascade(kf, T3, kp3, n_obs):
        """The top-up cascade under its caller's gate n_obs < 50."""
        row = pick(m.kf_mp, kf)
        pt_live = m.pt_valid[row.clamp(min=0).long()]

        def run(T, kp, n):
            return reloc_topup_cascade(
                lambda T_, kp_: topup(kf, row, pt_live, T_, kp_, 10.0, 100.0),
                lambda T_, kp_: topup(kf, row, pt_live, T_, kp_, 3.0, 60.0), T, kp, n)

        return graphs_mod.cond(n_obs < 50, run, lambda T, kp, n: (T, kp, n), (T3, kp3, n_obs))

    def candidate(i, horn_ok: bool):
        """Slot i's attempt -> (T, kp, n_obs, n_bow, n_ransac); parity mode
        (``horn_ok`` False) adds its cascade."""
        kf = pick(c_kfs, i)
        row = pick(m.kf_mp, kf)
        pt_live = m.pt_valid[row.clamp(min=0).long()]
        res = bow_match.search_by_bow_kf_frame(
            kf_desc=pick(m.kf_desc, kf), kf_groups=bow_voc.feature_groups(voc, pick(m.kf_word, kf)),
            kf_mp=row, kf_angle=pick(m.kf_angle, kf), kf_pt_valid=pt_live, f_desc=feats.desc,
            f_groups=groups_c, f_angle=feats.angle, f_valid=feats.valid, ratio=0.75)
        has = res.assign >= 0
        p_world = m.pt_pos[res.assign.clamp(min=0).long()]
        seed = frame64 * K + i

        def horn():
            Tr, _, n = ransac.ransac_pose_3d3d(p_world, p_cam, feats.uv_und,
                                               has & (feats.depth > 0), has,
                                               cam.fx, cam.fy, cam.cx, cam.cy, seed)
            return Tr, n

        def pnp():
            Tr, _, n = epnp.ransac_pnp(prng.prng_key(seed), p_world, feats.uv_und, has, inv_sig,
                                       cam)
            return Tr, n

        if horn_ok:
            depth_rich = 2 * (has & (feats.depth > 0)).sum() >= has.sum()
            Tr, n_ransac = graphs_mod.cond(depth_rich, horn, pnp)
        else:
            Tr, n_ransac = pnp()  # the reference always solves EPnP (visualOdometry.cpp:806-826)
        T3, kp3, _, n_obs = _solve_and_cull(m, feats, Tr, res.assign, no_tmp, p_world,
                                            inv_level_sigma2, cam)
        if not horn_ok:
            T3, kp3, n_obs = cascade(kf, T3, kp3, n_obs)
        return T3, kp3, n_obs, res.count, n_ransac

    def dead():
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return (torch.zeros((4, 4), device=dev),
                torch.full((N,), -1, dtype=torch.int32, device=dev), z, z, z)

    def passes(n_bow, n_ransac):
        return (n_bow >= 15) & (n_ransac >= 10)

    if reloc_parity:
        # the reference's loop: the candidates in keyframe-insertion order,
        # each evaluated until one succeeds (visualOdometry.cpp:313-395)
        seq = torch.where(live, m.kf_seq[c_kfs], torch.iinfo(torch.int32).max)
        order = torch.argsort(seq, stable=True)
        won = torch.zeros((), dtype=torch.bool, device=dev)
        outs, wins = [], []
        for j in range(K):
            i = order[j]
            run = pick(live, i) & ~won
            T3, kp3, n_obs, n_bow, n_ransac = graphs_mod.cond(run, lambda i=i: candidate(i, False),
                                                              dead)
            ok_j = run & pick(c_ok, i) & passes(n_bow, n_ransac) & (n_obs >= 50)
            won = won | ok_j
            outs.append((T3, kp3, n_obs, n_bow, n_ransac))
            wins.append(ok_j)
        wins = torch.stack(wins)
        # the first success, else the best-scoring candidate (top-k slot 0)
        w = torch.where(won, first_true(wins, 0), first_true(order == 0, 0))
        kf_w = pick(c_kfs[order], w)
    else:
        live_h = graphs_mod.fetch(live)
        outs = [graphs_mod.cond(live_h[i], lambda i=i: candidate(slots[i], True), dead)
                for i in range(K)]
        n_obs_k = torch.stack([o[2] for o in outs])
        pass_k = c_ok & passes(torch.stack([o[3] for o in outs]), torch.stack([o[4] for o in outs]))
        w = torch.argmax(torch.where(pass_k, n_obs_k, -1))  # the first maximum, as jnp.argmax
        kf_w = pick(c_kfs, w)
    T4, kp4, n_obs4, n_bow, n_ransac = (pick(torch.stack(x), w) for x in zip(*outs))
    if not reloc_parity:  # one cascade, on the winner
        T4, kp4, n_obs4 = cascade(kf_w, T4, kp4, n_obs4)
    ok = any_cand & passes(n_bow, n_ransac) & (n_obs4 >= 50)
    att = _Attempt(T=T4, kp_pt=torch.where(ok, kp4, -1), kp_temp=no_tmp,
                   kp_pw=m.pt_pos[kp4.clamp(min=0).long()], n_match=n_bow, ok=ok)
    winner = torch.stack([torch.where(any_cand, kf_w, -1), n_bow.to(torch.int64),
                          n_ransac.to(torch.int64), n_obs4.to(torch.int64)]).to(torch.int32)
    return att, winner


def _track_attempts_bow(state: SlamTrackState, m: MapState, feats: FrameFeatures, bow, voc,
                        reloc_parity: bool, T_last, cam, scale_factors, inv_level_sigma2, fail):
    """The fallback chain with a vocabulary, in the JAX package's structure
    (``vo_slam_test_tpu/pipeline/system.py:301-303``, ``:327``, ``:495``)
    -> (attempt, relocalized, the relocalization's winner: an i32 [4] on the
    device, slot -1 when there was none). Each attempt runs
    under a ``graphs.cond``: motion tracking on an armed motion model away
    from the last relocalization (visualOdometry.cpp:227-231), the reference
    keyframe when it failed and the state is not LOST, relocalization when
    both failed. Eager, that is one host read per gate, as the reads before
    each fallback were."""
    frame_id = state.frame_id
    can_motion = ~state.lost & state.motion_valid & (frame_id >= state.last_reloc_frame + 2)
    a1 = graphs_mod.cond(can_motion, lambda: _attempt_motion(
        state, m, feats, T_last, cam, scale_factors, inv_level_sigma2), lambda: fail,
        name="motion")
    nok1, nlost = graphs_mod.fetch(~a1.ok, ~state.lost)
    go_ref = nok1 & nlost
    a2 = graphs_mod.cond(go_ref, lambda: _attempt_ref(
        state, m, feats, bow[2], voc, T_last, cam, inv_level_sigma2), lambda: fail,
        name="ref_kf")
    go_reloc = graphs_mod.fetch(graphs_mod.where(go_ref, ~a2.ok, nok1))
    no_winner = torch.full((4,), -1, dtype=torch.int32, device=frame_id.device)
    a3, winner = graphs_mod.cond(go_reloc, lambda: _attempt_reloc(
        m, feats, bow, voc, frame_id, reloc_parity, cam, scale_factors, inv_level_sigma2),
        lambda: (fail, no_winner), name="reloc")
    pick2 = a1.where(a1.ok, a2)
    att = pick2.where(pick2.ok, a3)
    return att, a3.ok, winner


def fold_winner(vals) -> Optional[Tuple[int, int, int, int]]:
    """A relocalization winner's four ints -> the tuple, or None for slot -1
    (no candidate, or no relocalization attempt)."""
    return tuple(int(v) for v in vals) if vals[0] >= 0 else None


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
    N = caps.n_feat
    P = caps.max_pt
    with graphs_mod.span("extract"):
        feats = extract_fused(gray, depth_img, cam, spec, budgets, fast_hi, fast_lo)
        n_feats = feats.valid.sum(dtype=torch.int32)
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
    words_c = uniq_c = wgt_c = None
    if voc is not None:
        with graphs_mod.span("bow"):
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
        kf_d = graphs_mod.on_device(new_kf, torch.int32, dev)
        made = kf_d >= 0
        kf0 = kf_d.clamp(min=0)
        assign_out = torch.where(made, pick(m.kf_mp, kf0), no_pt)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        st = SlamTrackState(
            frame_id=frame_id + 1, feats=feats, assign_real=assign_out,
            assign_gen=torch.where(assign_out >= 0, m.pt_gen[assign_out.clamp(min=0).long()], -1),
            T_cr=eye @ lie.se3_inverse(pick(m.kf_pose, kf0)), ref_kf=kf0, T_cl=eye,
            motion_valid=false, initialized=True, lost=false,
            last_kf_frame=torch.where(made, frame_id, state.last_kf_frame),
            last_was_kf=made, last_reloc_frame=state.last_reloc_frame,
        )
        out = SlamOut(
            T_c_w=eye, T_cr=st.T_cr, ref_kf=kf0, ref_gen=pick(m.kf_gen, kf0),
            ok=torch.ones((), dtype=torch.bool, device=dev), n_features=n_feats,
            n_matches=zero, n_inliers=zero, made_kf=new_kf >= 0, relocalized=false,
            kp_uv=feats.uv, kp_state=torch.zeros((N,), dtype=torch.int32, device=dev),
        )
        return st, m, out, new_kf

    # ======================== TRACK ========================================
    with graphs_mod.span("attempts"):
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
        else:
            att, relocalized, reloc_winner = _track_attempts_bow(
                state, m, feats, bow, voc, reloc_parity, T_last, cam, scale_factors,
                inv_level_sigma2, fail)
        reloc_frame = torch.where(relocalized, frame_id, state.last_reloc_frame)
        track_pre = att.ok
        kp_pw_cur = torch.where((att.kp_pt >= 0)[:, None],
                                m.pt_pos[att.kp_pt.clamp(min=0).long()], att.kp_pw)

    # ---------------- trackLocalMap -----------------------------------------
    with graphs_mod.span("local_map"):
        member = scatter_or(P, att.kp_pt.clamp(min=0), att.kp_pt >= 0)
        local_kf, ref_kf = local_map.local_keyframe_mask(m, att.kp_pt)
        ref_kf = torch.where(torch.any(att.kp_pt >= 0), ref_kf, state.ref_kf)
        cand_pts = local_map.local_point_mask(m, local_kf) & ~member
        blocked = _observed(m, att.kp_pt)
        th_rad = torch.where(frame_id < reloc_frame + 2, 5.0, 3.0)
        lm = local_map.search_local_points(
            m, att.T, cand_pts, feats.uv_und, feats.u_right, feats.octave, feats.desc,
            feats.valid, blocked, scale_factors, th_rad, cam=cam)
        kp_pt2 = torch.where(lm.assign >= 0, lm.assign, att.kp_pt)
        kp_temp2 = att.kp_temp & (lm.assign < 0)
        kp_pw2 = torch.where((kp_pt2 >= 0)[:, None], m.pt_pos[kp_pt2.clamp(min=0).long()],
                             kp_pw_cur)

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
        gate = torch.where(frame_id < reloc_frame + max_frame_gap, 50, 30)
        ok = track_pre & (observed_inliers >= gate)

        vis_pts = scatter_or(P, kp_pt2.clamp(min=0), real2) | lm.visible_mask
        found_pts = scatter_or(P, kp_pt2.clamp(min=0), inlier_real)
        m = m.replace(pt_visible=m.pt_visible + vis_pts.to(torch.int32),
                      pt_found=m.pt_found + found_pts.to(torch.int32))

        T_new = torch.where(ok, T2, att.T)
        assign_final = torch.where(inlier_real, kp_pt2, -1)

    # ---------------- keyframe policy ---------------------------------------
    with graphs_mod.span("keyframe"):
        kf_cnt = m.kf_valid.sum(dtype=torch.int32)
        min_obs = torch.where(kf_cnt <= 2, 2, 3)
        ref_row = pick(m.kf_mp, ref_kf)
        ref_obs = m.pt_obs_cnt[ref_row.clamp(min=0).long()]
        ref_matches = ((ref_row >= 0) & (ref_obs >= min_obs)).sum(dtype=torch.int32)
        ref_ratio = (observed_inliers.to(torch.float32)
                     / torch.clamp(ref_matches, min=1).to(torch.float32))
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

        # eager, the insert reads the decision back (one host read) and runs
        # only then, and new_kf is a Python int; under graphs it is the JAX
        # package's predicated insert and new_kf a device int
        m, new_kf = insert_kf(m, T_new, assign_final, need_kf)
        kf_d = graphs_mod.on_device(new_kf, torch.int32, dev)
        made = kf_d >= 0
        ref_kf_out = torch.where(made, kf_d, ref_kf)
        assign_out = torch.where(made, pick(m.kf_mp, kf_d.clamp(min=0)), assign_final)

        T_cr = T_new @ lie.se3_inverse(pick(m.kf_pose, ref_kf_out))
        T_cl = torch.where(ok, T_new @ lie.se3_inverse(T_last), eye)
        st = SlamTrackState(
            frame_id=frame_id + 1, feats=feats, assign_real=assign_out,
            assign_gen=torch.where(assign_out >= 0, m.pt_gen[assign_out.clamp(min=0).long()], -1),
            T_cr=T_cr, ref_kf=ref_kf_out, T_cl=T_cl, motion_valid=ok, initialized=True, lost=~ok,
            last_kf_frame=torch.where(made, frame_id, state.last_kf_frame),
            last_was_kf=made, last_reloc_frame=reloc_frame,
        )
        # HUD flags (drawer.cpp:430-459): map-tracked when the point has
        # observers, VO-tracked for fresh/temp points; only in state OK
        hud_observed = m.pt_obs_cnt[kp_pt2.clamp(min=0).long()] > 0
        hud_map = inlier_real & hud_observed
        hud_vo = (inlier_real & ~hud_observed) | (kp_temp2 & inl2)
        kp_state = torch.where(ok & feats.valid, torch.where(hud_map, 1, torch.where(hud_vo, 2, 0)),
                               0).to(torch.int32)
        out = SlamOut(
            T_c_w=T_new, T_cr=T_cr, ref_kf=ref_kf_out, ref_gen=pick(m.kf_gen, ref_kf_out), ok=ok,
            n_features=n_feats, n_matches=att.n_match, n_inliers=observed_inliers,
            made_kf=new_kf >= 0, relocalized=relocalized, kp_uv=feats.uv, kp_state=kp_state,
            reloc_winner=reloc_winner,
        )
    return st, m, out, new_kf


def _mapping_step(m: MapState, did_kf, kf_id, caps: MapCaps, cam: Camera,
                  scale_factors: torch.Tensor, interrupt_ba=False,
                  bow_group_div: int = 0) -> Tuple[MapState, int, int]:
    """The local-mapping chain for one new keyframe, in the order of
    LocalMapping::run (localMapping.cpp:16-66): cullingMapPoints ->
    createNewMapPoints -> searchInNeighbors (fuse) -> local BA ->
    cullingKeyFrames. ``bow_group_div``: the triangulation's featVec bucket
    divisor (0 without a vocabulary). Returns (map, BA iterations pass 1,
    pass 2). The chain runs under one ``graphs.cond`` on ``did_kf & (kf_id
    >= 0)`` (the JAX package's ``lax.cond``): ``did_kf``, ``kf_id`` and
    ``interrupt_ba`` are host values when eager, device values under graphs,
    where the counts are device ints. Each stage is a span of its own."""
    go = did_kf & (kf_id >= 0)
    zero = graphs_mod.scalar(0, torch.int32, m.device)

    def work(m):
        kid = graphs_mod.where(kf_id >= 0, kf_id, 0)
        with graphs_mod.span("cull_points"):
            m = culling.cull_map_points(m, kid, caps)
        with graphs_mod.span("triangulate"):
            m = triangulate.create_new_map_points(m, kid, caps, cam, scale_factors,
                                                  bow_group_div=bow_group_div)
        with graphs_mod.span("fuse"):
            m = fuse.search_in_neighbors(m, kid, caps, cam, scale_factors)
        with graphs_mod.span("local_ba"):
            m, n1, n2 = local_ba.local_bundle_adjust_iters(
                m, kid, caps, cam, 1.0 / (scale_factors * scale_factors), stop=interrupt_ba)
        with graphs_mod.span("cull_keyframes"):
            m = culling.cull_keyframes(m, kid, caps, cam)
        return m, n1, n2

    return graphs_mod.cond(go, work, lambda m: (m, zero, zero), (m,), name="mapping")


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
    # with loop closing: the detection's confirmed candidates [MAX_CANDS] and
    # their kf_gen at detection, on the device (-1 rows without an event)
    cands: Optional[torch.Tensor] = None
    cand_gens: Optional[torch.Tensor] = None
    # the inline close's outcome on the device (None eager when no candidate
    # was confirmed, and on the VO_LOOP_DIAG path)
    close: Optional[loop_closing.CloseOut] = None

    def fold(self, cands, closed, which, tried, accepted, gates) -> None:
        """The close's outcome read back (host values, ``CloseOut.leaves``
        after the candidates) into ``attempted``/``closed``/``which``/
        ``attempts``."""
        self.attempted = cands[0] >= 0
        self.closed, self.which = bool(closed), which
        self.attempts = loop_closing.fold_attempts(cands, tried, accepted, gates)


def background_step(m: MapState, loop_state: loop_closing.LoopState, did_kf, kf_id,
                    interrupt_ba, caps: MapCaps, cam: Camera, scale_factors: torch.Tensor,
                    with_loop: bool = False, bow_group_div: int = 0, inline_close: bool = True
                    ) -> Tuple[MapState, loop_closing.LoopState, BackgroundOut]:
    """The work the reference runs off the tracking thread, for one frame:
    the local-mapping chain, then (``with_loop``) loop detection and, for a
    confirmed candidate, the Sim3 verification of every confirmed candidate
    in turn until one is accepted and the loop correction, serially after
    detection (the reference's LoopClosing thread order, loopClosing.cpp:
    17-37; the JAX package's ``_background_one``).

    The close runs under a ``graphs.cond`` on the best confirmed candidate
    (``loop_closing.close_detected``), its outcome on the device in
    ``close``. Eager (host ``did_kf``/``kf_id``), a keyframe event reads its
    confirmed candidates back, closes inside the ``close_step`` profiler
    range and reads the outcome into the host fields (``fold``); in a step
    program nothing is read back. Without ``inline_close`` (the VO_LOOP_DIAG
    path) nothing is verified here: the candidates stay on the device in
    ``cands``/``cand_gens`` for the host's drain."""
    m, n1, n2 = _mapping_step(m, did_kf, kf_id, caps, cam, scale_factors,
                              interrupt_ba=interrupt_ba, bow_group_div=bow_group_div)
    out = BackgroundOut(ba_n1=n1, ba_n2=n2)
    if not with_loop:
        return m, loop_state, out
    with graphs_mod.span("loop_detect"):
        loop_state, out.cands, out.cand_gens = loop_closing.detect_step(
            m, loop_state, did_kf, kf_id, caps)
    if inline_close:
        with graphs_mod.span("loop_close"):
            m, loop_state, out.close = loop_closing.close_detected(
                m, loop_state, did_kf & (kf_id >= 0), kf_id, out.cands, out.cand_gens,
                bow_group_div, caps, cam, scale_factors)
        if out.close is not None and not graphs_mod.traced():
            out.fold(*graphs_mod.fetch(out.cands, *out.close.leaves()))
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


def track_program(inputs, carry, *, caps: MapCaps, spec: PyramidSpec, budgets, fast_hi: float,
                  fast_lo: float, max_frame_gap: int, reloc_parity: bool):
    """The tracking program: ``_slam_step`` as the body of a ``scan`` over
    the frame buffers' trips [start, start + n) (the JAX package's
    ``track_chunk``): ((camera, vocabulary or None, scale_factors,
    inv_level_sigma2): the traced constants, [K] grays, depths, timestamps,
    (start, n, end)) and (state, map) -> ((state, map), the per-frame
    (SlamOut, new keyframe id, descriptors, their valid mask) stacked [K,
    ...]). The statics are bound by keyword: nothing here belongs to one
    system, so every system of one static configuration shares the
    program. The scan's own copying is the span ``carry``."""
    (cam, voc, scale_factors, inv_level_sigma2), grays, depths, stamps, (start, n, _) = inputs

    def body(i, carry, frame):
        state, m = carry
        state, m, out, new_kf = _slam_step(
            state, m, *frame, cam, caps, spec, budgets, scale_factors, inv_level_sigma2,
            fast_hi, fast_lo, max_frame_gap, voc, reloc_parity)
        return (state, m), (out, new_kf, state.feats.desc, state.feats.valid)

    return graphs_mod.scan(body, carry, (grays, depths, stamps), start=start, n=n, name="frames",
                          carry_span="carry")


def background_program(inputs, carry, *, caps: MapCaps, with_loop: bool, bow_group_div: int,
                       inline_close: bool):
    """The background program: ``background_step`` as the body of a
    ``scan`` over the events' trips [start, start + n) (the JAX package's
    ``background_chunk``), each event's interruptBA its forced flag or
    ``chunk_ba_stops`` over the events before ``end``, on the device:
    ((camera, scale_factors): the traced constants, [K] made a keyframe, its
    id, forced stop, (start, n, end)) and the map (and, ``with_loop``, the
    loop state) -> (the same, (BA iterations pass 1, pass 2[, the confirmed
    loop candidates, their generations, the close's outcome]) stacked [K,
    ...]). The statics are bound by keyword, as ``track_program``'s."""
    (cam, scale_factors), did, kid, forced, (start, n, end) = inputs
    window = torch.arange(did.shape[0], device=did.device) < end
    stops = chunk_ba_stops(did & window) | forced

    def body(i, carry, event):
        m, ls = carry if with_loop else (carry, None)
        m, ls, bg = background_step(m, ls, *event, caps, cam, scale_factors, with_loop,
                                    bow_group_div, inline_close)
        if with_loop:
            return (m, ls), (bg.ba_n1, bg.ba_n2, bg.cands, bg.cand_gens, bg.close)
        return m, (bg.ba_n1, bg.ba_n2)

    return graphs_mod.scan(body, carry, (did, kid, stops), start=start, n=n, name="events",
                          carry_span="carry")


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
    loop-candidate readbacks of the VO_LOOP_DIAG path (module docstring).

    ``graphs`` (default: on for the card, with or without a vocabulary, off
    on the CPU): the steps as ``utils.graphs.StepGraph`` programs (module
    docstring). On the card they are captured CUDA graphs with conditional
    nodes, and a capture that fails raises; on the CPU they run in
    ``select`` mode under ``no_host_reads``, the stand-in for a replay.
    ``graphs=False`` keeps the eager path. Under graphs each frame's
    ``made_kf``, the ``ba_iters``/``n_ba_interrupts`` records and the loop
    records (``loop_attempts``, ``loop_gates``, ``loop_closures``) stay on
    the device until they are read (``results()``, or with global BA the
    read after each dispatch), and ``state``/``map``/``loop_state`` are the
    programs' static buffers, rewritten by this system's next replay. The
    programs (tracking, background, global BA) are the process's for the
    system's static configuration (``track_graph``, ``background_graph`` and
    ``gba_graph`` are this system's shares, with its own replays, warm-up
    and capture seconds and launches): a fresh system
    of a configuration already run replays them at once, and before another
    system's replay takes the static buffers over, this system's tensors
    among them are cloned on the device into tensors of its own, so no
    system sees another's state (``utils.graphs.Program``). A frame's
    relocalization winner (``SlamOut.reloc_winner``) stays on the device on
    both paths until the same read folds it."""

    def __init__(self, cfg: SlamConfig, caps: MapCaps = MapCaps(),
                 device: Optional[Union[str, torch.device]] = None, chunk: int = 1,
                 vocabulary: Optional[bow_voc.Vocabulary] = None, reloc_parity: bool = False,
                 enable_global_ba: bool = False, drain_chunk: int = DRAIN_CHUNK,
                 graphs: Optional[bool] = None):
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
        self._n_folded = 0  # _outs[:_n_folded] have their winners folded (_settle)
        self.timestamps: List[float] = []
        self._frame_id = 0
        # the graph path (class docstring): two step programs sharing nothing
        # but the map (and the loop state) they hand over, each the process's
        # for its key: the statics (the JAX jits' static arguments, the chunk,
        # and the host numbers the programs hold) and the traced constants'
        # shapes, so systems that differ only in intrinsics or vocabulary
        # values share them
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        self._track_consts = (self.camera, self.voc, self.scale_factors, self.inv_level_sigma2)
        self._background_consts = (self.camera, self.scale_factors)
        track_statics = dict(caps=caps, spec=self.spec, budgets=self.budgets,
                             fast_hi=self.fast_hi, fast_lo=self.fast_lo,
                             max_frame_gap=self.max_frame_gap, reloc_parity=self.reloc_parity)
        bg_statics = dict(caps=caps, with_loop=self.enable_loop_closing,
                          bow_group_div=self._bow_group_div, inline_close=self._inline_close)
        held = ("state", "map", "loop_state")
        self.track_graph = graphs_mod.Program(
            "track_chunk", (self.chunk, self.use_bow) + tuple(sorted(track_statics.items()))
            + (graphs_mod.signature(self._track_consts),),
            functools.partial(track_program, **track_statics), self.device, self, held)
        self.background_graph = graphs_mod.Program(
            "background_chunk", (self.chunk,) + tuple(sorted(bg_statics.items()))
            + (graphs_mod.signature(self._background_consts),),
            functools.partial(background_program, **bg_statics), self.device, self, held)
        # global BA after a closure: the process's program for the caps,
        # keyframe 0 (the gauge) held fixed as a device input
        self.gba_graph = global_ba.program(self, caps, self.camera, self.inv_level_sigma2)
        self._gba_fixed = torch.zeros((), dtype=torch.int32, device=self.device)
        self._frame_bufs = None  # the tracking program's [chunk] frame buffers
        # (frame, index in _outs, made, n1, n2, with loop closing (the confirmed
        # candidates, the close's outcome) else None) per background step, on
        # the device
        self._bg_pending: List[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor,
                                     Optional[Tuple[torch.Tensor,
                                                    loop_closing.CloseOut]]]] = []
        # host spans (recorded inside graphs.counting(): module docstring), and
        # per counted program run (its Program, its entry in the Program's
        # replay_log, the host span around it)
        self.spans = graphs_mod.Recorder()
        self._graph_runs: List[Tuple[graphs_mod.Program, int, int]] = []

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
            frame_id=torch.zeros((), dtype=torch.int32, device=dev),
            feats=FrameFeatures.empty(dev, N),
            assign_real=torch.full((N,), -1, dtype=torch.int32, device=dev),
            assign_gen=torch.full((N,), -1, dtype=torch.int32, device=dev),
            T_cr=eye, ref_kf=torch.zeros((), dtype=torch.int32, device=dev), T_cl=eye,
            motion_valid=false, initialized=False, lost=false,
            last_kf_frame=torch.full((), -10_000, dtype=torch.int32, device=dev),
            last_was_kf=false,
            last_reloc_frame=torch.full((), -10_000, dtype=torch.int32, device=dev),
        )

    def track(self, gray: Union[np.ndarray, torch.Tensor], depth: Union[np.ndarray, torch.Tensor],
              timestamp: float) -> None:
        """gray u8 (H, W); depth f32 meters, or u16 raw scaled by the
        config's depth scale on the device. Either may be a tensor already on
        this system's device (frames the caller staged there): it passes
        through untouched, as in the JAX package (a tensor on another device
        raises). With ``chunk`` > 1 the frame is uploaded and buffered; a full
        chunk is tracked and mapped at once."""
        frame = self._frame_id + len(self._chunk_buf)
        with graphs_mod.recording(self.spans), self.spans.span("track", frame):
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

    def _archive(self, desc: torch.Tensor, valid: torch.Tensor) -> None:
        """A frame's descriptors for ``create_vocabulary`` (tensors that no
        later step rewrites)."""
        if len(self._frame_desc) < DESC_ARCHIVE_CAP:
            self._frame_desc.append((desc, valid))

    # ---- the graph path ----------------------------------------------------

    def _run_program(self, sg: graphs_mod.Program, data: tuple, carry, lo: int, hi: int,
                     span: str):
        """``sg`` over the trips [lo, hi) (``track_program``/``background_program``;
        ``hi`` is also the events' end for ``chunk_ba_stops``) -> (carry,
        [(first trip, trips, outputs)] per call), each call inside the host
        span ``span``. A program not yet warmed up
        (by any system) runs its first trip alone in select mode (the
        warm-up, host ints for the range) and the rest in the next call,
        which captures it; every later call is one replay with the range as
        device ints."""
        def dev_int(v):
            return torch.full((), v, dtype=torch.int64, device=self.device)

        calls = [(lo, 1), (lo + 1, hi - lo - 1)] if not sg.step().warmed else [(lo, hi - lo)]
        done = []
        for start, k in calls:
            if k <= 0:
                continue
            with self.spans.span(span, self._frame_id + start):
                warmed = sg.step().warmed
                rng = (start, k, hi) if not warmed else tuple(map(dev_int, (start, k, hi)))
                logged = len(sg.replay_log)
                carry, ys = sg.run(data + (rng,), carry)
                if len(sg.replay_log) > logged:
                    self._graph_runs.append((sg, logged, self.spans.current()))
            done.append((start, k, ys))
        return carry, done

    def _stage(self, buf) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The frames of ``buf`` in rows 0.. of the tracking program's [K]
        frame buffers (device copies, the timestamps filled on the device)."""
        if self._frame_bufs is None:
            g0, d0, _ = buf[0]
            self._frame_bufs = (
                torch.zeros((self.chunk,) + tuple(g0.shape), dtype=g0.dtype, device=self.device),
                torch.zeros((self.chunk,) + tuple(d0.shape), dtype=d0.dtype, device=self.device),
                torch.zeros((self.chunk,), dtype=torch.float32, device=self.device))
        grays, depths, stamps = self._frame_bufs
        for k, (g, d, ts) in enumerate(buf):
            grays[k].copy_(g)
            depths[k].copy_(d)
            stamps[k].fill_(float(ts))
        return self._frame_bufs

    def _graph_dispatch(self, buf) -> None:
        """The graph path for the frames of ``buf`` (a chunk, or one frame):
        the tracking program over them, then the background program over
        their events, one replay each once both are captured. The first
        frame flips the host flag ``initialized`` and runs outside the
        program, in select mode (nothing read back)."""
        with self.spans.span("stage"):
            grays, depths, stamps = self._stage(buf)
        rows = []  # per frame: (SlamOut, new keyframe id, descriptors, valid mask)
        first = 0
        if not self.state.initialized:
            # the first frame's spans record nowhere: it runs outside the programs
            with self.spans.span("first_frame", self._frame_id), graphs_mod.recording(None), \
                    graphs_mod.use("select"), graphs_mod.no_host_reads():
                self.state, self.map, out, new_kf = _slam_step(
                    self.state, self.map, grays[0], depths[0], stamps[0], self.camera,
                    self.caps, self.spec, self.budgets, self.scale_factors,
                    self.inv_level_sigma2, self.fast_hi, self.fast_lo, self.max_frame_gap,
                    self.voc, self.reloc_parity)
                # the outputs must not alias buffers a later capture rewrites
                rows.append(graphs_mod.tree_map(torch.clone, (
                    out, new_kf, self.state.feats.desc, self.state.feats.valid)))
            first = 1
        calls = []
        if first < len(buf):
            (self.state, self.map), calls = self._run_program(
                self.track_graph, (self._track_consts, grays, depths, stamps),
                (self.state, self.map), first, len(buf), "track_replay")
        with self.spans.span("outputs"):
            for start, k, ys in calls:
                rows += [graphs_mod.tree_map(lambda x, j=j: x[j], ys)
                         for j in range(start, start + k)]
            for _, _, desc, valid in rows:
                self._archive(desc, valid)
            at = len(self._outs)
            self._outs += [out for out, _, _, _ in rows]
            self.timestamps += [ts for _, _, ts in buf]
            made = torch.stack([out.made_kf for out, _, _, _ in rows])
            new_kf = torch.stack([kf for _, kf, _, _ in rows])
            stops = torch.full((len(buf),), self._ba_interrupt(), dtype=torch.bool,
                               device=self.device)
        self._graph_background_steps(at, made, new_kf, stops)
        self._frame_id += len(buf)

    def _graph_background_steps(self, first: int, made, new_kf, stops) -> None:
        """The background program over the events of ``_outs[first:]``
        (``made``, ``new_kf`` and the forced ``stops``: one row each), in
        order, each keyframe event's loop close inside it. Nothing is read
        back: the counts and the close's outcome stay on the device until
        ``results()`` (``_settle``), as the JAX package keeps them
        (``_queue_close_results``). With global BA, one read after the
        dispatch folds them and runs global BA after each closure (the JAX
        package reads its close results synchronously then); the VO_LOOP_DIAG
        path queues the candidates for its drain instead."""
        n = made.shape[0]
        pad = self.chunk - n  # the program's event buffers hold a chunk
        data = tuple(torch.cat([x.to(dt), torch.full((pad,), v, dtype=dt, device=x.device)])
                     for x, v, dt in ((made, False, torch.bool), (new_kf, -1, torch.int32),
                                      (stops, False, torch.bool)))
        carry = (self.map, self.loop_state) if self.enable_loop_closing else self.map
        with self.spans.span("background"):
            carry, calls = self._run_program(self.background_graph,
                                             (self._background_consts,) + data, carry, 0, n,
                                             "background_replay")
        if self.enable_loop_closing:
            self.map, self.loop_state = carry
        else:
            self.map = carry
        queued = []
        for start, k, ys in calls:
            for j in range(start, start + k):
                frame, i = self._frame_id + j, first + j
                n1, n2 = ys[0][j], ys[1][j]
                loop = None
                if self.enable_loop_closing:
                    cands, gens, close = ys[2][j], ys[3][j], ys[4]
                    if close is not None:
                        loop = (cands, graphs_mod.tree_map(lambda x, j=j: x[j], close))
                    if not self._inline_close:
                        queued.append((frame, cands, gens, self._outs[i]))
                self._bg_pending.append((frame, i, data[0][j], n1, n2, loop))
        if self.enable_global_ba:
            self._settle()
        if queued:
            frames, cands, gens, outs = zip(*queued)
            self._queue_loop(list(frames), torch.stack(cands), torch.stack(gens),
                             torch.stack([o.ref_kf for o in outs]),
                             torch.stack([o.ref_gen for o in outs]))

    def _settle(self) -> None:
        """Read the pending per-frame records back in one read: every frame's
        relocalization winner not yet folded (both paths), and the graph
        path's per-event ``made_kf``, ``ba_iters``/``n_ba_interrupts`` and,
        with loop closing, each close's outcome, whose loop records are then
        folded in frame order (``_fold_loop``, with global BA after each
        closure when enabled)."""
        with self.spans.span("settle"):
            self._settle_pending()

    def _settle_pending(self) -> None:
        pend, self._bg_pending = self._bg_pending, []
        unfolded = [o for o in self._outs[self._n_folded:] if o.reloc_winner is not None]
        self._n_folded = len(self._outs)
        parts = [o.reloc_winner for o in unfolded]
        for _, _, made, n1, n2, loop in pend:
            parts += [made.reshape(1), n1.reshape(1), n2.reshape(1)]
            if loop is not None:
                parts += [loop[0]] + list(loop[1].leaves())
        if not parts:
            return
        flat = torch.cat([x.reshape(-1).to(torch.int32) for x in parts]).tolist()
        for j, o in enumerate(unfolded):
            o.reloc_winner = fold_winner(flat[4 * j:4 * j + 4])
        at = 4 * len(unfolded)
        events = []
        for frame, i, _, _, _, loop in pend:
            made, n1, n2 = flat[at:at + 3]
            at += 3
            self._outs[i].made_kf = bool(made)
            if made:
                self.ba_iters.append((frame, n1, n2))
                if not (n1 or n2):
                    self.n_ba_interrupts += 1
            if loop is None:
                continue
            vals = []
            for x in [loop[0]] + list(loop[1].leaves()):
                vals.append(flat[at] if x.dim() == 0 else flat[at:at + x.numel()])
                at += x.numel()
            bg = BackgroundOut()
            bg.fold(*vals)
            events.append((frame, bg))
        self._fold_loop(events)

    def _track_one(self, gray_d: torch.Tensor, depth_d: torch.Tensor, timestamp: float) -> None:
        if self.graphs:
            self._graph_dispatch([(gray_d, depth_d, timestamp)])
            return
        self.state, self.map, out, new_kf = _slam_step(
            self.state, self.map, gray_d, depth_d, timestamp, self.camera, self.caps,
            self.spec, self.budgets, self.scale_factors, self.inv_level_sigma2,
            self.fast_hi, self.fast_lo, self.max_frame_gap, self.voc, self.reloc_parity,
        )
        with self.spans.span("background"):
            self.map, self.loop_state, bg = background_step(
                self.map, self.loop_state, out.made_kf, new_kf, self._ba_interrupt(), self.caps,
                self.camera, self.scale_factors, self.enable_loop_closing, self._bow_group_div,
                self._inline_close)
        self._fold_background([(self._frame_id, out.made_kf, bg)])
        if self.enable_loop_closing and not self._inline_close:
            self._queue_loop([self._frame_id], bg.cands[None], bg.cand_gens[None],
                             out.ref_kf.reshape(1), out.ref_gen.reshape(1))
        self._archive(self.state.feats.desc, self.state.feats.valid)
        self._outs.append(out)
        self.timestamps.append(timestamp)
        self._frame_id += 1

    def _dispatch_chunk(self) -> None:
        """Track the buffered frames, then map their keyframe events."""
        buf, self._chunk_buf = self._chunk_buf, []
        if self.graphs:
            self._graph_dispatch(buf)
            return
        self.state, self.map, outs, new_kfs, feats = track_chunk(
            self.state, self.map, buf, self.camera, self.caps, self.spec, self.budgets,
            self.scale_factors, self.inv_level_sigma2, self.fast_hi, self.fast_lo,
            self.max_frame_gap, self.voc, self.reloc_parity)
        did = [o.made_kf for o in outs]
        with self.spans.span("background"):
            self.map, self.loop_state, bgs = background_chunk(
                self.map, self.loop_state, did, new_kfs, self._ba_interrupt(), self.caps,
                self.camera, self.scale_factors, self.enable_loop_closing, self._bow_group_div,
                self._inline_close)
        self._fold_background([(self._frame_id + k, made, bg)
                               for k, (made, bg) in enumerate(zip(did, bgs))])
        if self.enable_loop_closing and not self._inline_close:
            self._queue_loop(list(range(self._frame_id, self._frame_id + len(buf))),
                             torch.stack([bg.cands for bg in bgs]),
                             torch.stack([bg.cand_gens for bg in bgs]),
                             torch.stack([o.ref_kf for o in outs]),
                             torch.stack([o.ref_gen for o in outs]))
        for f in feats:
            self._archive(f.desc, f.valid)
        self._outs += outs
        self.timestamps += [t for _, _, t in buf]
        self._frame_id += len(buf)

    def _fold_background(self, events) -> None:
        """Record (frame, made a keyframe, BackgroundOut) per frame of one
        eager background dispatch, then its loop attempts (``_fold_loop``)."""
        for frame, made, bg in events:
            if made:
                self.ba_iters.append((frame, bg.ba_n1, bg.ba_n2))
                if not (bg.ba_n1 or bg.ba_n2):
                    self.n_ba_interrupts += 1
        self._fold_loop([(frame, bg) for frame, _, bg in events])

    def _fold_loop(self, events) -> None:
        """Record (frame, BackgroundOut) per frame's loop attempts; after
        them, the global BA for each closure when enabled (the JAX package
        runs it when it collects the closure)."""
        for frame, bg in events:
            if bg.attempted:
                self.loop_attempts.append((frame, bg.which, bg.closed))
                self.loop_gates += [(frame, c, a, g) for c, a, g in bg.attempts]
            if bg.closed:
                self.loop_closures.append(frame)
                if self.enable_global_ba:
                    self._global_ba()

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
            with self.spans.span("close_step"):
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
                self._global_ba()
            break

    def _global_ba(self) -> None:
        """The upstream global BA after an accepted closure (keyframe 0
        fixed): the step program with ``graphs`` (the map in and out through
        its static buffers), else the same function eagerly."""
        with self.spans.span("global_bundle"):
            if self.graphs:
                self.map, _ = self.gba_graph.run(
                    (self.camera, self.inv_level_sigma2, self._gba_fixed), self.map)
            else:
                self.map = global_ba.global_bundle_adjust(
                    self.map, self.caps, self.camera, 0, inv_level_sigma2=self.inv_level_sigma2)

    def _flush(self) -> None:
        """Track the frames of an incomplete chunk one at a time."""
        buf, self._chunk_buf = self._chunk_buf, []
        for gray_d, depth_d, ts in buf:
            self._track_one(gray_d, depth_d, ts)

    def results(self):
        """Blocks; returns (trajectory T_w_c [F,4,4], stats, kf_traj)."""
        with graphs_mod.recording(self.spans), self.spans.span("results", self._frame_id):
            return self._results()

    def _results(self):
        self._flush()
        self._settle()
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

    def trace(self) -> dict:
        """This system's spans and counters (module docstring; recorded
        inside ``graphs.counting()``) with the card's stamps on the host's
        ``time.perf_counter_ns`` clock (``graphs.to_host``; one more
        calibration now, which synchronizes the card):

        - ``spans``: one dict per span (``frame``, ``name``, ``start_ns``,
          ``end_ns``, ``parent``: the index of the span it ran under, -1
          none): the host spans in the order opened, then per counted
          program run its ``launch`` (the launch call, under the run's host
          span) and the replay on the device (``tracking_graph`` or
          ``background_graph``: its first stamp to its last, under its
          ``launch``);
        - ``stages``, ``node_runs`` and ``graph_nodes``: per program
          (``tracking``, ``background``), ``Program.spans``,
          ``Program.node_runs`` and ``Program.graph_nodes_run``;
        - ``clock``: ``graphs.clock`` (its error bound ``error_ns``; None off
          the card)."""
        graphs_mod.calibrate(self.device)
        spans = [dict(frame=f, name=n, start_ns=a, end_ns=b, parent=p)
                 for f, n, a, b, p in self.spans.records]
        progs = {"tracking": self.track_graph, "background": self.background_graph}
        times = {}
        for prog, i, parent in self._graph_runs:
            if prog not in times:
                times[prog] = prog.replay_times()
            t = times[prog][i]
            if t is None:
                continue
            kind = "tracking" if prog is self.track_graph else "background"
            frame = spans[parent]["frame"] if parent >= 0 else -1
            spans.append(dict(frame=frame, name="launch", start_ns=t[0], end_ns=t[1],
                              parent=parent))
            spans.append(dict(frame=frame, name=f"{kind}_graph", start_ns=t[2], end_ns=t[3],
                              parent=len(spans) - 1))
        return dict(spans=spans, stages={k: p.spans() for k, p in progs.items()},
                    node_runs={k: p.node_runs() for k, p in progs.items()},
                    graph_nodes={k: p.graph_nodes_run() for k, p in progs.items()},
                    clock=graphs_mod.clock(self.device))

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
