"""Tracking against the map and the local-mapping chain (port of
``vo_slam_test_tpu/pipeline/system.py`` without a vocabulary).

Each frame runs two steps, as the JAX package's ``SlamSystem.track`` does:

- ``_slam_step``: ORB extraction, trackWithMotion (visualOdometry.cpp:225-255),
  trackLocalMap (:279-311), the keyframe policy (:397-461) and the keyframe
  insertion (:463-517);
- ``background_step``: the local-mapping chain ``_mapping_step`` in the
  reference's order (localMapping.cpp:16-66): map-point culling,
  triangulation, fuse, local BA, keyframe culling.

Not ported yet: BoW tracking against the reference keyframe, relocalization,
loop closing, the chunked programs (``track_chunk``/``background_chunk``) and
the local BA solve itself. Local BA runs only as the interruptBA entry skip
(``SlamSystem._force_interrupt_ba = True``); otherwise it raises.

Host reads per frame: the JAX package branches with ``lax.cond`` on device
scalars; here every branch that decides which kernels run is a host bool.
A tracked frame reads back the r=15 match count (the r=30 retry) and, in
``insert_keyframe``, the keyframe decision with its slot (one read). A
keyframe event adds the triangulation's neighbour gates (one read). The other
branches (a lost frame's attempt, the pose round 2) run both sides and select
with ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import lie, resolve_device
from ..camera import Camera
from ..config import SlamConfig
from ..frontend.extractor import extract_fused
from ..frontend.frame import FrameFeatures
from ..matching import matcher
from ..ops.pyramid import PyramidSpec
from ..slam_map import culling, fuse, local_map, triangulate
from ..slam_map import insert as map_insert
from ..slam_map.map_state import MapCaps, MapState, empty_map, pick, scatter_or
from ..solvers import local_ba, pose_only
from .tracking import TrackStats, _spawn_temp_points


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
    relocalized: bool
    kp_uv: torch.Tensor         # [N,2] raw pixel coords (HUD overlay)
    kp_state: torch.Tensor      # [N] i32: 0 untracked, 1 map-tracked, 2 VO-tracked


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
    matched = res.idx >= 0
    src_ids = torch.arange(N, dtype=torch.int32, device=feats.valid.device)
    winner = torch.full((N + 1,), -1, dtype=torch.int32, device=src_ids.device)
    winner.scatter_reduce_(0, torch.where(matched, res.idx, N).long(),
                           torch.where(matched, src_ids, -1), "amax", include_self=True)
    winner = winner[:N]
    has_m = winner >= 0
    w_safe = winner.clamp(min=0).long()
    kp_pt = torch.where(has_m, state.assign_real[w_safe], -1)
    kp_temp = has_m & (kp_pt < 0)
    kp_pw = last_pw[w_safe]
    T1, kp_pt, kp_temp, n_obs = _solve_and_cull(
        m, feats, T_pred, kp_pt, kp_temp, kp_pw, inv_level_sigma2, cam)
    ok = (res.count >= 20) & (n_obs >= 10)
    return _Attempt(T=T1, kp_pt=kp_pt, kp_temp=kp_temp, kp_pw=kp_pw, n_match=res.count, ok=ok)


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
) -> Tuple[SlamTrackState, MapState, SlamOut, int]:
    """One frame of tracking with the map, without a vocabulary -> (state,
    map, out, new keyframe id or -1)."""
    frame_id = state.frame_id
    dev = gray.device
    feats = extract_fused(gray, depth_img, cam, spec, budgets, fast_hi, fast_lo)
    n_feats = feats.valid.sum(dtype=torch.int32)
    N = caps.n_feat
    P = caps.max_pt
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def insert_kf(m, T, assign, do):
        already = _observed(m, assign)
        create = map_insert.spawn_mask_depth_sorted(feats, already, cam.th_depth)
        return map_insert.insert_keyframe(
            m, caps, feats, T, timestamp, frame_id, assign, create, cam, scale_factors, do=do)

    if not state.initialized:
        # the first frame initializes the map: identity pose, no bindings.
        # (The JAX package runs the tracking attempts here too; on the empty
        # map they find nothing and every count is 0.)
        no_pt = torch.full((N,), -1, dtype=torch.int32, device=dev)
        m, new_kf = insert_kf(m, eye, no_pt, True)
        made = new_kf >= 0
        ref_kf_out = torch.full((), max(new_kf, 0), dtype=torch.int32, device=dev)
        assign_out = m.kf_mp[max(new_kf, 0)] if made else no_pt
        st = SlamTrackState(
            frame_id=frame_id + 1, feats=feats, assign_real=assign_out,
            assign_gen=torch.where(assign_out >= 0, m.pt_gen[assign_out.clamp(min=0).long()], -1),
            T_cr=eye @ lie.se3_inverse(m.kf_pose[max(new_kf, 0)]), ref_kf=ref_kf_out, T_cl=eye,
            motion_valid=torch.zeros((), dtype=torch.bool, device=dev), initialized=True,
            lost=torch.zeros((), dtype=torch.bool, device=dev),
            last_kf_frame=frame_id if made else state.last_kf_frame,
            last_was_kf=made, last_reloc_frame=state.last_reloc_frame,
        )
        out = SlamOut(
            T_c_w=eye, T_cr=st.T_cr, ref_kf=ref_kf_out, ref_gen=m.kf_gen[max(new_kf, 0)],
            ok=torch.ones((), dtype=torch.bool, device=dev), n_features=n_feats,
            n_matches=zero, n_inliers=zero, made_kf=made, relocalized=False,
            kp_uv=feats.uv, kp_state=torch.zeros((N,), dtype=torch.int32, device=dev),
        )
        return st, m, out, new_kf

    # ======================== TRACK ========================================
    T_last = state.T_cr @ pick(m.kf_pose, state.ref_kf)
    fail = _Attempt(T=T_last, kp_pt=torch.full((N,), -1, dtype=torch.int32, device=dev),
                    kp_temp=torch.zeros((N,), dtype=torch.bool, device=dev),
                    kp_pw=torch.zeros((N, 3), device=dev), n_match=zero,
                    ok=torch.zeros((), dtype=torch.bool, device=dev))
    # without a vocabulary there is no ref-KF or relocalization fallback, and
    # motion tracking is attempted from T_last directly; a lost frame's
    # attempt runs and is discarded (a select, not a host read)
    can_motion = ~state.lost & (frame_id >= state.last_reloc_frame + 2)
    a1 = _attempt_motion(state, m, feats, T_last, cam, scale_factors, inv_level_sigma2)
    att = a1.where(can_motion & a1.ok, fail)
    reloc_frame = state.last_reloc_frame
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
        relocalized=False, kp_uv=feats.uv, kp_state=kp_state,
    )
    return st, m, out, new_kf


def _mapping_step(m: MapState, did_kf: bool, kf_id: int, caps: MapCaps, cam: Camera,
                  scale_factors: torch.Tensor, interrupt_ba: bool = False
                  ) -> Tuple[MapState, int, int]:
    """The local-mapping chain for one new keyframe, in the order of
    LocalMapping::run (localMapping.cpp:16-66): cullingMapPoints ->
    createNewMapPoints -> searchInNeighbors (fuse) -> local BA ->
    cullingKeyFrames. Returns (map, BA iterations pass 1, pass 2)."""
    if not (did_kf and kf_id >= 0):
        return m, 0, 0
    m = culling.cull_map_points(m, kf_id, caps)
    m = triangulate.create_new_map_points(m, kf_id, caps, cam, scale_factors)
    m = fuse.search_in_neighbors(m, kf_id, caps, cam, scale_factors)
    m, n1, n2 = local_ba.local_bundle_adjust_iters(
        m, kf_id, caps, cam, 1.0 / (scale_factors * scale_factors), stop=interrupt_ba)
    m = culling.cull_keyframes(m, kf_id, caps, cam)
    return m, n1, n2


def background_step(m: MapState, did_kf: bool, kf_id: int, interrupt_ba: bool, caps: MapCaps,
                    cam: Camera, scale_factors: torch.Tensor, with_loop: bool = False
                    ) -> Tuple[MapState, int, int]:
    """The work the reference runs off the tracking thread. Only the
    local-mapping chain is ported; loop closing is not."""
    if with_loop:
        raise NotImplementedError("loop closing is not ported yet")
    return _mapping_step(m, did_kf, kf_id, caps, cam, scale_factors, interrupt_ba=interrupt_ba)


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
    """Tracking + local mapping over an RGB-D stream, one frame at a time
    (``chunk=1``), without a vocabulary."""

    def __init__(self, cfg: SlamConfig, caps: MapCaps = MapCaps(),
                 device: Optional[Union[str, torch.device]] = None):
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
        # interruptBA (localMapping.cpp:538-541): True skips each local BA at
        # its entry. Local BA is not ported yet, so a keyframe event with
        # the flag lowered raises.
        self._force_interrupt_ba: Optional[bool] = None
        self.ba_iters: List[Tuple[int, int, int]] = []
        self._outs: List[SlamOut] = []
        self.timestamps: List[float] = []
        self._frame_id = 0

    def _ba_interrupt(self) -> bool:
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

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; from pinned memory on the card, so the
        copy does not block the host."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def track(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> None:
        """gray u8 (H, W); depth f32 meters, or u16 raw scaled by the
        config's depth scale on the device."""
        gray_d = self._upload(gray)
        depth_d = self._upload(depth)
        if not torch.is_floating_point(depth_d):
            depth_d = depth_d.to(torch.float32) * (1.0 / float(self.cfg.camera_depthScale))
        self.state, self.map, out, new_kf = _slam_step(
            self.state, self.map, gray_d, depth_d, timestamp, self.camera, self.caps,
            self.spec, self.budgets, self.scale_factors, self.inv_level_sigma2,
            self.fast_hi, self.fast_lo, self.max_frame_gap,
        )
        self.map, n1, n2 = background_step(
            self.map, out.made_kf, new_kf, self._ba_interrupt(), self.caps, self.camera,
            self.scale_factors)
        if out.made_kf:
            self.ba_iters.append((self._frame_id, n1, n2))
        self._outs.append(out)
        self.timestamps.append(timestamp)
        self._frame_id += 1

    def results(self):
        """Blocks; returns (trajectory T_w_c [F,4,4], stats, kf_traj)."""
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

    @property
    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    @property
    def n_points(self) -> int:
        return int(self.map.pt_valid.sum())
