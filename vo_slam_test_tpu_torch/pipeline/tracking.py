"""Frame-to-frame visual odometry (port of ``FrameToFrameTracker``,
``FusedTracker`` and ``track_step`` in ``vo_slam_test_tpu/pipeline/tracking.py``).

Each frame: ORB extraction, temporary 3D points from the last frame's depth
(closest-100-or-thDepth rule), projection search at r=15 with an r=30 retry
when it finds < 20 matches, and the two-round pose-only solve; the frame is
tracked with >= 20 matches and >= 10 inliers (visualOdometry.cpp:225-255).

Host synchronization: the JAX package branches with ``lax.cond`` on device
scalars; here the r=30 retry is ``utils.graphs.cond`` on the r=15 match
count. The first-frame branch is a host bool (the state's ``initialized``).
``FusedTracker`` on the card replays a captured CUDA graph of the step from
its third frame on (the first frame runs outside it and the second is the
graph's warm-up, both in ``select`` mode): the retry is a conditional node
and nothing is read back until ``results()``. The step program is the
process's for the tracker's static configuration (``fused_step``, whose
traced constants are the camera's tensors and the scale tables): a second
tracker of the same configuration, with any intrinsics, replays it from its
second frame, with no warm-up and no capture. With ``graphs=False`` (the
CPU's default) the step runs eagerly and the retry reads the r=15 count
back: one host sync per frame after the first. The pose solve's round-2
branch is computed on both sides and selected with ``torch.where`` (no
sync). ``FrameToFrameTracker`` is the
host-synchronous path: the host-quadtree ``OrbExtractor`` and the
reference's integer gates read on the host, as the JAX package reads them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import lie, resolve_device
from ..camera import Camera
from ..config import SlamConfig
from ..frontend.extractor import OrbExtractor, extract_fused, upload
from ..frontend.frame import FrameFeatures
from ..matching import matcher
from ..ops.pyramid import PyramidSpec
from ..solvers import pose_only
from ..utils import graphs as graphs_mod


def _spawn_temp_points(feats: FrameFeatures, T_c_w: torch.Tensor, cam: Camera
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project keypoints with depth into world points -> (p_world [N,3],
    valid [N]): points sorted by increasing depth are kept while depth <=
    thDepth, and the closest 101 always (the reference breaks after spawning
    the point that makes the count exceed 100)."""
    d = feats.depth
    has_d = (d > 0) & feats.valid
    pw = cam.pixel2world(feats.uv_und, torch.where(has_d, d, 1.0), T_c_w)
    key = torch.where(has_d, d, torch.inf)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0], device=d.device))
    valid = has_d & ((d <= cam.th_depth) | (rank <= 100))
    return pw, valid


def _match_and_solve(
    curr: FrameFeatures,
    last: FrameFeatures,
    last_points: torch.Tensor,
    last_pt_valid: torch.Tensor,
    T_pred: torch.Tensor,
    T_last: torch.Tensor,
    scale_factors: torch.Tensor,
    inv_level_sigma2: torch.Tensor,
    cam: Camera,
    radius: float,
    check_rot: bool = True,
):
    """One projection-search + pose-solve attempt at the given radius ->
    (T, inlier_mask, n_inliers, n_matches, assign)."""
    res = matcher.search_by_projection_frame(
        p_world=last_points, src_desc=last.desc, src_octave=last.octave,
        src_angle=last.angle, src_valid=last_pt_valid,
        tgt_uv_und=curr.uv_und, tgt_u_right=curr.u_right, tgt_octave=curr.octave,
        tgt_angle=curr.angle, tgt_desc=curr.desc, tgt_valid=curr.valid,
        tgt_blocked=torch.zeros_like(curr.valid),
        T_c_w=T_pred, T_l_w=T_last, scale_factors=scale_factors,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.bf, b=cam.b,
        width=float(cam.width), height=float(cam.height),
        radius=radius, check_rot=check_rot,
    )
    # duplicate targets: the largest source index wins (the reference
    # overwrites in source order); unmatched rows go to a dump slot
    n_src = res.idx.shape[0]
    n_tgt = curr.valid.shape[0]
    matched = res.idx >= 0
    tgt = torch.where(matched, res.idx, n_tgt).long()
    src_ids = torch.arange(n_src, dtype=torch.int32, device=tgt.device)
    assign = torch.full((n_tgt + 1,), -1, dtype=torch.int32, device=tgt.device)
    assign.scatter_reduce_(0, tgt, torch.where(matched, src_ids, -1), "amax", include_self=True)
    assign = assign[:n_tgt]

    has_pt = assign >= 0
    obs = pose_only.PoseObs(
        p_world=last_points[assign.clamp(min=0).long()],
        uv=curr.uv_und,
        u_right=torch.where(has_pt, curr.u_right, -1.0),
        inv_sigma2=inv_level_sigma2[curr.octave.long()],
        valid=has_pt,
    )
    T_new, inlier_mask, n_inliers = pose_only.solve_pose_only(
        T_pred, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, fast=True
    )
    return T_new, inlier_mask, n_inliers, res.count, assign


@dataclasses.dataclass
class TrackStats:
    n_features: int = 0
    n_matches: int = 0
    n_inliers: int = 0
    ok: bool = False


class FrameToFrameTracker:
    """Frame-to-frame VO over an RGB-D stream with host-synchronous gates:
    per frame the extractor's candidate read, the feature count, the r=15
    match count (and the r=30 one on a retry), the inlier count and the pose
    are read on the host. ``track`` returns the frame's TrackStats."""

    def __init__(self, cfg: SlamConfig, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.camera = Camera.from_config(cfg, self.device)
        self.extractor = OrbExtractor(
            self.camera,
            n_features=cfg.num_of_features,
            scale_factor=cfg.scale_factor,
            n_levels=cfg.level_pyramid,
            fast_hi=cfg.ini_fast_threshold,
            fast_lo=cfg.min_fast_threshold,
        )
        spec = self.extractor.spec
        self.scale_factors = torch.as_tensor(spec.scales, device=self.device)
        self.inv_level_sigma2 = torch.as_tensor(spec.inv_level_sigma2, device=self.device)

        self.last_feats: Optional[FrameFeatures] = None
        self.T_last = torch.eye(4, dtype=torch.float32, device=self.device)  # T_c_w of last frame
        self.T_cl = self.T_last.clone()                                      # motion model
        self.motion_valid = False
        self.trajectory: List[np.ndarray] = []  # T_w_c per frame
        self.timestamps: List[float] = []
        self.states: List[bool] = []
        self.stats: List[TrackStats] = []

    def track(self, gray: np.ndarray, depth: np.ndarray, timestamp: float) -> TrackStats:
        """gray u8 (H, W), depth f32 meters (H, W)."""
        feats = self.extractor(gray, depth)
        st = TrackStats(n_features=int(feats.valid.sum()))

        if self.last_feats is None:
            T = torch.eye(4, dtype=torch.float32, device=self.device)
            st.ok = True
        else:
            T_pred = (self.T_cl @ self.T_last) if self.motion_valid else self.T_last
            last_points, last_valid = _spawn_temp_points(self.last_feats, self.T_last, self.camera)

            def attempt(radius):
                return _match_and_solve(feats, self.last_feats, last_points, last_valid, T_pred,
                                        self.T_last, self.scale_factors, self.inv_level_sigma2,
                                        self.camera, radius)

            T, _, n_inl, n_match, _ = attempt(15.0)
            n_match_i = int(n_match)
            if n_match_i < 20:  # widen the window (visualOdometry.cpp:242-246)
                T, _, n_inl, n_match, _ = attempt(30.0)
                n_match_i = int(n_match)
            st.n_matches = n_match_i
            st.n_inliers = int(n_inl)
            st.ok = n_match_i >= 20 and st.n_inliers >= 10
            if not st.ok:
                T = T_pred  # hold the prediction: no relocalization here

        if self.last_feats is not None:
            self.T_cl = T @ lie.se3_inverse(self.T_last)
            self.motion_valid = st.ok
        self.T_last = T
        self.last_feats = feats
        self.trajectory.append(lie.se3_inverse(T).cpu().numpy())
        self.timestamps.append(timestamp)
        self.states.append(st.ok)
        self.stats.append(st)
        return st


@dataclasses.dataclass
class TrackState:
    """Tracking state; all tensors stay on the device."""

    feats: FrameFeatures       # last frame's features
    T_c_w: torch.Tensor        # [4,4] last pose
    T_cl: torch.Tensor         # [4,4] motion model (curr <- last)
    motion_valid: torch.Tensor  # bool scalar
    initialized: bool          # host-known: False only before the first frame


@dataclasses.dataclass
class TrackOut:
    T_c_w: torch.Tensor
    ok: torch.Tensor
    n_features: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor


def track_step(
    gray: torch.Tensor,
    depth_img: torch.Tensor,
    state: TrackState,
    cam: Camera,
    spec: PyramidSpec,
    budgets: Tuple[int, ...],
    scale_factors: torch.Tensor,
    inv_level_sigma2: torch.Tensor,
    fast_hi: float,
    fast_lo: float,
) -> Tuple[TrackState, TrackOut]:
    """One frame of VO: extract, match at r=15 (r=30 retry), solve, update
    the motion model."""
    dev = gray.device
    feats = extract_fused(gray, depth_img, cam, spec, budgets, fast_hi, fast_lo)
    n_feats = feats.valid.sum(dtype=torch.int32)
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    if not state.initialized:
        T_new = eye
        ok = torch.ones((), dtype=torch.bool, device=dev)
        n_m = torch.zeros((), dtype=torch.int32, device=dev)
        n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        T_last = state.T_c_w
        T_pred = torch.where(state.motion_valid, state.T_cl @ T_last, T_last)
        last_pts, last_valid = _spawn_temp_points(state.feats, T_last, cam)

        def attempt(radius):
            return _match_and_solve(feats, state.feats, last_pts, last_valid, T_pred, T_last,
                                    scale_factors, inv_level_sigma2, cam, radius)

        def retry():
            T, _, n_i, n, _ = attempt(30.0)
            return T, n_i, n

        T_new, _, n_inl, n_m, _ = attempt(15.0)
        # widen the window (visualOdometry.cpp:242-246): a conditional node
        # in a captured step, one host read when eager
        T_new, n_inl, n_m = graphs_mod.cond(n_m < 20, retry, lambda: (T_new, n_inl, n_m))
        ok = (n_m >= 20) & (n_inl >= 10)
        T_new = torch.where(ok, T_new, T_pred)

    tracked = ok & state.initialized
    T_cl = torch.where(tracked, T_new @ lie.se3_inverse(state.T_c_w), eye)
    new_state = TrackState(feats=feats, T_c_w=T_new, T_cl=T_cl, motion_valid=tracked,
                           initialized=True)
    out = TrackOut(T_c_w=T_new, ok=ok, n_features=n_feats, n_matches=n_m, n_inliers=n_inl)
    return new_state, out


def fused_step(inputs, state: TrackState, *, spec: PyramidSpec, budgets: Tuple[int, ...],
               fast_hi: float, fast_lo: float) -> Tuple[TrackState, TrackOut]:
    """``FusedTracker``'s step program: ``track_step`` of one frame, with
    ``inputs`` = ((camera, scale_factors, inv_level_sigma2): the traced
    constants, (gray, depth)) and the statics bound by keyword."""
    (cam, scale_factors, inv_level_sigma2), (gray_d, depth_d) = inputs
    return track_step(gray_d, depth_d, state, cam, spec, budgets, scale_factors,
                      inv_level_sigma2, fast_hi, fast_lo)


class FusedTracker:
    """Frame-to-frame VO with the state on the device and an asynchronous
    host loop: per-frame results are read back only by ``results()``.

    ``graphs`` (default: on for the card, off for the CPU): on the card the
    step is the process's ``utils.graphs`` program for the tracker's static
    configuration (``step_graph``, this tracker's share of it: captured at
    the third frame of the first tracker that runs it and replayed from then
    on; a capture failure raises); on the CPU it runs in ``select`` mode
    under ``no_host_reads``, the stand-in for a replay. ``graphs=False``
    runs the step eagerly (one host read per frame)."""

    def __init__(self, cfg: SlamConfig, device: Optional[Union[str, torch.device]] = None,
                 graphs: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.camera = Camera.from_config(cfg, self.device)
        self.spec = PyramidSpec(self.camera.width, self.camera.height,
                                cfg.level_pyramid, cfg.scale_factor)
        self.budgets = self.spec.budget(cfg.num_of_features)
        self.scale_factors = torch.as_tensor(self.spec.scales, device=self.device)
        self.inv_level_sigma2 = torch.as_tensor(self.spec.inv_level_sigma2, device=self.device)
        self.fast_hi = float(cfg.ini_fast_threshold)
        self.fast_lo = float(cfg.min_fast_threshold)
        self.graphs = self.device.type == "cuda" if graphs is None else bool(graphs)
        self._consts = (self.camera, self.scale_factors, self.inv_level_sigma2)
        statics = dict(spec=self.spec, budgets=self.budgets, fast_hi=self.fast_hi,
                       fast_lo=self.fast_lo)
        self._step = functools.partial(fused_step, **statics)
        self.step_graph = graphs_mod.Program(
            "track_step", tuple(sorted(statics.items())) + (graphs_mod.signature(self._consts),),
            self._step, self.device, self, ("state",))
        self.state = self.empty_state()
        self._outs: List[TrackOut] = []
        self.timestamps: List[float] = []

    def empty_state(self) -> TrackState:
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        return TrackState(
            feats=FrameFeatures.empty(self.device), T_c_w=eye, T_cl=eye.clone(),
            motion_valid=torch.zeros((), dtype=torch.bool, device=self.device), initialized=False,
        )

    def track(self, gray: Union[np.ndarray, torch.Tensor], depth: Union[np.ndarray, torch.Tensor],
              timestamp: float) -> None:
        """gray u8 (H, W), depth f32 meters (H, W); either may be a tensor
        already on this tracker's device."""
        gray_d = upload(gray, self.device)
        depth_d = upload(depth if isinstance(depth, torch.Tensor)
                         else np.asarray(depth, dtype=np.float32), self.device)
        frame = (gray_d, depth_d)
        if not self.graphs:
            self.state, out = self._step((self._consts, frame), self.state)
        elif not self.state.initialized:
            # the first frame changes the host flag ``initialized``: it runs
            # outside the graph, with nothing read back all the same
            with graphs_mod.use("select"), graphs_mod.no_host_reads():
                self.state, out = self._step((self._consts, frame), self.state)
        else:
            self.state, out = self.step_graph.run((self._consts, frame), self.state)
        self._outs.append(out)
        self.timestamps.append(timestamp)

    def results(self):
        """Blocks (one read of every frame's results) and returns
        (trajectory T_w_c [F,4,4], stats list)."""
        if not self._outs:
            return np.zeros((0, 4, 4)), []
        packed = torch.cat([
            torch.stack([o.T_c_w for o in self._outs]).reshape(-1, 16).to(torch.float64),
            torch.stack([torch.stack([o.n_features.to(torch.float64), o.n_matches.to(torch.float64),
                                      o.n_inliers.to(torch.float64), o.ok.to(torch.float64)])
                         for o in self._outs])], dim=1).cpu().numpy()
        traj, stats = [], []
        for row in packed:
            traj.append(np.linalg.inv(row[:16].reshape(4, 4).astype(np.float32)))
            stats.append(TrackStats(n_features=int(row[16]), n_matches=int(row[17]),
                                    n_inliers=int(row[18]), ok=bool(row[19])))
        return np.stack(traj), stats
