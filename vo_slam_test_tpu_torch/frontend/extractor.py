"""ORB feature extraction (port of ``vo_slam_test_tpu/frontend/extractor.py``).

``extract_fused``, fully on the device: pyramid canvases (raw + u8 blur) ->
FAST score (kernel ``csrc/fast.cu``) -> cell-local NMS, two-threshold retry,
per-cell top-K -> per-level device quad-tree -> compaction into MAX_FEATURES
slots -> IC angle + steered rBRIEF (kernel ``csrc/orb.cu``) -> level-0
coordinates, undistortion, depth and virtual-stereo uRight. No host round
trip.

``OrbExtractor``, the host path: the same stage A up to the per-cell top-K,
one host read of the candidates, the per-level host quad-tree
(``frontend/distribute.py``), then the same stage B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..camera import Camera
from ..ops import fast, orb_cuda, undistort
from ..ops.distribute_device import distribute_level
from ..ops.pyramid import Pyramid, PyramidSpec, build_pyramid, interior
from .distribute import distribute_octtree
from .frame import MAX_FEATURES, FrameFeatures


class Selection(NamedTuple):
    """Keypoints chosen for one frame, compacted into MAX_FEATURES slots."""

    level: torch.Tensor  # [MAX_FEATURES] i32
    ys: torch.Tensor     # [MAX_FEATURES] i32 level-image y
    xs: torch.Tensor     # [MAX_FEATURES] i32 level-image x
    resp: torch.Tensor   # [MAX_FEATURES] f32
    valid: torch.Tensor  # [MAX_FEATURES] bool


@functools.lru_cache(maxsize=8)
def _scales(spec: PyramidSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(spec.scales, device=device)


def _stage_b(
    pyr: Pyramid,
    spec: PyramidSpec,
    sel: Selection,
    depth_img: torch.Tensor,
    cam: Camera,
) -> FrameFeatures:
    level, ys, xs, resp, valid = sel
    ang, desc = orb_cuda.orb_angle_desc(pyr.raw, pyr.blur, level, ys, xs)

    s = _scales(spec, level.device)[level.long()]
    uv = torch.stack([xs.to(torch.float32) * s, ys.to(torch.float32) * s], dim=-1)
    if cam.any_dist:
        uv_und = undistort.undistort_points(uv, cam.fx, cam.fy, cam.cx, cam.cy, cam.dist_coef)
    else:
        uv_und = uv

    # depth lookup at rounded raw coords (half to even, like jnp.rint)
    H, W = depth_img.shape
    ui = torch.clamp(torch.round(uv[:, 0]).long(), 0, W - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).long(), 0, H - 1)
    d = depth_img[vi, ui]
    has_d = (d > 0) & valid
    depth = torch.where(has_d, d, -1.0)
    u_right = cam.u_right(uv_und[:, 0], depth)

    v1 = valid[:, None]
    return FrameFeatures(
        uv=torch.where(v1, uv, 0.0),
        uv_und=torch.where(v1, uv_und, 0.0),
        response=torch.where(valid, resp, 0.0),
        angle=torch.where(valid, ang, 0.0),
        octave=torch.where(valid, level, 0),
        depth=depth,
        u_right=u_right,
        desc=torch.where(v1, desc, 0),
        valid=valid,
    )


def select_keypoints(
    pyr: Pyramid,
    spec: PyramidSpec,
    budgets: Tuple[int, ...],
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    top_k: int = 8,
) -> Selection:
    """FAST candidates, per-level quad-tree distribution and compaction."""
    cands = fast.detect_pyramid(interior(pyr.raw, spec), spec, threshold_hi, threshold_lo, top_k)
    L = spec.n_levels
    M = cands.ys.shape[1] * cands.ys.shape[2]
    ys = cands.ys.reshape(L, M)
    xs = cands.xs.reshape(L, M)
    resp = cands.response.reshape(L, M)
    valid = cands.valid.reshape(L, M)

    b = float(fast.DETECT_BORDER)
    keeps = []
    for lvl in range(L):
        h, w = spec.sizes[lvl]
        n_ini = max(int(round((w - 2 * b) / (h - 2 * b))), 1)
        keeps.append(distribute_level(xs[lvl], ys[lvl], resp[lvl], valid[lvl],
                                      (b, w - b, b, h - b), budgets[lvl], n_ini=n_ini))
    flat_keep = torch.stack(keeps).reshape(-1)

    # compact selected candidates into MAX_FEATURES slots; overflow and
    # unselected entries go to a dump slot that is cut off
    dev = flat_keep.device
    pos = torch.cumsum(flat_keep.to(torch.int64), dim=0) - 1
    slot = torch.where(flat_keep & (pos < MAX_FEATURES), pos, MAX_FEATURES)

    def compact(v):
        out = torch.zeros((MAX_FEATURES + 1,), dtype=v.dtype, device=dev)
        return out.scatter_(0, slot, v)[:MAX_FEATURES]

    flat_lvl = torch.arange(L, dtype=torch.int32, device=dev).repeat_interleave(M)
    n_sel = flat_keep.sum()
    return Selection(
        level=compact(flat_lvl),
        ys=compact(ys.reshape(-1)),
        xs=compact(xs.reshape(-1)),
        resp=compact(resp.reshape(-1).to(torch.float32)),
        valid=torch.arange(MAX_FEATURES, device=dev) < torch.clamp(n_sel, max=MAX_FEATURES),
    )


def extract_fused(
    gray: torch.Tensor,
    depth_img: torch.Tensor,
    cam: Camera,
    spec: PyramidSpec,
    budgets: Tuple[int, ...],
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    top_k: int = 8,
) -> FrameFeatures:
    """Whole ORB front end on the device: gray u8 [H, W], depth f32 [H, W]
    meters -> FrameFeatures."""
    pyr = build_pyramid(gray, spec)
    sel = select_keypoints(pyr, spec, budgets, threshold_hi, threshold_lo, top_k)
    return _stage_b(pyr, spec, sel, depth_img, cam)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; on the card from pinned memory, so
    the copy does not block the host (a copy from pageable memory does)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class OrbExtractor:
    """The reference ORBextractor::operator() (ORBextractor.h:59-61) with the
    host quad-tree: stage A on the camera's device, one host read of the
    candidates, the quad-tree per level on the host, stage B on the device."""

    def __init__(
        self,
        camera: Camera,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        fast_hi: int = 20,
        fast_lo: int = 7,
        cell_top_k: int = 8,
    ):
        self.camera = camera
        self.device = camera.fx.device
        self.spec = PyramidSpec(camera.width, camera.height, n_levels, scale_factor)
        self.n_features = n_features
        self.budget = self.spec.budget(n_features)
        self.fast_hi = float(fast_hi)
        self.fast_lo = float(fast_lo)
        self.cell_top_k = cell_top_k

    def _distribute(self, cands: fast.CellCandidates) -> Tuple[np.ndarray, ...]:
        """Host quadtree over stage-A candidates (numpy) -> padded selection
        arrays (level, y, x, response, valid)."""
        L = self.spec.n_levels
        ys, xs, resp, valid = (np.asarray(a).reshape(L, -1) for a in cands)

        sel_level, sel_y, sel_x, sel_r = [], [], [], []
        b = fast.DETECT_BORDER
        for lvl in range(L):
            m = valid[lvl]
            if not m.any():
                continue
            lx, ly, lr = xs[lvl][m], ys[lvl][m], resp[lvl][m]
            h, w = self.spec.sizes[lvl]
            keep = distribute_octtree(
                lx.astype(np.float32), ly.astype(np.float32), lr,
                b, w - b, b, h - b, self.budget[lvl],
            )
            sel_level.append(np.full(keep.size, lvl, np.int32))
            sel_x.append(lx[keep])
            sel_y.append(ly[keep])
            sel_r.append(lr[keep])

        if sel_level:
            level = np.concatenate(sel_level)
            x = np.concatenate(sel_x).astype(np.int32)
            y = np.concatenate(sel_y).astype(np.int32)
            r = np.concatenate(sel_r).astype(np.float32)
        else:
            level = np.empty(0, np.int32)
            x = y = np.empty(0, np.int32)
            r = np.empty(0, np.float32)

        if level.size > MAX_FEATURES:  # rare overflow: keep strongest
            order = np.argsort(-r)[:MAX_FEATURES]
            level, x, y, r = level[order], x[order], y[order], r[order]

        n = level.size
        pad = MAX_FEATURES - n
        return (
            np.pad(level, (0, pad)),
            np.pad(y, (0, pad)),
            np.pad(x, (0, pad)),
            np.pad(r, (0, pad)),
            np.pad(np.ones(n, bool), (0, pad)),
        )

    def candidates(self, gray: np.ndarray) -> Tuple[Pyramid, fast.CellCandidates]:
        """Stage A: the pyramid (on the device) and its FAST candidates, read
        to the host in one copy (coordinates are exact in f32)."""
        pyr = build_pyramid(upload(gray, self.device), self.spec)
        c = fast.detect_pyramid(interior(pyr.raw, self.spec), self.spec, self.fast_hi,
                                self.fast_lo, self.cell_top_k)
        packed = torch.stack([c.ys.to(torch.float32), c.xs.to(torch.float32), c.response,
                              c.valid.to(torch.float32)]).cpu().numpy()
        host = fast.CellCandidates(ys=packed[0].astype(np.int32), xs=packed[1].astype(np.int32),
                                   response=packed[2], valid=packed[3] > 0)
        return pyr, host

    def __call__(self, gray: np.ndarray, depth: np.ndarray) -> FrameFeatures:
        """gray u8 (H, W), depth f32 meters (H, W) -> FrameFeatures on the
        camera's device."""
        pyr, cands = self.candidates(gray)
        level, ys, xs, resp, valid = self._distribute(cands)
        # one upload of the selection: the five arrays as int32 words
        words = upload(np.stack([level, ys, xs, resp.view(np.int32), valid.astype(np.int32)]),
                       self.device)
        sel = Selection(level=words[0], ys=words[1], xs=words[2],
                        resp=words[3].view(torch.float32), valid=words[4] > 0)
        depth_d = upload(np.asarray(depth, dtype=np.float32), self.device)
        return _stage_b(pyr, self.spec, sel, depth_d, self.camera)
