"""ORB feature extraction, fully on the device (port of ``extract_fused`` and
``_stage_b`` of ``vo_slam_test_tpu/frontend/extractor.py``).

Pyramid canvases (raw + u8 blur) -> FAST score (kernel ``csrc/fast.cu``) ->
cell-local NMS, two-threshold retry, per-cell top-K -> per-level device
quad-tree -> compaction into MAX_FEATURES slots -> IC angle + steered rBRIEF
(kernel ``csrc/orb.cu``) -> level-0 coordinates, undistortion, depth and
virtual-stereo uRight. No host round trip.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..camera import Camera
from ..ops import fast, orb_cuda, undistort
from ..ops.distribute_device import distribute_level
from ..ops.pyramid import Pyramid, PyramidSpec, build_pyramid, interior
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
    u_right = torch.where(has_d, uv_und[:, 0] - cam.bf / torch.where(has_d, d, 1.0), -1.0)

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
