"""The plain reference that decides ``correct``: PyTorch and numpy only, written
from the published definitions (OpenCV's 8-bit ``resize`` and
``GaussianBlur``, ORB-SLAM2's intensity-centroid angle and steered rBRIEF,
FAST-9, the pinhole model, Horn's alignment), and importing nothing of the
program.

It judges what the program produced, one answer at a time:

- ``orb_check``: each keyframe keypoint claims a pyramid level, a position,
  an angle and a descriptor. The reference builds its own pyramid from the
  benchmark's image of that frame, and checks that the position is a FAST-9
  corner at the minimum threshold, recomputes the angle and the descriptor
  there, and counts the keypoints where any of the three disagrees.
- ``reprojection``: each observation of a map point by a keyframe claims a
  pixel; the reference projects the point through the keyframe's pose and
  measures the distance in pixels of the keypoint's level.
- ``ate``: the trajectory against the benchmark's ground truth after a rigid
  alignment (the TUM benchmark's ATE).

``dtype=torch.bfloat16`` runs the same arithmetic one precision below, as the
control that a comparison has to fail.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

HALF_PATCH = 15
HALO = 19  # the pyramid's border: ORB-SLAM2's EDGE_THRESHOLD
BLUR_Q8 = (18, 34, 48, 56, 48, 34, 18)  # OpenCV's 8-bit 7x7, sigma 2 taps (Q8)
RING = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
# cvFastAtan2's polynomial, in degrees
ATAN = [np.float32(c * (180.0 / np.pi)) for c in
        (0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128)]
ATAN_EPS = np.float32(2.220446049250313e-16)
PATTERN_FILE = os.path.join(os.path.dirname(__file__), "data", "orb_pattern.npy")


def level_sizes(h: int, w: int, n_levels: int, scale: float):
    return [(h, w)] + [(int(np.rint(h / scale**l)), int(np.rint(w / scale**l)))
                       for l in range(1, n_levels)]


def _taps(n_in: int, n_out: int, device):
    """cv::resize INTER_LINEAR 8U: source index and Q11 weights per output."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    fr = f - s.astype(np.float32)
    fr[s < 0], s[s < 0] = 0.0, 0
    last = s >= n_in - 1
    fr[last], s[last] = 1.0, n_in - 2
    w1 = np.rint(fr * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - fr) * np.float32(2048)).astype(np.int64)
    return [torch.as_tensor(a, device=device) for a in (s, s + 1, w0, w1)]


def resize_u8(img: torch.Tensor, hw, dtype=torch.float32) -> torch.Tensor:
    """OpenCV's fixed-point bilinear resize of an 8-bit image (exact in integer
    arithmetic); in a float ``dtype`` below f32, the same taps in that type."""
    sx, sx1, ax0, ax1 = _taps(img.shape[1], hw[1], img.device)
    sy, sy1, by0, by1 = _taps(img.shape[0], hw[0], img.device)
    if dtype == torch.float32:
        I = img.to(torch.int64)
        rows = I[:, sx] * ax0 + I[:, sx1] * ax1
        out = (((by0[:, None] * (rows[sy] >> 4)) >> 16)
               + ((by1[:, None] * (rows[sy1] >> 4)) >> 16) + 2) >> 2
        return out.to(torch.float32)
    I = img.to(dtype)
    rows = I[:, sx] * (ax0 / 2048).to(dtype) + I[:, sx1] * (ax1 / 2048).to(dtype)
    out = rows[sy] * (by0 / 2048).to(dtype)[:, None] + rows[sy1] * (by1 / 2048).to(dtype)[:, None]
    return torch.round(out).clamp(0, 255)


def _reflect(n: int, pad: int, device) -> torch.Tensor:
    """BORDER_REFLECT_101 source indices of a padded axis."""
    i = np.arange(-pad, n + pad)
    i = np.abs(i)
    i = np.where(i >= n, 2 * (n - 1) - i, i)
    return torch.as_tensor(i, device=device)


def blur_u8(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """cv::GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101) on 8-bit values: Q8
    taps, rows then columns, rounded from Q16."""
    H, W = img.shape
    if dtype == torch.float32:
        x = img.to(torch.int64)
        xp = x[:, _reflect(W, 3, img.device)]
        h = sum(k * xp[:, i:i + W] for i, k in enumerate(BLUR_Q8))
        hp = h[_reflect(H, 3, img.device)]
        v = sum(k * hp[i:i + H] for i, k in enumerate(BLUR_Q8))
        return ((v + 32768) >> 16).clamp(0, 255).to(torch.float32)
    x = img.to(dtype)
    k = [torch.tensor(t / 256.0, dtype=dtype) for t in BLUR_Q8]
    xp = x[:, _reflect(W, 3, img.device)]
    h = sum(k[i] * xp[:, i:i + W] for i in range(7))
    hp = h[_reflect(H, 3, img.device)]
    return torch.round(sum(k[i] * hp[i:i + H] for i in range(7))).clamp(0, 255)


def pyramid(gray: torch.Tensor, n_levels: int, scale: float, dtype=torch.float32):
    """[(raw level with a reflect-101 border of HALO, the same with its
    interior blurred)] per level; each level resized from the one above."""
    levels = [gray.to(torch.float32)]
    for hw in level_sizes(gray.shape[0], gray.shape[1], n_levels, scale)[1:]:
        levels.append(resize_u8(levels[-1], hw, dtype).to(torch.float32))
    out = []
    for lv in levels:
        h, w = lv.shape
        raw = lv[_reflect(h, HALO, lv.device)][:, _reflect(w, HALO, lv.device)]
        blur = raw.clone()
        blur[HALO:HALO + h, HALO:HALO + w] = blur_u8(lv, dtype).to(torch.float32)
        out.append((raw, blur))
    return out


def disc_mask() -> np.ndarray:
    """The 31x31 orientation disc: ORB-SLAM2's umax rows, made symmetric."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 1, np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    ys, xs = np.mgrid[-hp:hp + 1, -hp:hp + 1]
    return np.abs(xs) <= umax[np.abs(ys)]


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cvFastAtan2 in degrees, [0, 360)."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + float(ATAN_EPS))
    c2 = c * c
    a = (((float(ATAN[3]) * c2 + float(ATAN[2])) * c2 + float(ATAN[1])) * c2 + float(ATAN[0])) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _patch(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, dy, dx) -> torch.Tensor:
    """img[HALO + y + dy, HALO + x + dx] per keypoint (row) and offset (column)."""
    return img[(ys[:, None] + HALO + dy).long(), (xs[:, None] + HALO + dx).long()]


def keypoint_angle(raw: torch.Tensor, ys, xs, dtype=torch.float32) -> torch.Tensor:
    """Intensity-centroid angle over the disc (degrees)."""
    m = torch.as_tensor(np.argwhere(disc_mask()) - HALF_PATCH, device=raw.device)
    I = _patch(raw, ys, xs, m[:, 0], m[:, 1]).to(dtype)
    m10 = (I * m[:, 1].to(dtype)).sum(1)
    m01 = (I * m[:, 0].to(dtype)).sum(1)
    return fast_atan2(m01.to(dtype), m10.to(dtype)).to(torch.float32)


def descriptor(blur: torch.Tensor, ys, xs, angle_deg, dtype=torch.float32) -> torch.Tensor:
    """Steered rBRIEF -> [N, 256] bits (bit i: pair i's first sample is darker)."""
    p = torch.as_tensor(np.load(PATTERN_FILE).astype(np.float32), device=blur.device).to(dtype)
    th = (angle_deg.to(dtype) * torch.tensor(np.float32(np.pi / 180.0), dtype=dtype))
    a, b = torch.cos(th)[:, None], torch.sin(th)[:, None]
    x1 = torch.round(p[:, 0] * a - p[:, 1] * b)
    y1 = torch.round(p[:, 0] * b + p[:, 1] * a)
    x2 = torch.round(p[:, 2] * a - p[:, 3] * b)
    y2 = torch.round(p[:, 2] * b + p[:, 3] * a)
    img = blur.to(dtype) if dtype != torch.float32 else blur
    s1 = img[(ys[:, None] + HALO + y1).long(), (xs[:, None] + HALO + x1).long()]
    s2 = img[(ys[:, None] + HALO + y2).long(), (xs[:, None] + HALO + x2).long()]
    return s1 < s2


def is_fast_corner(raw: torch.Tensor, ys, xs, threshold: float) -> torch.Tensor:
    """FAST-9: nine contiguous ring pixels all brighter than centre + t, or all
    darker than centre - t."""
    c = _patch(raw, ys, xs, torch.zeros(1, dtype=torch.long, device=raw.device),
               torch.zeros(1, dtype=torch.long, device=raw.device))
    ring = torch.stack([_patch(raw, ys, xs, torch.tensor([dy], device=raw.device),
                               torch.tensor([dx], device=raw.device))[:, 0]
                        for dx, dy in RING], 1)
    hit = torch.zeros(ys.shape[0], dtype=torch.bool, device=raw.device)
    for side in (ring > c + threshold, ring < c - threshold):
        wrap = torch.cat([side, side[:, :8]], 1).to(torch.int32)
        run = wrap[:, 0:16]
        for k in range(1, 9):
            run = run * wrap[:, k:k + 16]
        hit |= run.any(1)
    return hit


def unpack_bits(desc_words: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] bools (bit b of word w is pair 32 w + b)."""
    w = desc_words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=w.device)
    return ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], 256).bool()


def orb_check(gray: torch.Tensor, depth_m: torch.Tensor, uv: torch.Tensor, octave: torch.Tensor,
              angle: torch.Tensor, desc_words: torch.Tensor, kp_depth: torch.Tensor,
              n_levels: int, scale: float, min_fast: float, control_dtype=None) -> Dict[str, int]:
    """One keyframe's keypoints against the reference -> counts of keypoints
    checked, not a corner, angle off by more than 1e-3 degree, descriptor
    off by a bit, depth not the image's at the rounded position (-1 where it
    holds none), any of these (``bad``), and the flipped bits. With
    ``control_dtype`` the reference in that type stands in for the program's
    angle and descriptor (the control)."""
    ref = pyramid(gray, n_levels, scale)
    ctl = None if control_dtype is None else pyramid(gray, n_levels, scale, control_dtype)
    scales = torch.tensor([np.float32(scale**l) for l in range(n_levels)], device=uv.device)
    H, W = depth_m.shape
    d = depth_m[torch.round(uv[:, 1]).long().clamp(0, H - 1), torch.round(uv[:, 0]).long().clamp(0, W - 1)]
    depth_off = torch.where(d > 0, d, -1.0) != kp_depth
    out = dict(keypoints=0, not_corner=0, angle_off=0, desc_off=0, depth_off=0, bad=0,
               flipped_bits=0)
    for lvl in range(n_levels):
        sel = octave == lvl
        if not bool(sel.any()):
            continue
        xs = torch.round(uv[sel, 0] / scales[lvl]).long()
        ys = torch.round(uv[sel, 1] / scales[lvl]).long()
        raw, blur = ref[lvl]
        ang_ref = keypoint_angle(raw, ys, xs)
        bits_ref = descriptor(blur, ys, xs, ang_ref)
        if ctl is None:
            ang, bits = angle[sel], unpack_bits(desc_words[sel])
        else:
            ang = keypoint_angle(ctl[lvl][0], ys, xs, control_dtype)
            bits = descriptor(ctl[lvl][1], ys, xs, ang, control_dtype)
        d = (ang - ang_ref).abs()
        ang_off = torch.minimum(d, 360.0 - d) > 1e-3
        flips = (bits != bits_ref).sum(1)
        corner = is_fast_corner(raw, ys, xs, min_fast)
        bad = ~corner | ang_off | (flips > 0) | depth_off[sel]
        out["keypoints"] += int(sel.sum())
        out["not_corner"] += int((~corner).sum())
        out["angle_off"] += int(ang_off.sum())
        out["desc_off"] += int((flips > 0).sum())
        out["depth_off"] += int(depth_off[sel].sum())
        out["bad"] += int(bad.sum())
        out["flipped_bits"] += int(flips.sum())
    return out


def reprojection_px(kf_pose: np.ndarray, kf_uv: np.ndarray, kf_octave: np.ndarray,
                    pt_pos: np.ndarray, obs_kf: np.ndarray, obs_kp: np.ndarray,
                    fx: float, fy: float, cx: float, cy: float, scale: float,
                    dtype=np.float32) -> np.ndarray:
    """Per observation (point p seen by keyframe k at keypoint i): the distance
    between the keypoint and the point projected through the keyframe's pose
    (T_c_w), in pixels of the keypoint's pyramid level. ``dtype`` below f32
    rounds the poses and points to it first (the control)."""
    T = kf_pose[obs_kf].astype(np.float64)
    X = pt_pos.astype(np.float64)
    if dtype != np.float32:
        T = torch.as_tensor(T).to(dtype).double().numpy()
        X = torch.as_tensor(X).to(dtype).double().numpy()
    Xc = np.einsum("nij,nj->ni", T[:, :3, :3], X) + T[:, :3, 3]
    z = np.maximum(Xc[:, 2], 1e-9)
    u = fx * Xc[:, 0] / z + cx
    v = fy * Xc[:, 1] / z + cy
    e = np.hypot(u - kf_uv[obs_kf, obs_kp, 0], v - kf_uv[obs_kf, obs_kp, 1])
    return e / scale ** kf_octave[obs_kf, obs_kp].astype(np.float64)


def ate(gt_xyz: np.ndarray, est_xyz: np.ndarray) -> float:
    """RMSE of the positions after the rigid (Horn) alignment of est onto gt."""
    X, Y = est_xyz.astype(np.float64).T, gt_xyz.astype(np.float64).T
    mx, my = X.mean(1, keepdims=True), Y.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((Y - my) @ (X - mx).T)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt)) or 1.0
    R = U @ S @ Vt
    err = R @ X + (my - R @ mx) - Y
    return float(np.sqrt((err ** 2).sum(0).mean()))
