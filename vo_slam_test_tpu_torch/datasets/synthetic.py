"""Synthetic RGB-D sequence generator (port of
``vo_slam_test_tpu/datasets/synthetic.py``: the "corner" and "room" scenes,
the texture density and the moving patch, ``room_orbit_trajectory`` and
``pan_return_trajectory``; the JAX package's opt-in micro texture, which its
``SyntheticRGBD`` never asks for, is not ported).

Textured planes ray-cast through the pinhole model on the host with numpy,
with exact ground-truth poses and depth. The random draws are the JAX
renderer's, so the same seed gives the same textures; the default trajectory
is built with this package's ``lie.se3_exp`` on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _make_texture(rng: np.random.Generator, size: int = 1024, n_rect: int = 900) -> np.ndarray:
    """High-contrast texture with plenty of FAST corners: random rectangles
    over filtered noise, lightly smoothed."""
    tex = rng.uniform(80, 150, size=(size, size)).astype(np.float32)
    for _ in range(n_rect):
        x, y = rng.integers(0, size - 40, size=2)
        w, h = rng.integers(6, 40, size=2)
        tex[y : y + h, x : x + w] = rng.uniform(0, 255)
    # small blur to avoid aliasing: box filter 2x2
    tex = 0.25 * (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, (1, 1), (0, 1)))
    return np.clip(tex, 0, 255)


def room_orbit_trajectory(n_frames: int, loops: float = 1.0) -> np.ndarray:
    """Camera orbit inside the "room" scene: on a circle of radius 1.2 in the
    x-z plane, looking radially outward at the walls, so new wall area enters
    the frustum every frame and keyframes keep coming. A vertical bob (0.08)
    and a radial wobble (0.15) give triangulation baseline beyond pure
    rotation. The JAX package's function with its defaults for radius, bob,
    wobble and dwell. Returns (N,4,4) T_w_c."""
    radius, bob, wobble = 1.2, 0.08, 0.15
    ts = np.arange(n_frames, dtype=np.float64) / max(n_frames - 1, 1)
    poses = np.zeros((n_frames, 4, 4), dtype=np.float32)
    for i, t in enumerate(ts):
        th = 2.0 * np.pi * loops * t
        r = radius + wobble * np.sin(3.1 * th)
        y = bob * np.sin(2.3 * th)
        p = np.array([r * np.sin(th), y, r * np.cos(th)])
        # camera z = outward radial, y = world y (down), x = y cross z
        zc = np.array([np.sin(th), 0.0, np.cos(th)])
        yc = np.array([0.0, 1.0, 0.0])
        xc = np.cross(yc, zc)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = xc, yc, zc, p
        poses[i] = T
    return poses


def pan_return_trajectory(
    n_frames: int,
    recede: float = 2.6,
    yaw_max: float = 1.7,
    z0: float = 1.6,
) -> np.ndarray:
    """Recede-pan-return inside the "room" scene: start near one wall looking
    at it and recede (new peripheral area keeps keyframes coming while the
    start view stays in the frustum), pan fully onto the adjacent wall (the
    start view leaves the frustum), hold, pan back, and keep receding over the
    old wall, so the revisit returns to a region many keyframes observed over
    a long baseline. Returns (N,4,4) T_w_c."""
    n_settle = int(0.25 * n_frames)
    n_out = int(0.25 * n_frames)
    n_hold = int(0.06 * n_frames)
    n_back = int(0.25 * n_frames)
    n_home = n_frames - n_settle - n_out - n_hold - n_back
    dz = recede / (n_settle + n_home)

    def pose(yaw, z, tx=0.0, ty=0.0):
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4, dtype=np.float32)
        # camera looks along +z rotated by yaw about y
        T[:3, 0] = np.array([c, 0.0, -s])
        T[:3, 1] = np.array([0.0, 1.0, 0.0])
        T[:3, 2] = np.array([s, 0.0, c])
        T[:3, 3] = np.array([tx, ty, z])
        return T

    poses = []
    z = z0
    for i in range(n_settle):
        z -= dz
        poses.append(pose(0.06 * np.sin(1.1 * i), z,
                          tx=0.10 * np.sin(0.8 * i), ty=0.08 * np.sin(1.3 * i)))
    for i in range(n_out):
        y = yaw_max * (i + 1) / n_out
        poses.append(pose(y, z, tx=0.05 * np.sin(3.0 * y)))
    for i in range(n_hold):
        poses.append(pose(yaw_max, z, tx=0.05 * np.sin(3.0 * yaw_max), ty=0.03 * np.sin(0.9 * i)))
    for i in range(n_back):
        y = yaw_max * (1.0 - (i + 1) / n_back)
        poses.append(pose(y, z, tx=0.05 * np.sin(3.0 * y)))
    for i in range(n_home):
        z -= dz
        poses.append(pose(0.05 * np.sin(1.3 * i), z,
                          tx=0.10 * np.sin(0.9 * i + 2.0), ty=0.08 * np.sin(1.1 * i)))
    return np.stack(poses)


@dataclasses.dataclass
class SyntheticRGBD:
    """Renders frames along a trajectory inside a textured scene.

    scene="corner" (default): box corner (back wall z=3.0, floor y=0.8, right
    wall x=1.5); the camera starts at the origin looking down +z and the
    default trajectory's per-frame motion scales with motion_scale / n_frames.

    scene="room": a closed 6-plane room (4 walls, floor, ceiling, each with
    its own texture) centred on the origin, for orbits such as
    ``room_orbit_trajectory`` that sustain keyframe creation.

    ``trajectory`` ([N,4,4] T_w_c) replaces the default trajectory.

    ``texture_corners`` scales the number of high-contrast rectangles per
    texture: 1.0 is the nominal regime, ~0.03 a texture-poor scene (the
    fr3_nstr_tex_near analogue). ``moving_patch`` = (size_m, speed_m_per_frame)
    adds a textured square 5 cm in front of the first plane that slides along
    its first texture axis every frame: an independently moving object with
    consistent depth (the fr3_sit_halfsph analogue)."""

    width: int = 640
    height: int = 480
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    n_frames: int = 30
    seed: int = 0
    motion_scale: float = 1.0
    trajectory: np.ndarray = None
    scene: str = "corner"
    texture_corners: float = 1.0
    moving_patch: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n_rect = max(int(900 * self.texture_corners), 0)
        if self.scene == "corner":
            # (axis, plane value, texture, texture uv axes)
            self.planes = [
                (2, 3.0, _make_texture(rng, n_rect=n_rect), (0, 1)),   # back wall z = 3
                (1, 0.8, _make_texture(rng, n_rect=n_rect), (0, 2)),   # floor y = 0.8
                (0, 1.5, _make_texture(rng, n_rect=n_rect), (1, 2)),   # right wall x = 1.5
            ]
            # walls don't extend infinitely: clip hits to the box corner
            self.bounds = ((-3.0, 1.5 + 1e-3), (-3.0, 0.8 + 1e-3), (-1.0, 3.0 + 1e-3))
        elif self.scene == "room":
            texs = [_make_texture(rng, n_rect=n_rect) for _ in range(6)]
            hx, hz = 3.0, 3.0            # half extents of the room footprint
            y_floor, y_ceil = 1.0, -1.5  # camera y axis points down
            self.planes = [
                (2, hz, texs[0], (0, 1)),       # far wall
                (2, -hz, texs[1], (0, 1)),      # near wall
                (0, hx, texs[2], (1, 2)),       # right wall
                (0, -hx, texs[3], (1, 2)),      # left wall
                (1, y_floor, texs[4], (0, 2)),  # floor
                (1, y_ceil, texs[5], (0, 2)),   # ceiling
            ]
            e = 1e-3
            self.bounds = ((-hx - e, hx + e), (y_ceil - e, y_floor + e), (-hz - e, hz + e))
        else:
            raise ValueError(f"unknown scene {self.scene!r}")
        if self.moving_patch is not None:
            self.tex_patch = _make_texture(rng, size=256, n_rect=max(n_rect // 8, 40))
        if self.trajectory is not None:
            self.poses = np.asarray(self.trajectory, np.float32)
            self.n_frames = self.poses.shape[0]
        else:
            self.poses = self._trajectory()

    def _trajectory(self) -> np.ndarray:
        """Smooth sinusoidal translation + small yaw/pitch. Returns (N,4,4) T_w_c."""
        import torch

        from .. import lie

        ts = np.arange(self.n_frames, dtype=np.float64) / max(self.n_frames - 1, 1)
        s = self.motion_scale
        poses = []
        for t in ts:
            xi = np.array([
                0.25 * s * np.sin(2 * np.pi * t),
                0.10 * s * np.sin(4 * np.pi * t + 1.0),
                0.15 * s * (1 - np.cos(2 * np.pi * t)),
                0.05 * s * np.sin(2 * np.pi * t + 2.0),   # pitch
                0.10 * s * np.sin(2 * np.pi * t + 0.5),   # yaw
                0.0,
            ], dtype=np.float32)
            poses.append(lie.se3_exp(torch.from_numpy(xi)).numpy())
        return np.stack(poses)

    def render(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        """Returns (gray u8 HxW, depth f32 HxW meters, timestamp)."""
        T_w_c = self.poses[i]
        R, o_w = T_w_c[:3, :3], T_w_c[:3, 3]
        H, W = self.height, self.width
        u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        d_cam = np.stack([(u - self.cx) / self.fx, (v - self.cy) / self.fy, np.ones_like(u)], axis=-1)
        d_w = d_cam @ R.T  # camera rays in the world frame

        big = 1e9
        depth = np.full((H, W), big, dtype=np.float32)
        gray = np.zeros((H, W), dtype=np.float32)
        (bx0, bx1), (by0, by1), (bz0, bz1) = self.bounds
        for axis, value, tex, (a, b) in self.planes:
            denom = d_w[..., axis]
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            lam = (value - o_w[axis]) / denom  # ray parameter
            pt = o_w[None, None, :] + lam[..., None] * d_w
            z_cam = lam * d_cam[..., 2]
            valid = (lam > 0.05) & (z_cam < depth)
            valid &= (
                (pt[..., 0] > bx0) & (pt[..., 0] < bx1)
                & (pt[..., 1] > by0) & (pt[..., 1] < by1)
                & (pt[..., 2] > bz0) & (pt[..., 2] < bz1)
            )
            n = tex.shape[0]
            tu = (pt[..., a] * 170.0) % n
            tv = (pt[..., b] * 170.0) % n
            x0 = np.floor(tu).astype(np.int64) % n
            y0 = np.floor(tv).astype(np.int64) % n
            x1 = (x0 + 1) % n
            y1 = (y0 + 1) % n
            wx = tu - np.floor(tu)
            wy = tv - np.floor(tv)
            val = (
                tex[y0, x0] * (1 - wx) * (1 - wy)
                + tex[y0, x1] * wx * (1 - wy)
                + tex[y1, x0] * (1 - wx) * wy
                + tex[y1, x1] * wx * wy
            )
            gray = np.where(valid, val, gray)
            depth = np.where(valid, z_cam, depth)

        if self.moving_patch is not None:
            gray, depth = self._render_patch(i, o_w, d_w, d_cam, gray, depth)
        depth = np.where(depth >= big, 0.0, depth)  # 0 = no depth (TUM sentinel)
        return gray.astype(np.uint8), depth, float(i) / 30.0

    def _render_patch(self, i, o_w, d_w, d_cam, gray, depth):
        """The moving patch over frame ``i``'s gray and depth (before the
        no-hit sentinel is applied)."""
        size_m, speed = self.moving_patch
        axis, value, _, (a, b) = self.planes[0]
        sign = 1.0 if value > 0 else -1.0
        pv = value - sign * 0.05
        denom = d_w[..., axis]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        lam = (pv - o_w[axis]) / denom
        pt = o_w[None, None, :] + lam[..., None] * d_w
        z_cam = lam * d_cam[..., 2]
        ca = -1.0 + speed * i  # patch center slides along uv axis a
        cb = -0.3
        half = 0.5 * size_m
        hit = (
            (lam > 0.05) & (z_cam < depth)
            & (np.abs(pt[..., a] - ca) < half) & (np.abs(pt[..., b] - cb) < half)
        )
        tex = self.tex_patch
        n = tex.shape[0]
        tu = (pt[..., a] - (ca - half)) / size_m * (n - 2)
        tv = (pt[..., b] - (cb - half)) / size_m * (n - 2)
        x0 = np.clip(np.floor(tu).astype(np.int64), 0, n - 2)
        y0 = np.clip(np.floor(tv).astype(np.int64), 0, n - 2)
        wx = np.clip(tu - x0, 0, 1)
        wy = np.clip(tv - y0, 0, 1)
        val = (
            tex[y0, x0] * (1 - wx) * (1 - wy)
            + tex[y0, x0 + 1] * wx * (1 - wy)
            + tex[y0 + 1, x0] * (1 - wx) * wy
            + tex[y0 + 1, x0 + 1] * wx * wy
        )
        return np.where(hit, val, gray), np.where(hit, z_cam, depth)

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, i: int):
        return self.render(i)

    def gt_T_c_w(self, i: int) -> np.ndarray:
        return np.linalg.inv(self.poses[i])
