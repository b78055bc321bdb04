"""The benchmark's frozen inputs: textures, trajectories and the ray-caster.

A copy of the port's synthetic RGB-D generator (``datasets/synthetic.py``:
``_make_texture``, ``room_orbit_trajectory``, the default corner trajectory
and the plane / bilinear-texture render), kept here so that a later change
to the port cannot change what the benchmark feeds it. The textures are drawn
with numpy's generator from the seed, in the order the port draws them; the
frames are rendered on the device in batches, in f32, with the same
arithmetic as the port's numpy renderer (a pixel may differ by one grey level
where rounding differs).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

NO_HIT = 1e9


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


def make_texture(rng: np.random.Generator, size: int = 1024, n_rect: int = 900) -> np.ndarray:
    """High-contrast texture: random rectangles over filtered noise, box-blurred 2x2."""
    tex = rng.uniform(80, 150, size=(size, size)).astype(np.float32)
    for _ in range(n_rect):
        x, y = rng.integers(0, size - 40, size=2)
        w, h = rng.integers(6, 40, size=2)
        tex[y : y + h, x : x + w] = rng.uniform(0, 255)
    tex = 0.25 * (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, (1, 1), (0, 1)))
    return np.clip(tex, 0, 255)


def room_orbit(n_frames: int, loops: float) -> np.ndarray:
    """An orbit of radius 1.2 m inside the room, looking out at the walls, with
    a vertical bob and a radial wobble -> [N,4,4] f32 T_w_c."""
    radius, bob, wobble = 1.2, 0.08, 0.15
    ts = np.arange(n_frames, dtype=np.float64) / max(n_frames - 1, 1)
    poses = np.zeros((n_frames, 4, 4), dtype=np.float32)
    for i, t in enumerate(ts):
        th = 2.0 * np.pi * loops * t
        r = radius + wobble * np.sin(3.1 * th)
        y = bob * np.sin(2.3 * th)
        zc = np.array([np.sin(th), 0.0, np.cos(th)])
        yc = np.array([0.0, 1.0, 0.0])
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2] = np.cross(yc, zc), yc, zc
        T[:3, 3] = (r * np.sin(th), y, r * np.cos(th))
        poses[i] = T
    return poses


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist (rho, phi) -> [4,4] (Rodrigues and the left Jacobian, in f64)."""
    rho, phi = xi[:3].astype(np.float64), xi[3:].astype(np.float64)
    th = float(np.linalg.norm(phi))
    W = np.array([[0.0, -phi[2], phi[1]], [phi[2], 0.0, -phi[0]], [-phi[1], phi[0], 0.0]])
    if th < 1e-8:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th**2, (th - np.sin(th)) / th**3
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + a * W + b * W @ W
    T[:3, 3] = (np.eye(3) + b * W + c * W @ W) @ rho
    return T


def corner_trajectory(n_frames: int, motion_scale: float) -> np.ndarray:
    """The corner scene's smooth sinusoidal translation with small pitch and yaw
    (one period over the ``n_frames``: the last frame repeats the first pose)
    -> [N,4,4] f32 T_w_c."""
    ts = np.arange(n_frames, dtype=np.float64) / max(n_frames - 1, 1)
    s = motion_scale
    out = []
    for t in ts:
        xi = np.array([
            0.25 * s * np.sin(2 * np.pi * t),
            0.10 * s * np.sin(4 * np.pi * t + 1.0),
            0.15 * s * (1 - np.cos(2 * np.pi * t)),
            0.05 * s * np.sin(2 * np.pi * t + 2.0),
            0.10 * s * np.sin(2 * np.pi * t + 0.5),
            0.0,
        ], dtype=np.float32)
        out.append(se3_exp(xi))
    return np.stack(out).astype(np.float32)


@dataclasses.dataclass
class Planes:
    """Textured planes: (axis, value, texture index, texture uv axes) each, the
    textures [T,S,S] and the box the hits are clipped to."""

    planes: List[Tuple[int, float, int, Tuple[int, int]]]
    textures: np.ndarray
    bounds: Tuple[Tuple[float, float], ...]


def scene_planes(kind: str, seed: int) -> Planes:
    """The port's "corner" (three planes) or "room" (six) scene, textured from
    ``seed`` in the port's draw order."""
    rng = np.random.default_rng(seed)
    if kind == "corner":
        texs = [make_texture(rng) for _ in range(3)]
        planes = [(2, 3.0, 0, (0, 1)), (1, 0.8, 1, (0, 2)), (0, 1.5, 2, (1, 2))]
        bounds = ((-3.0, 1.5 + 1e-3), (-3.0, 0.8 + 1e-3), (-1.0, 3.0 + 1e-3))
    elif kind == "room":
        texs = [make_texture(rng) for _ in range(6)]
        hx, hz, y_floor, y_ceil, e = 3.0, 3.0, 1.0, -1.5, 1e-3
        planes = [(2, hz, 0, (0, 1)), (2, -hz, 1, (0, 1)), (0, hx, 2, (1, 2)),
                  (0, -hx, 3, (1, 2)), (1, y_floor, 4, (0, 2)), (1, y_ceil, 5, (0, 2))]
        bounds = ((-hx - e, hx + e), (y_ceil - e, y_floor + e), (-hz - e, hz + e))
    else:
        raise ValueError(f"unknown scene {kind!r}")
    return Planes(planes, np.stack(texs), bounds)


def render(scene: Planes, poses: np.ndarray, cam: Camera, device, batch: int = 8
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray-cast every pose -> (grey u8 [F,H,W], depth f32 metres [F,H,W], 0
    where no plane is hit), on ``device``."""
    dev = torch.device(device)
    tex = torch.as_tensor(scene.textures, device=dev)
    n = tex.shape[-1]
    H, W = cam.height, cam.width
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    d_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], -1)
    T = torch.as_tensor(np.asarray(poses, np.float32), device=dev)
    grays, depths = [], []
    (bx0, bx1), (by0, by1), (bz0, bz1) = scene.bounds
    for lo in range(0, T.shape[0], batch):
        Tb = T[lo:lo + batch]
        R, o = Tb[:, :3, :3], Tb[:, :3, 3]
        d_w = torch.einsum("hwj,fij->fhwi", d_cam, R)
        depth = torch.full(d_w.shape[:3], NO_HIT, dtype=torch.float32, device=dev)
        gray = torch.zeros_like(depth)
        for axis, value, ti, (a, b) in scene.planes:
            den = d_w[..., axis]
            den = torch.where(den.abs() < 1e-9, torch.full_like(den, 1e-9), den)
            lam = (value - o[:, axis, None, None]) / den
            pt = o[:, None, None, :] + lam[..., None] * d_w
            z = lam * d_cam[None, ..., 2]
            ok = (lam > 0.05) & (z < depth)
            ok &= ((pt[..., 0] > bx0) & (pt[..., 0] < bx1) & (pt[..., 1] > by0)
                   & (pt[..., 1] < by1) & (pt[..., 2] > bz0) & (pt[..., 2] < bz1))
            tu = torch.remainder(pt[..., a] * 170.0, n)
            tv = torch.remainder(pt[..., b] * 170.0, n)
            x0 = torch.remainder(torch.floor(tu).long(), n)
            y0 = torch.remainder(torch.floor(tv).long(), n)
            x1, y1 = (x0 + 1) % n, (y0 + 1) % n
            wx, wy = tu - torch.floor(tu), tv - torch.floor(tv)
            t = tex[ti]
            val = (t[y0, x0] * (1 - wx) * (1 - wy) + t[y0, x1] * wx * (1 - wy)
                   + t[y1, x0] * (1 - wx) * wy + t[y1, x1] * wx * wy)
            gray = torch.where(ok, val, gray)
            depth = torch.where(ok, z, depth)
        depth = torch.where(depth >= NO_HIT, torch.zeros_like(depth), depth)
        grays.append(gray.to(torch.uint8))
        depths.append(depth)
    return torch.cat(grays), torch.cat(depths)
