"""Pinhole RGB-D camera with virtual-stereo depth (port of
``vo_slam_test_tpu/camera.py``).

Intrinsics are 0-d float32 tensors on the camera's device, so every
projection runs in float32 on that device exactly as the JAX scalars do.
``any_dist`` is decided once on the host from the config: the JAX extractor's
``lax.cond`` on the distortion coefficients becomes a Python branch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from . import lie, resolve_device
from .config import SlamConfig


@dataclasses.dataclass
class Camera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor          # baseline * fx (virtual stereo)
    b: torch.Tensor           # baseline = bf / fx
    th_depth: torch.Tensor    # close/far threshold, already scaled by b
    depth_scale: torch.Tensor
    dist_coef: torch.Tensor   # (k1, k2, p1, p2, k3)
    width: int = 640
    height: int = 480
    fps: int = 30
    any_dist: bool = False    # any nonzero distortion coefficient

    @classmethod
    def from_config(
        cls, cfg: SlamConfig, device: Optional[Union[str, torch.device]] = None
    ) -> "Camera":
        dev = resolve_device(device)
        b = cfg.camera_bf / cfg.camera_fx

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        dist = [cfg.camera_k1, cfg.camera_k2, cfg.camera_p1, cfg.camera_p2, cfg.camera_k3]
        return cls(
            fx=f32(cfg.camera_fx), fy=f32(cfg.camera_fy),
            cx=f32(cfg.camera_cx), cy=f32(cfg.camera_cy),
            bf=f32(cfg.camera_bf), b=f32(b),
            th_depth=f32(cfg.thDepth * b),
            depth_scale=f32(cfg.camera_depthScale),
            dist_coef=f32(dist),
            width=cfg.camera_width, height=cfg.camera_height, fps=cfg.camera_fps,
            any_dist=any(float(v) != 0.0 for v in dist),
        )

    @property
    def K(self) -> torch.Tensor:
        """[3,3] intrinsic matrix."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx]),
                            torch.stack([z, self.fy, self.cy]),
                            torch.stack([z, z, o])])

    def camera2pixel(self, p3d: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera points -> (..., 2) pixels."""
        z = p3d[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
        u = self.fx * p3d[..., 0] / safe_z + self.cx
        v = self.fy * p3d[..., 1] / safe_z + self.cy
        return torch.stack([u, v], dim=-1)

    def pixel2camera(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixels + (...,) depth -> (..., 3) camera points."""
        x = (uv[..., 0] - self.cx) * depth / self.fx
        y = (uv[..., 1] - self.cy) * depth / self.fy
        return torch.stack([x, y, depth], dim=-1)

    def pixel2world(self, uv: torch.Tensor, depth: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
        pc = self.pixel2camera(uv, depth)
        T_w_c = lie.se3_inverse(T_c_w)
        return torch.einsum("ij,...j->...i", T_w_c[:3, :3], pc) + T_w_c[:3, 3]

    def world2camera(self, pw: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("ij,...j->...i", T_c_w[:3, :3], pw) + T_c_w[:3, 3]
