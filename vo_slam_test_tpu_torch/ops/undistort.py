"""Radial-tangential point undistortion (port of
``vo_slam_test_tpu/ops/undistort.py``): the fixed-point iteration of
cv::undistortPoints on normalized coordinates, as a Python loop."""

from __future__ import annotations

import torch


def undistort_points(uv: torch.Tensor, fx, fy, cx, cy, dist_coef: torch.Tensor,
                     iters: int = 10) -> torch.Tensor:
    """(..., 2) distorted pixels -> (..., 2) undistorted pixels (same K)."""
    k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)
