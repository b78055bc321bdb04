"""Radial-tangential point undistortion (port of
``vo_slam_test_tpu/ops/undistort.py``): the fixed-point iteration of
cv::undistortPoints on normalized coordinates, as ``utils.graphs.repeat``
(the JAX package's ``lax.fori_loop``: one WHILE node in a step program), and
the closed-form forward model ``distort_points``."""

from __future__ import annotations

import torch

from ..utils import graphs


def undistort_points(uv: torch.Tensor, fx, fy, cx, cy, dist_coef: torch.Tensor,
                     iters: int = 10) -> torch.Tensor:
    """(..., 2) distorted pixels -> (..., 2) undistorted pixels (same K)."""
    k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy

    def body(xy):
        x, y = xy
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return (x0 - dx) * icdist, (y0 - dy) * icdist

    x, y = graphs.repeat(iters, body, (x0, y0))
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def distort_points(uv_undist: torch.Tensor, fx, fy, cx, cy, dist_coef: torch.Tensor
                   ) -> torch.Tensor:
    """Forward distortion model (closed form): (..., 2) undistorted pixels ->
    (..., 2) distorted pixels."""
    k1, k2, p1, p2, k3 = (dist_coef[i] for i in range(5))
    x = (uv_undist[..., 0] - cx) / fx
    y = (uv_undist[..., 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)
