"""Intensity-centroid keypoint orientation (port of
``vo_slam_test_tpu/ops/orientation.py``).

``ic_angle`` is the plain version of the orientation half of the CUDA kernel
``csrc/orb.cu`` (see ``ops/orb_cuda.py``): moments m10 = sum(x*I),
m01 = sum(y*I) over the radius-15 umax disc, angle = cvFastAtan2(m01, m10) in
degrees [0, 360).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pattern
from .pyramid import HALO

# cvFastAtan2's f32 polynomial constants (OpenCV mathfuncs.cpp)
_ATAN_P1 = np.float32(0.9997878412794807 * (180.0 / np.pi))
_ATAN_P3 = np.float32(-0.3258083974640975 * (180.0 / np.pi))
_ATAN_P5 = np.float32(0.1555786518463281 * (180.0 / np.pi))
_ATAN_P7 = np.float32(-0.04432655554792128 * (180.0 / np.pi))
_ATAN_EPS = np.float32(2.220446049250313e-16)  # (float)DBL_EPSILON


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cvFastAtan2(y, x) in degrees [0, 360), f32 throughout."""
    ax = torch.abs(x).to(torch.float32)
    ay = torch.abs(y).to(torch.float32)
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    c = lo / (hi + float(_ATAN_EPS))
    c2 = c * c
    poly = (((float(_ATAN_P7) * c2 + float(_ATAN_P5)) * c2 + float(_ATAN_P3)) * c2
            + float(_ATAN_P1)) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


@functools.lru_cache(maxsize=8)
def _disc(device: torch.device):
    hp = pattern.HALF_PATCH_SIZE
    mask = torch.as_tensor(pattern.circular_patch_mask(), dtype=torch.float32, device=device)
    offs = torch.arange(-hp, hp + 1, dtype=torch.int64, device=device)
    return mask, offs


def ic_angle(canvas: torch.Tensor, level: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain version: orientation in degrees for each keypoint.

    canvas: [L, CH, CW] f32 raw haloed pyramid canvas; level/ys/xs: [N] int32
    keypoint level + level-image coordinates. The partial sums are integers
    below 2**24, so the f32 sums are exact in any order."""
    L, CH, CW = canvas.shape
    mask, offs = _disc(canvas.device)
    yy = ys.long()[:, None] + HALO + offs[None, :]          # [N, 31]
    xx = xs.long()[:, None] + HALO + offs[None, :]
    idx = (level.long()[:, None, None] * CH + yy[:, :, None]) * CW + xx[:, None, :]
    flat = canvas.reshape(-1)
    patches = flat[idx.clamp(0, flat.numel() - 1)]          # [N, 31, 31]
    pm = patches * mask
    xw = offs.to(torch.float32)
    m10 = (pm * xw[None, None, :]).sum(dim=(1, 2))
    m01 = (pm * xw[None, :, None]).sum(dim=(1, 2))
    return fast_atan2_deg(m01, m10)
