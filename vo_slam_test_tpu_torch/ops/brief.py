"""Steered rBRIEF descriptors (port of ``vo_slam_test_tpu/ops/brief.py``).

``compute_descriptors`` is the plain version of the descriptor half of the
CUDA kernel ``csrc/orb.cu`` (see ``ops/orb_cuda.py``): each of the 256
pattern pairs is rotated by the keypoint angle, rounded half to even, sampled
on the blurred canvas, and compared (bit = I(p1) < I(p2)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pattern
from .pyramid import HALO

DEG2RAD = np.float32(np.pi / 180.0)  # jnp.radians multiplies by f32(pi/180)


@functools.lru_cache(maxsize=8)
def _pattern_xy(device: torch.device) -> torch.Tensor:
    """(512, 2) f32: interleaved (x, y) of the two points of each pair."""
    p = pattern.bit_pattern_31().astype(np.float32)  # (256, 4): x1 y1 x2 y2
    pts = np.stack([p[:, [0, 1]], p[:, [2, 3]]], axis=1).reshape(512, 2)
    return torch.as_tensor(pts, device=device)


def compute_descriptors(
    canvas_blur: torch.Tensor,
    level: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    angle_deg: torch.Tensor,
) -> torch.Tensor:
    """Plain version -> int32 [N, 8] bit patterns (bit b of word w = pair
    32w+b). level/ys/xs are level-image integer coordinates; angle in
    degrees."""
    L, CH, CW = canvas_blur.shape
    pts = _pattern_xy(canvas_blur.device)
    theta = angle_deg * float(DEG2RAD)
    ca, sa = torch.cos(theta), torch.sin(theta)
    rx = torch.round(pts[None, :, 0] * ca[:, None] - pts[None, :, 1] * sa[:, None]).long()
    ry = torch.round(pts[None, :, 0] * sa[:, None] + pts[None, :, 1] * ca[:, None]).long()
    yy = ys.long()[:, None] + HALO + ry  # [N, 512]
    xx = xs.long()[:, None] + HALO + rx
    idx = (level.long()[:, None] * CH + yy) * CW + xx
    flat = canvas_blur.reshape(-1)
    samples = flat[idx.clamp(0, flat.numel() - 1)]
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int64)  # [N, 256]
    shifts = torch.arange(32, dtype=torch.int64, device=canvas_blur.device)
    words = (bits.reshape(-1, 8, 32) << shifts).sum(dim=-1)       # [N, 8] in [0, 2**32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
