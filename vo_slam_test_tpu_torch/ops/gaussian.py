"""Bit-exact 7x7 Gaussian blur on u8 values (port of
``vo_slam_test_tpu/ops/gaussian.py::gaussian_blur_7x7_u8``).

Shift-and-add, not ``F.conv2d``: the Q8/Q16 fixed-point intermediates reach
16 bits of mantissa, so a TF32 or cuDNN convolution would not be exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenCV's bit-exact u8 coefficients for ksize=7, sigma=2 (Q8, sum 256)
_K_U8_Q8 = (18, 34, 48, 56, 48, 34, 18)


@functools.lru_cache(maxsize=None)
def reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each padded position under BORDER_REFLECT_101, kept on
    ``device`` (built once, so no per-frame host-to-device copy)."""
    return torch.as_tensor(np.pad(np.arange(n), pad, mode="reflect"), device=device)


def gaussian_blur_7x7_u8(img: torch.Tensor) -> torch.Tensor:
    """cv::GaussianBlur(7x7, sigma 2, REFLECT_101) on u8 values held in f32,
    over the last two dims. Every intermediate is an integer below 2**24, so
    f32 arithmetic is exact."""
    H, W = img.shape[-2:]
    pad = 3
    xp = img.index_select(img.dim() - 1, reflect_index(W, pad, img.device))
    h = sum(float(k) * xp[..., :, i : i + W] for i, k in enumerate(_K_U8_Q8))  # Q8
    hp = h.index_select(img.dim() - 2, reflect_index(H, pad, img.device))
    v = sum(float(k) * hp[..., i : i + H, :] for i, k in enumerate(_K_U8_Q8))  # Q16
    return torch.clamp(torch.floor((v + 32768.0) * (1.0 / 65536.0)), 0.0, 255.0)
