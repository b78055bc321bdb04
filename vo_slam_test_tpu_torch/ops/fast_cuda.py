"""Wrapper of the FAST score kernel (``csrc/fast.cu``).

``fast_score(levels)`` launches the kernel for a CUDA tensor and runs the
plain version ``ops/fast.py::fast_score`` for a CPU tensor; any other device
raises. ``KERNEL.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.Kernel(
    "fast", "fast_score_launch",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def fast_score(levels: torch.Tensor) -> torch.Tensor:
    """[L, H, W] f32 pyramid batch -> [L, H, W] f32 raw FAST score.

    ``levels`` may be a strided view (the canvas interior) whose last axis is
    contiguous; the output is contiguous. The kernel takes pixel values that
    are integers in [0, 255] (the pyramid's 8-bit levels held as f32; it
    computes in packed 16-bit integers, and does not check) and levels of at
    least 3x3 pixels. Does not synchronize."""
    if levels.device.type == "cpu":
        from . import fast

        return fast.fast_score(levels)
    if levels.device.type != "cuda":
        raise ValueError(f"fast_score: unsupported device {levels.device}")
    if levels.dtype != torch.float32 or levels.dim() != 3:
        raise ValueError(f"fast_score: need [L,H,W] float32, got {levels.dtype} {tuple(levels.shape)}")
    if levels.stride(2) != 1:
        raise ValueError("fast_score: the last axis must be contiguous")
    L, H, W = levels.shape
    if H < 3 or W < 3 or L > 65535:
        raise ValueError(f"fast_score: need H, W >= 3 and L <= 65535, got {tuple(levels.shape)}")
    out = torch.empty((L, H, W), dtype=torch.float32, device=levels.device)
    if out.numel():
        KERNEL(levels.data_ptr(), levels.stride(0), levels.stride(1), out.data_ptr(),
               L, H, W, torch.cuda.current_stream(levels.device).cuda_stream)
    return out
