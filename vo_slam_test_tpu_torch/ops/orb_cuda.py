"""Wrapper of the IC-angle + steered-rBRIEF kernel (``csrc/orb.cu``).

``orb_angle_desc(raw, blur, level, ys, xs)`` launches the kernel for CUDA
tensors and runs the plain versions ``ops/orientation.py::ic_angle`` and
``ops/brief.py::compute_descriptors`` for CPU tensors; any other device
raises. ``KERNEL.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, pattern

KERNEL = _build.Kernel(
    "orb", "orb_angle_desc_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
)


# rows and columns from a keypoint's centre that the kernel's reads reach
# (csrc/orb.cu: REACH); its offsets from the centre are 32-bit
_REACH = 19


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    pat = torch.as_tensor(pattern.bit_pattern_31(), dtype=torch.int32).contiguous()
    umax = torch.as_tensor(pattern.umax_table(), dtype=torch.int32)
    return pat.to(device), umax.to(device)


def orb_angle_desc(
    canvas_raw: torch.Tensor,
    canvas_blur: torch.Tensor,
    level: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canvases [L, CH, CW] f32, level/ys/xs [N] i32 (level-image coords) ->
    (angle [N] f32 degrees, desc [N, 8] i32 bit patterns). Does not
    synchronize."""
    dev = canvas_raw.device
    if dev.type == "cpu":
        from . import brief, orientation

        ang = orientation.ic_angle(canvas_raw, level, ys, xs)
        return ang, brief.compute_descriptors(canvas_blur, level, ys, xs, ang)
    if dev.type != "cuda":
        raise ValueError(f"orb_angle_desc: unsupported device {dev}")
    for name, t in (("canvas_raw", canvas_raw), ("canvas_blur", canvas_blur)):
        if t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"orb_angle_desc: {name} must be a contiguous [L,CH,CW] float32 on {dev}")
    if canvas_blur.shape != canvas_raw.shape:
        raise ValueError("orb_angle_desc: canvas shapes differ")
    N = level.shape[0]
    for name, t in (("level", level), ("ys", ys), ("xs", xs)):
        if t.dtype != torch.int32 or t.shape != (N,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"orb_angle_desc: {name} must be a contiguous [N] int32 on {dev}")
    L, CH, CW = canvas_raw.shape
    if _REACH * CW + _REACH >= 2**31:
        raise ValueError(f"orb_angle_desc: canvas width {CW} too large for the kernel's "
                         "32-bit offsets")
    pat, umax = _tables(dev)
    angle = torch.empty((N,), dtype=torch.float32, device=dev)
    desc = torch.empty((N, 8), dtype=torch.int32, device=dev)
    KERNEL(canvas_raw.data_ptr(), canvas_blur.data_ptr(), level.data_ptr(), ys.data_ptr(),
           xs.data_ptr(), pat.data_ptr(), umax.data_ptr(), N, L, CH, CW,
           angle.data_ptr(), desc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return angle, desc
