"""Wrapper of the masked Hamming top-2 kernel (``csrc/match.cu``).

``masked_top2(...)`` launches the kernel for CUDA tensors and runs the plain
version ``ops/match_pallas.py::masked_top2_plain`` for CPU tensors; any other
device raises. ``KERNEL.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

KERNEL = _build.Kernel(
    "match", "masked_top2_launch",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5,
)

_MAX_COLS = 1 << 22  # column index field of the kernel's packed keys


def masked_top2(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """a_desc [M,8], b_desc [N,8] int32 bit patterns; row_* [M] (f32 u, v,
    rw, ur, rur; i32 lo, hi; bool ok); col_* [N] (f32 u, v, ur; i32 oct;
    bool ok) -> (best_i, best_d, second_i, second_d), each [M] int32.
    Does not synchronize."""
    dev = a_desc.device
    if dev.type == "cpu":
        from . import match_pallas

        return match_pallas.masked_top2_plain(
            a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
            row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok)
    if dev.type != "cuda":
        raise ValueError(f"masked_top2: unsupported device {dev}")
    M, N = a_desc.shape[0], b_desc.shape[0]
    if N >= _MAX_COLS:
        raise ValueError(f"masked_top2: N={N} exceeds {_MAX_COLS - 1}")
    specs = [
        ("a_desc", a_desc, torch.int32, (M, 8)), ("b_desc", b_desc, torch.int32, (N, 8)),
        ("row_u", row_u, torch.float32, (M,)), ("row_v", row_v, torch.float32, (M,)),
        ("row_rw", row_rw, torch.float32, (M,)), ("row_ur", row_ur, torch.float32, (M,)),
        ("row_rur", row_rur, torch.float32, (M,)), ("row_lo", row_lo, torch.int32, (M,)),
        ("row_hi", row_hi, torch.int32, (M,)), ("row_ok", row_ok, torch.bool, (M,)),
        ("col_u", col_u, torch.float32, (N,)), ("col_v", col_v, torch.float32, (N,)),
        ("col_ur", col_ur, torch.float32, (N,)), ("col_oct", col_oct, torch.int32, (N,)),
        ("col_ok", col_ok, torch.bool, (N,)),
    ]
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"masked_top2: {name} must be a contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("a_desc", a_desc), ("b_desc", b_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"masked_top2: {name} must be 16-byte aligned")
    outs = [torch.empty((M,), dtype=torch.int32, device=dev) for _ in range(4)]
    KERNEL(*[t.data_ptr() for _, t, _, _ in specs], M, N,
           *[o.data_ptr() for o in outs], torch.cuda.current_stream(dev).cuda_stream)
    return tuple(outs)
