"""Wrappers of the masked Hamming search kernels (``csrc/match.cu``,
``csrc/epi.cu``).

Each wrapper launches its kernel for CUDA tensors and runs the plain version
in ``ops/match_pallas.py`` for CPU tensors; any other device raises. The
top-2 searches all launch ``match.cu``'s one entry point; each call site has
its own ``_build.Kernel`` bound to it, and so its own launch count:

- ``KERNEL``: the frame-to-frame projection search (stereo-window gate);
- ``KERNEL_LOCAL``: the local-map search (stereo-window gate);
- ``KERNEL_CHI2``: the chi2 reprojection gate (``fuse_into_keyframe``);
- ``KERNEL_NB``: B neighbour-batched chi2 searches in one launch
  (``fuse_curr_into_neighbors``);
- ``KERNEL_EPI``: epipolar-gated top-1 (``create_new_map_points``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, match_pallas

_P, _I = ctypes.c_void_p, ctypes.c_int
_TOP2_ARGS = [_P, ctypes.c_longlong] + [_P] * 15 + [_I] * 4 + [_P] * 5
KERNEL = _build.Kernel("match", "masked_top2_launch", _TOP2_ARGS)
KERNEL_LOCAL = _build.Kernel("match", "masked_top2_launch", _TOP2_ARGS)
KERNEL_CHI2 = _build.Kernel("match", "masked_top2_launch", _TOP2_ARGS)
KERNEL_NB = _build.Kernel("match", "masked_top2_launch", _TOP2_ARGS)
KERNEL_EPI = _build.Kernel("epi", "masked_top1_epi_launch", [_P] * 13 + [_I] * 2 + [_P] * 3)

_MAX_COLS = 1 << 22  # column index field of the kernels' packed keys
_F32, _I32, _B = torch.float32, torch.int32, torch.bool


def _check(fn: str, dev: torch.device, specs) -> None:
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _aligned(fn: str, **descs) -> None:
    for name, t in descs.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _device(fn: str, t: torch.Tensor, n_cols: int) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    if n_cols >= _MAX_COLS:
        raise ValueError(f"{fn}: N={n_cols} exceeds {_MAX_COLS - 1}")
    return t.device


_ROW_F = ("row_u", "row_v", "row_rw", "row_ur", "row_rur")
_COL_F = ("col_u", "col_v", "col_ur")


def _launch_top2(fn, kernel, a_desc, b_desc, rows, cols, col_isig2, chi2_gate, B, M, N):
    """Checks the [B,M] / [B,N] arguments and launches ``kernel`` (one of the
    top-2 call sites) over the B searches -> four [B,M] int32."""
    dev = _device(fn, a_desc, N)
    if (a_desc.dtype != _I32 or tuple(a_desc.shape) != (B, M, 8) or a_desc.device != dev
            or a_desc.stride(1) != 8 or a_desc.stride(2) != 1 or a_desc.stride(0) % 8):
        raise ValueError(f"{fn}: a_desc must be int32 [B,M,8] on the card with contiguous "
                         "rows and a neighbour stride that is a multiple of 8")
    r_u, r_v, r_rw, r_ur, r_rur, r_lo, r_hi, r_ok = rows
    c_u, c_v, c_ur, c_oct, c_ok = cols
    specs = [("b_desc", b_desc, _I32, (B, N, 8))]
    specs += [(n, t, _F32, (B, M)) for n, t in zip(_ROW_F, (r_u, r_v, r_rw, r_ur, r_rur))]
    specs += [("row_lo", r_lo, _I32, (B, M)), ("row_hi", r_hi, _I32, (B, M)),
              ("row_ok", r_ok, _B, (B, M))]
    specs += [(n, t, _F32, (B, N)) for n, t in zip(_COL_F, (c_u, c_v, c_ur))]
    specs += [("col_oct", c_oct, _I32, (B, N)), ("col_ok", c_ok, _B, (B, N))]
    if chi2_gate:
        specs.append(("col_isig2", col_isig2, _F32, (B, N)))
    _check(fn, dev, specs)
    _aligned(fn, a_desc=a_desc, b_desc=b_desc)
    outs = [torch.empty((B, M), dtype=_I32, device=dev) for _ in range(4)]
    ptrs = [t.data_ptr() for _, t, _, _ in specs]
    kernel(a_desc.data_ptr(), a_desc.stride(0) // 8, *ptrs[:14],
           ptrs[14] if chi2_gate else None, int(chi2_gate), B, M, N,
           *[o.data_ptr() for o in outs], torch.cuda.current_stream(dev).cuda_stream)
    return outs


def masked_top2(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
    col_isig2=None, chi2_gate: bool = False, kernel: _build.Kernel | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """a_desc [M,8], b_desc [N,8] int32 bit patterns; row_* [M] (f32 u, v,
    rw, ur, rur; i32 lo, hi; bool ok); col_* [N] (f32 u, v, ur; i32 oct;
    bool ok); col_isig2 f32 [N] with ``chi2_gate`` -> (best_i, best_d,
    second_i, second_d), each [M] int32. ``kernel`` names the call site whose
    launch count goes up (default ``KERNEL_CHI2`` with the chi2 gate, else
    ``KERNEL``). Does not synchronize."""
    if a_desc.device.type == "cpu":
        return match_pallas.masked_top2_plain(
            a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
            row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
            col_isig2, chi2_gate)
    if kernel is None:
        kernel = KERNEL_CHI2 if chi2_gate else KERNEL
    M, N = a_desc.shape[0], b_desc.shape[0]
    rows = (row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok)
    cols = (col_u, col_v, col_ur, col_oct, col_ok)
    outs = _launch_top2(
        "masked_top2", kernel, a_desc[None], b_desc[None], [t[None] for t in rows],
        [t[None] for t in cols], None if col_isig2 is None else col_isig2[None], chi2_gate,
        1, M, N)
    return tuple(o[0] for o in outs)


def masked_top2_nb(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
    col_isig2=None, chi2_gate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """B independent searches in one launch: a_desc [B,M,8] (its neighbour
    stride may be 0, e.g. ``expand`` of one [M,8] set), b_desc [B,N,8],
    row_* [B,M], col_* [B,N], col_isig2 [B,N] with ``chi2_gate`` -> four
    [B,M] int32. Does not synchronize."""
    if a_desc.device.type == "cpu":
        return match_pallas.masked_top2_nb_plain(
            a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
            row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
            col_isig2, chi2_gate)
    B, M = a_desc.shape[:2]
    N = b_desc.shape[1]
    return tuple(_launch_top2(
        "masked_top2_nb", KERNEL_NB, a_desc, b_desc,
        (row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok),
        (col_u, col_v, col_ur, col_oct, col_ok), col_isig2, chi2_gate, B, M, N))


def masked_top1_epi(
    a_desc, b_desc, row_l, row_den, row_g, row_ok, row_mono,
    col_u, col_v, col_thr, col_g, col_ok, col_flag,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_desc [M,8], b_desc [N,8] int32; row_l f32 [M,3], row_den f32 [M],
    row_g i32 [M], row_ok / row_mono bool [M]; col_u, col_v, col_thr f32 [N],
    col_g i32 [N], col_ok / col_flag bool [N] -> (best_i, best_d), each [M]
    int32. Does not synchronize."""
    if a_desc.device.type == "cpu":
        return match_pallas.masked_top1_epi_plain(
            a_desc, b_desc, row_l, row_den, row_g, row_ok, row_mono,
            col_u, col_v, col_thr, col_g, col_ok, col_flag)
    M, N = a_desc.shape[0], b_desc.shape[0]
    dev = _device("masked_top1_epi", a_desc, N)
    specs = [
        ("a_desc", a_desc, _I32, (M, 8)), ("b_desc", b_desc, _I32, (N, 8)),
        ("row_l", row_l, _F32, (M, 3)), ("row_den", row_den, _F32, (M,)),
        ("row_g", row_g, _I32, (M,)), ("row_ok", row_ok, _B, (M,)),
        ("row_mono", row_mono, _B, (M,)),
        ("col_u", col_u, _F32, (N,)), ("col_v", col_v, _F32, (N,)),
        ("col_thr", col_thr, _F32, (N,)), ("col_g", col_g, _I32, (N,)),
        ("col_ok", col_ok, _B, (N,)), ("col_flag", col_flag, _B, (N,)),
    ]
    _check("masked_top1_epi", dev, specs)
    _aligned("masked_top1_epi", a_desc=a_desc, b_desc=b_desc)
    outs = [torch.empty((M,), dtype=_I32, device=dev) for _ in range(2)]
    KERNEL_EPI(*[t.data_ptr() for _, t, _, _ in specs], M, N,
               *[o.data_ptr() for o in outs], torch.cuda.current_stream(dev).cuda_stream)
    return tuple(outs)
