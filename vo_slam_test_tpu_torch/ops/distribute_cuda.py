"""Wrapper of the quad-tree distribution kernel (``csrc/distribute.cu``).

``distribute(xs, ys, resp, valid, levels)`` computes the keep mask [L, M] of
every level in one launch for CUDA tensors, and for CPU tensors runs the plain
version ``ops/distribute_device.py::distribute_level`` once a level; any
other device raises. ``KERNEL.launches`` counts the launches. The kernel
takes up to 32 levels of up to 49,152 candidates (``csrc/distribute.cu``'s
``MAX_LEVELS`` and ``MAX_TILES``); beyond, its launch fails.

This is a kernel of the port's own, not the port of a Pallas kernel: the JAX
package leaves the quad-tree to XLA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .distribute_device import MAX_DEPTH, _cell_scale, distribute_level

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
KERNEL = _build.Kernel("distribute", "distribute_launch", _ARGS)


class Level(NamedTuple):
    """One level's quad-tree: its bounds (min_x, max_x, min_y, max_y), the
    number of keypoints it keeps and its root-cell count (round(w / h))."""

    bounds: Tuple[float, float, float, float]
    target: int
    n_ini: int


def distribute(xs: torch.Tensor, ys: torch.Tensor, resp: torch.Tensor, valid: torch.Tensor,
               levels: Sequence[Level]) -> torch.Tensor:
    """Keep mask [L, M] bool: for each level l, at most ``levels[l].target``
    of the candidates (xs, ys int32 level-image coordinates, resp f32, valid
    bool, each [L, M]) spread over the level by the quad-tree, as
    ``distribute_level`` selects them. Responses of valid candidates must be
    finite. Does not synchronize."""
    if xs.device.type == "cpu":
        return torch.stack([distribute_level(xs[l], ys[l], resp[l], valid[l], lv.bounds,
                                             lv.target, n_ini=lv.n_ini)
                            for l, lv in enumerate(levels)])
    if xs.device.type != "cuda":
        raise ValueError(f"distribute: unsupported device {xs.device}")
    L = len(levels)
    if xs.dim() != 2 or xs.shape[0] != L:
        raise ValueError(f"distribute: need [L, M] candidates for {L} levels, "
                         f"got {tuple(xs.shape)}")
    shape = xs.shape
    for name, t, dtype in (("xs", xs, torch.int32), ("ys", ys, torch.int32),
                           ("resp", resp, torch.float32), ("valid", valid, torch.bool)):
        if t.dtype != dtype or t.shape != shape or t.device != xs.device:
            raise ValueError(f"distribute: {name} must be {dtype} {tuple(shape)} on {xs.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    M = shape[1]
    lvl_f = np.empty((L, 4), np.float32)
    lvl_i = np.empty((L, 3), np.int32)
    for l, lv in enumerate(levels):
        min_x, max_x, min_y, max_y = lv.bounds
        ncx, ncy = lv.n_ini << MAX_DEPTH, 1 << MAX_DEPTH
        if ncx > 1 << 16:
            raise ValueError(f"distribute: n_ini {lv.n_ini} too large")
        lvl_f[l] = (min_x, min_y, _cell_scale(max_x - min_x, ncx), _cell_scale(max_y - min_y, ncy))
        lvl_i[l] = (ncx, ncy, lv.target)
    keep = torch.empty(shape, dtype=torch.bool, device=xs.device)
    if M:
        xs, ys, resp, valid = (t.contiguous() for t in (xs, ys, resp, valid))
        KERNEL(xs.data_ptr(), ys.data_ptr(), resp.data_ptr(), valid.data_ptr(), keep.data_ptr(),
               L, M, lvl_f.ctypes.data, lvl_i.ctypes.data,
               torch.cuda.current_stream(xs.device).cuda_stream)
    return keep
