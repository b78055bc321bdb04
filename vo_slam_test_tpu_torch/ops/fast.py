"""FAST-9/16 detection over the pyramid batch (port of
``vo_slam_test_tpu/ops/fast.py``).

One dense raw-score map (the CUDA kernel ``csrc/fast.cu`` on the card, the
plain ``fast_score`` below on the CPU), then the reference's cell-local NMS,
per-cell two-threshold retry on the exact variable-pitch grid, and per-cell
top-K compaction as plain torch. Score semantics match OpenCV's
cornerScore<16>: detection at threshold t keeps V > t; response is V - 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast_cuda
from .pyramid import PyramidSpec

# 16-point Bresenham circle of radius 3, OpenCV ordering (dx, dy),
# index 0 at 12 o'clock, clockwise.
CIRCLE16 = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

CELL = 30  # reference cell size
DETECT_BORDER = 16  # EDGE_THRESHOLD - 3: FAST runs inside this inset


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = in[y + dy, x + dx] (wrap; borders masked later)."""
    return torch.roll(x, shifts=(-dy, -dx), dims=(-2, -1))


def fast_score(levels: torch.Tensor) -> torch.Tensor:
    """Plain version of the FAST kernel: [..., H, W] f32 -> raw score V.

    V = max over the 32 contiguous 9-arcs (16 bright + 16 dark) of the minimum
    absolute center/ring difference inside the arc, clamped at 0. Pixel values
    are integers in [0, 255], so f32 is exact (the JAX version's bf16 is too).
    """
    center = levels.to(torch.float32)
    neigh = torch.stack([_shift2d(center, dy, dx) for (dx, dy) in CIRCLE16], dim=-1)
    d = center[..., None] - neigh

    def window9_min(v):
        # cyclic windowed min over the ring axis (16), window 9, via doubling
        w2 = torch.minimum(v, torch.roll(v, -1, dims=-1))
        w4 = torch.minimum(w2, torch.roll(w2, -2, dims=-1))
        w8 = torch.minimum(w4, torch.roll(w4, -4, dims=-1))
        return torch.minimum(w8, torch.roll(v, -8, dims=-1))

    dark = torch.amax(window9_min(d), dim=-1)
    bright = torch.amax(window9_min(-d), dim=-1)
    return torch.clamp_min(torch.maximum(dark, bright), 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels strictly greater than all 8 neighbours (OpenCV FAST NMS);
    neighbours wrap in both axes, as ``_shift2d`` does."""
    keep = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            keep &= score > _shift2d(score, dy, dx)
    return keep


def fast_score_nms(levels: torch.Tensor) -> torch.Tensor:
    """Plain version of the FAST kernel's 3x3-NMS mode: the raw score where
    ``nms3x3`` keeps it, else 0."""
    score = fast_score(levels)
    return torch.where(nms3x3(score), score, 0.0)


@functools.lru_cache(maxsize=None)
def _cell_geometry(spec: PyramidSpec):
    """Per level: (width, height, nCols, nRows, wCell, hCell), the exact
    cv::FAST window grid (nCols = int(width/30), wCell = ceil(width/nCols))."""
    geo = []
    for (h, w) in spec.sizes:
        width = w - 2 * DETECT_BORDER
        height = h - 2 * DETECT_BORDER
        n_cols = max(int(width / 30.0), 1)
        n_rows = max(int(height / 30.0), 1)
        geo.append((width, height, n_cols, n_rows,
                    int(np.ceil(width / n_cols)), int(np.ceil(height / n_rows))))
    return tuple(geo)


@functools.lru_cache(maxsize=None)
def _region_planes_np(spec: PyramidSpec):
    """Static planes of the cell-local NMS: det [L,H,W] (inside some cell's
    FAST detection region), col_l/col_r [L,W] and row_t/row_b [L,H] (on its
    cell's left/right edge column, top/bottom edge row)."""
    geo = _cell_geometry(spec)
    L = spec.n_levels
    H, W = spec.sizes[0]
    b = DETECT_BORDER
    det = np.zeros((L, H, W), bool)
    col_l = np.zeros((L, W), bool)
    col_r = np.zeros((L, W), bool)
    row_t = np.zeros((L, H), bool)
    row_b = np.zeros((L, H), bool)
    for lvl, (h, w) in enumerate(spec.sizes):
        width, height, n_cols, n_rows, w_cell, h_cell = geo[lvl]
        x = np.arange(w)
        y = np.arange(h)
        relx = x - b - 3
        rely = y - b - 3
        jx = relx // w_cell
        iy = rely // h_cell
        x_ok = (relx >= 0) & (x < b + width - 3) & (jx < n_cols) & (jx * w_cell < width - 6)
        y_ok = (rely >= 0) & (y < b + height - 3) & (iy < n_rows) & (iy * h_cell < height - 3)
        det[lvl, :h, :w] = y_ok[:, None] & x_ok[None, :]
        col_l[lvl, :w] = relx % w_cell == 0
        col_r[lvl, :w] = relx % w_cell == w_cell - 1
        row_t[lvl, :h] = rely % h_cell == 0
        row_b[lvl, :h] = rely % h_cell == h_cell - 1
    return det, col_l, col_r, row_t, row_b


@functools.lru_cache(maxsize=8)
def _region_planes(spec: PyramidSpec, device: torch.device):
    return tuple(torch.as_tensor(p, device=device) for p in _region_planes_np(spec))


def _cell_local_nms(score: torch.Tensor, spec: PyramidSpec, threshold: float) -> torch.Tensor:
    """NMS whose suppression context is local to the same cv::FAST window: a
    corner on a cell edge never sees the stronger corner across it."""
    det, col_l, col_r, row_t, row_b = _region_planes(spec, score.device)
    corner = det & (score > threshold)
    ms = torch.where(corner, score, 0.0)
    keep = corner
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ok = _shift2d(det, dy, dx)
            if dx == 1:
                ok = ok & ~col_r[:, None, :]
            if dx == -1:
                ok = ok & ~col_l[:, None, :]
            if dy == 1:
                ok = ok & ~row_b[:, :, None]
            if dy == -1:
                ok = ok & ~row_t[:, :, None]
            keep = keep & (score > torch.where(ok, _shift2d(ms, dy, dx), 0.0))
    return keep


def _cell_retry_select(keep_hi: torch.Tensor, keep_lo: torch.Tensor, spec: PyramidSpec) -> torch.Tensor:
    """Per-cell two-threshold retry: a cell keeps its hi-threshold survivors
    if any exist, else its lo-threshold survivors."""
    geo = _cell_geometry(spec)
    outs = []
    for lvl in range(spec.n_levels):
        _, _, n_cols, n_rows, w_cell, h_cell = geo[lvl]
        y0 = x0 = DETECT_BORDER + 3
        span_y = n_rows * h_cell
        span_x = n_cols * w_cell
        kh = keep_hi[lvl]
        kl = keep_lo[lvl]
        H, W = kh.shape
        pad_y = max(0, y0 + span_y - H)
        pad_x = max(0, x0 + span_x - W)
        khp = F.pad(kh, (0, pad_x, 0, pad_y))[y0:y0 + span_y, x0:x0 + span_x]
        klp = F.pad(kl, (0, pad_x, 0, pad_y))[y0:y0 + span_y, x0:x0 + span_x]
        cells_hi = khp.reshape(n_rows, h_cell, n_cols, w_cell).any(dim=3).any(dim=1)
        has_hi = cells_hi.repeat_interleave(h_cell, 0).repeat_interleave(w_cell, 1)
        sel = torch.where(has_hi, khp, klp)
        full = torch.zeros((H + pad_y, W + pad_x), dtype=torch.bool, device=kh.device)
        full[y0:y0 + span_y, x0:x0 + span_x] = sel
        outs.append(full[:H, :W])
    return torch.stack(outs)


class CellCandidates(NamedTuple):
    """Fixed-shape per-cell top-K FAST candidates for the whole pyramid."""

    ys: torch.Tensor        # [L, C, K] int32 level-image y
    xs: torch.Tensor        # [L, C, K] int32 level-image x
    response: torch.Tensor  # [L, C, K] f32 (V - 1, OpenCV response)
    valid: torch.Tensor     # [L, C, K] bool


def cell_grid_shape(spec: PyramidSpec) -> Tuple[int, int]:
    h, w = spec.sizes[0]
    return -(-(h - 2 * DETECT_BORDER) // CELL), -(-(w - 2 * DETECT_BORDER) // CELL)


def select_candidates(
    score: torch.Tensor,
    spec: PyramidSpec,
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    top_k: int = 8,
) -> CellCandidates:
    """Cell-local NMS, two-threshold retry and per-cell top-K on a raw score
    map [L, H, W]."""
    L = score.shape[0]
    H, W = spec.sizes[0]
    keep_hi = _cell_local_nms(score, spec, threshold_hi)
    keep_lo = _cell_local_nms(score, spec, threshold_lo)
    keep = _cell_retry_select(keep_hi, keep_lo, spec)
    score_kept = torch.where(keep, score, 0.0)

    # 30 px compaction grid (a compaction structure only, not the reference's
    # cell grid)
    ncy, ncx = cell_grid_shape(spec)
    pad_y = DETECT_BORDER + ncy * CELL - H
    pad_x = DETECT_BORDER + ncx * CELL - W
    s = F.pad(score_kept, (0, max(pad_x, 0), 0, max(pad_y, 0)))
    s = s[:, DETECT_BORDER:DETECT_BORDER + ncy * CELL, DETECT_BORDER:DETECT_BORDER + ncx * CELL]
    cells = s.reshape(L, ncy, CELL, ncx, CELL).permute(0, 1, 3, 2, 4)
    cur = cells.reshape(L, ncy * ncx, CELL * CELL)

    # top-K by K masked argmaxes (first index on ties, like jnp.argmax)
    iota = torch.arange(cur.shape[-1], dtype=torch.int32, device=score.device)
    vals_l, idx_l = [], []
    for _ in range(top_k):
        i = torch.argmax(cur, dim=-1).to(torch.int32)
        vals_l.append(torch.amax(cur, dim=-1))
        idx_l.append(i)
        cur = torch.where(iota[None, None, :] == i[..., None], -1.0, cur)
    vals = torch.stack(vals_l, dim=-1)
    idx = torch.stack(idx_l, dim=-1)
    cell_ids = torch.arange(ncy * ncx, dtype=torch.int32, device=score.device)
    base_y = DETECT_BORDER + torch.div(cell_ids, ncx, rounding_mode="floor") * CELL
    base_x = DETECT_BORDER + (cell_ids % ncx) * CELL
    ys = base_y[None, :, None] + torch.div(idx, CELL, rounding_mode="floor")
    xs = base_x[None, :, None] + idx % CELL
    return CellCandidates(
        ys=ys.to(torch.int32),
        xs=xs.to(torch.int32),
        response=torch.clamp_min(vals - 1.0, 0.0),
        valid=vals > 0.0,
    )


def detect_pyramid(
    levels: torch.Tensor,
    spec: PyramidSpec,
    threshold_hi: float = 20.0,
    threshold_lo: float = 7.0,
    top_k: int = 8,
) -> CellCandidates:
    """Dense FAST score (kernel on the card) + cell-local NMS + per-cell
    two-threshold top-K over all levels."""
    return select_candidates(fast_cuda.fast_score(levels), spec, threshold_hi, threshold_lo, top_k)
