"""On-device quad-tree keypoint distribution (port of
``vo_slam_test_tpu/ops/distribute_device.py``).

After depth d of the reference's DistributeOctTree the live nodes are the
occupied cells of a regular (nIni*2^d x 2^d) grid plus every candidate that
became alone in its cell earlier. A candidate's depth-d cell key is its
depth-7 key with the low (7-d) bits of each coordinate dropped, so one
pairwise XOR matrix of packed depth-7 keys answers "same cell" at every depth
with a mask test; the per-depth statistics are row reductions over [M, M].
The final depth is capped to the target by response (documented deviation of
the JAX package, kept as is).

Cell keys are computed as the JAX package's compiled program computes them:
XLA rewrites ``(x - min) / w * n`` with constant bounds into one multiply by
the folded constant ``f32(f32(1 / w) * n)``, which puts a candidate on a cell
boundary (``(x - min) / w * n`` an exact integer) one cell lower than the
division does (the moving-object scene's frame 0 at 640x480 has one, at
level 3).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_DEPTH = 7


def _int32_mask(m: int) -> int:
    return m - (1 << 32) if m >= (1 << 31) else m


def _cell_scale(extent: float, n_cells: int) -> float:
    """The f32 constant XLA folds ``/ extent * n_cells`` into."""
    return float(np.float32(np.float32(1.0) / np.float32(extent)) * np.float32(n_cells))


def distribute_level(
    xs: torch.Tensor,
    ys: torch.Tensor,
    resp: torch.Tensor,
    valid: torch.Tensor,
    bounds,           # (min_x, max_x, min_y, max_y) floats
    target: int,
    n_ini: int = 1,   # root-cell count (round(w/h); 1 for 4:3)
) -> torch.Tensor:
    """Keep-mask [M] selecting <= target spatially distributed candidates
    (best response per quad-tree node)."""
    min_x, max_x, min_y, max_y = bounds
    w = max_x - min_x
    h = max_y - min_y
    M = xs.shape[0]
    dev = xs.device
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    ncx = n_ini << MAX_DEPTH
    ncy = 1 << MAX_DEPTH
    cx = torch.clamp(((xs.to(torch.float32) - min_x) * _cell_scale(w, ncx)).to(torch.int32),
                     0, ncx - 1)
    cy = torch.clamp(((ys.to(torch.float32) - min_y) * _cell_scale(h, ncy)).to(torch.int32),
                     0, ncy - 1)
    # packed pairwise key difference: XOR acts per field (no carries)
    Z = ((cy[:, None] ^ cy[None, :]) << 16) | (cx[:, None] ^ cx[None, :])

    r = torch.where(valid, resp, -torch.inf)
    # j dominates i: higher response, ties to the lower index
    better = valid[None, :] & (
        (r[None, :] > r[:, None]) | ((r[None, :] == r[:, None]) & (idx[None, :] < idx[:, None]))
    )
    other = valid[None, :] & (idx[None, :] != idx[:, None])

    first_single = torch.full((M,), MAX_DEPTH + 1, dtype=torch.int32, device=dev)
    live, keep_rows, shared_rows = [], [], []
    for d in range(MAX_DEPTH + 1):
        s = MAX_DEPTH - d
        hi = 0xFFFF & ~((1 << s) - 1)
        same = (Z & _int32_mask((hi << 16) | hi)) == 0
        has_other = (same & other).any(dim=1)   # cell count >= 2
        dominated = (same & better).any(dim=1)
        best_here = valid & ~dominated
        alone = valid & ~has_other
        first_single = torch.where(alone & (first_single > d), d, first_single)
        live.append((best_here & has_other).sum(dtype=torch.int32))
        shared_rows.append(has_other)
        keep_rows.append(best_here)

    live_v = torch.stack(live)
    singles_cum = torch.stack(
        [(valid & (first_single <= d)).sum(dtype=torch.int32) for d in range(MAX_DEPTH + 1)]
    )
    reached = (live_v + singles_cum >= target) | (live_v == 0)
    # first depth satisfying the stop condition; MAX_DEPTH when none does
    stop_d = torch.where(reached.any(), torch.argmax(reached.to(torch.int32)), MAX_DEPTH)

    keep_by_depth = torch.stack(
        [(valid & (first_single <= d)) | (keep_rows[d] & shared_rows[d]) for d in range(MAX_DEPTH + 1)]
    )
    keep = keep_by_depth.index_select(0, stop_d.reshape(1))[0]

    # cap to target by response (stable: equal responses keep index order)
    r_kept = torch.where(keep, resp, -torch.inf)
    order = torch.argsort(-r_kept, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(M, device=dev))
    return keep & (rank < target)
