"""Rotation-consistency filter shared by the matchers (port of
``vo_slam_test_tpu/matching/rotation.py``): a 30-bin histogram of keypoint
angle differences; only matches in the 3 largest bins survive, and bins 2/3
are dropped when they hold < 0.1x the best bin's votes."""

from __future__ import annotations

import torch

HISTO_LENGTH = 30
_PDF = HISTO_LENGTH / 360.0


def rotation_bins(angle_a: torch.Tensor, angle_b: torch.Tensor) -> torch.Tensor:
    """Histogram bin of each match's angle difference (cvRound semantics)."""
    rot = angle_a - angle_b
    rot = torch.where(rot < 0, rot + 360.0, rot)
    b = torch.round(rot * _PDF).to(torch.int32)
    return torch.where(b == HISTO_LENGTH, 0, b)


def rotation_consistency_mask(bins: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """matched: [N] bool; returns the keep mask restricted to the top-3 bins."""
    ar = torch.arange(HISTO_LENGTH, device=bins.device)
    onehot = (bins[:, None] == ar[None, :]) & matched[:, None]
    counts = onehot.sum(dim=0, dtype=torch.int32)  # [30]
    top3 = torch.sort(counts, stable=True).values[-3:].flip(0)  # c1 >= c2 >= c3
    c1, c2, c3 = top3[0], top3[1], top3[2]
    keep2 = c2.to(torch.float32) >= 0.1 * c1.to(torch.float32)
    keep3 = c3.to(torch.float32) >= 0.1 * c1.to(torch.float32)
    thresh = torch.where(keep3, c3, torch.where(keep2, c2, c1))
    bin_kept = counts >= torch.clamp(thresh, min=1)
    # ties can admit >3 bins; keep the 3 largest by count (stable order)
    order = torch.argsort(-counts, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(HISTO_LENGTH, device=bins.device))
    bin_kept = bin_kept & (rank < 3)
    return matched & bin_kept[bins.long()]
