"""256-bit Hamming distances for ORB descriptors (port of
``vo_slam_test_tpu/ops/hamming.py``).

Descriptors are int32 bit patterns. ``distance_matrix`` takes the package's
matmul form (``distance_matrix_mxu``): with bits as +-1, a.b = 256 - 2 d,
exact in f32.
"""

from __future__ import annotations

import torch


def _signs(d: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] f32: bit k of word w as 1 - 2 * bit."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    bits = (d[..., None] >> shifts) & 1
    return (1 - 2 * bits).flatten(-2).to(torch.float32)


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, 8] x [..., N, 8] int32 -> [..., M, N] int32 Hamming
    distances (exact: the f32 products and sums are integers of at most
    256)."""
    dot = _signs(a) @ _signs(b).transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)
