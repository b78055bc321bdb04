"""256-bit Hamming distances for ORB descriptors (port of the XOR+popcount
half of ``vo_slam_test_tpu/ops/hamming.py``).

Descriptors are int32 bit patterns. The SWAR popcount uses arithmetic shifts,
which stays right because every mask clears the sign-extended high bits.
"""

from __future__ import annotations

import torch


def popcount_i32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 bit patterns -> int32 in [0, 32]."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, 8] x [N, 8] int32 -> [M, N] int32 Hamming distances (exact),
    accumulated one 32-bit word at a time."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        out += popcount_i32(a[:, w, None] ^ b[None, :, w])
    return out
