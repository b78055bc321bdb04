"""256-bit Hamming distances for ORB descriptors (port of
``vo_slam_test_tpu/ops/hamming.py``).

Descriptors are int32 bit patterns. ``distance_matrix`` takes the package's
matmul form (``distance_matrix_mxu``): with bits as +-1, a.b = 256 - 2 d,
exact in f32. ``popcount_u32`` and ``hamming`` are the XOR + SWAR popcount
form, exact on the 32-bit patterns (in int64: ``uint32`` lacks ``>>`` on the
CPU, and int32 products would overflow).
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


# the package's matmul form under the JAX package's name for it
distance_matrix_mxu = distance_matrix


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] 32-bit patterns -> [N, 256] {0,1} int8 bit planes (bit b of
    word w at column 32w+b, brief.py's packing)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.int8)


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int32 or int64 lanes) -> int32."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of aligned [..., 8] descriptors -> [...]."""
    return popcount_u32(a ^ b).sum(-1, dtype=torch.int32)
