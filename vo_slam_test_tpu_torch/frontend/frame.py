"""Frame feature container (fixed-shape struct of tensors; port of
``vo_slam_test_tpu/frontend/frame.py``).

Descriptors are carried as int32 bit patterns: torch has no ``>>`` or ``-``
for uint32 on the CPU. ``convert.py`` views them as uint32 at the boundary.
"""

from __future__ import annotations

import dataclasses

import torch

MAX_FEATURES = 1024


@dataclasses.dataclass
class FrameFeatures:
    """Padded per-keypoint tensors; entries with ``valid == False`` are padding."""

    uv: torch.Tensor        # [N, 2] f32 raw (distorted) level-0 coords
    uv_und: torch.Tensor    # [N, 2] f32 undistorted coords
    response: torch.Tensor  # [N] f32 FAST response
    angle: torch.Tensor     # [N] f32 degrees [0, 360)
    octave: torch.Tensor    # [N] i32 pyramid level
    depth: torch.Tensor     # [N] f32 meters; -1 when missing
    u_right: torch.Tensor   # [N] f32 virtual right-image u; -1 when no depth
    desc: torch.Tensor      # [N, 8] i32 bit patterns of the packed 256-bit rBRIEF
    valid: torch.Tensor     # [N] bool

    @classmethod
    def empty(cls, device: torch.device, n: int = MAX_FEATURES) -> "FrameFeatures":
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            uv=z(n, 2), uv_und=z(n, 2), response=z(n), angle=z(n),
            octave=z(n, dtype=torch.int32), depth=z(n), u_right=z(n),
            desc=z(n, 8, dtype=torch.int32), valid=z(n, dtype=torch.bool),
        )
