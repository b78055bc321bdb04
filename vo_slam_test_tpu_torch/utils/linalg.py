"""Closed-form inverse of 3x3 blocks (port of ``vo_slam_test_tpu/utils/linalg.py``).

Global BA inverts a [P, 3, 3] batch of damped point-Hessian blocks every LM
iteration. The adjugate over the determinant is elementwise math with no
LAPACK call and no status to read back. (Local BA's point blocks are inverted
inside ``csrc/ba.cu``; ``ops/ba_pallas.py::inv3x3_sym`` is its damped
symmetric form.)
"""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Inverse of a [..., 3, 3] batch (adjugate / det). For damped SPD blocks
    (det safely positive); a nonzero ``eps`` bounds |det| from below, so an
    all-zero padding block gives a finite (zero) inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    if eps:
        det = torch.where(torch.abs(det) < eps, torch.where(det < 0, -1.0, 1.0) * eps, det)
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], -1),
            torch.stack([co10, co11, co12], -1),
            torch.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]
