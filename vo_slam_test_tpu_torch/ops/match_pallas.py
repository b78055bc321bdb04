"""Masked Hamming top-2 search: the plain version of the CUDA kernel
``csrc/match.cu`` (see ``ops/match_cuda.py``).

Same path and role as ``vo_slam_test_tpu/ops/match_pallas.py``, whose
``masked_top2_xla`` oracle this copies: build the allowed mask over
[M src, N tgt] pairs, fill the Hamming matrix with BIG where not allowed,
take the first argmin, blank it, take the first argmin again.

    allowed[i,j] = row_ok[i] & col_ok[j]
                 & |col_u[j]-row_u[i]| < row_rw[i]
                 & |col_v[j]-row_v[i]| < row_rw[i]
                 & row_lo[i] <= col_oct[j] <= row_hi[i]
                 & (col_ur[j] <= 0 | |row_ur[i]-col_ur[j]| <= row_rur[i])
"""

from __future__ import annotations

import torch

from . import hamming

BIG = 1 << 20


def allowed_mask(row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
                 col_u, col_v, col_ur, col_oct, col_ok) -> torch.Tensor:
    """[M, N] bool: the gates of the search (module docstring)."""
    du = col_u[None, :] - row_u[:, None]
    dv = col_v[None, :] - row_v[:, None]
    return (
        row_ok[:, None] & col_ok[None, :]
        & (torch.abs(du) < row_rw[:, None])
        & (torch.abs(dv) < row_rw[:, None])
        & (col_oct[None, :] >= row_lo[:, None])
        & (col_oct[None, :] <= row_hi[:, None])
        & ((col_ur[None, :] <= 0.0)
           | (torch.abs(row_ur[:, None] - col_ur[None, :]) <= row_rur[:, None]))
    )


def masked_top2_plain(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
):
    """Returns (best_i, best_d, second_i, second_d), each [M] int32. A row
    with no allowed pair gives (0, BIG, 0, BIG); one allowed pair gives a
    second of (0, BIG). Ties go to the lowest target index."""
    allowed = allowed_mask(row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
                           col_u, col_v, col_ur, col_oct, col_ok)
    D = torch.where(allowed, hamming.distance_matrix(a_desc, b_desc), BIG)
    rows = torch.arange(D.shape[0], device=D.device)
    best = torch.argmin(D, dim=1)
    best_d = D[rows, best]
    D2 = D.clone()
    D2[rows, best] = BIG
    second = torch.argmin(D2, dim=1)
    second_d = D2[rows, second]
    return best.to(torch.int32), best_d, second.to(torch.int32), second_d
