"""Masked Hamming searches: the plain versions of the CUDA kernels in
``csrc/match.cu`` and ``csrc/epi.cu`` (see ``ops/match_cuda.py``).

Same path and role as ``vo_slam_test_tpu/ops/match_pallas.py``, whose
``masked_top2_xla`` and ``masked_top1_epi_xla`` oracles these copy: build the
allowed mask over [M src, N tgt] pairs, fill the Hamming matrix with BIG where
not allowed, take the first argmin (and for top-2 blank it and take the first
argmin again).

Top-2 gates (projection matching):

    allowed[i,j] = row_ok[i] & col_ok[j]
                 & |col_u[j]-row_u[i]| < row_rw[i]
                 & |col_v[j]-row_v[i]| < row_rw[i]
                 & row_lo[i] <= col_oct[j] <= row_hi[i]
                 & (col_ur[j] <= 0 | |row_ur[i]-col_ur[j]| <= row_rur[i])

With ``chi2_gate=True`` (fuse, matcher.cpp:1080-1099) the last line becomes a
per-pair chi2 reprojection gate, err * col_isig2[j] <= bound with
err = du^2 + dv^2 (+ (row_ur[i]-col_ur[j])^2 when col_ur[j] >= 0) and bound
7.815 for stereo, 5.991 for mono targets.

Epipolar top-1 (triangulation, matcher.cpp:867-1010, 1306-1324):

    num = (lx[i]*u[j] + ly[i]*v[j]) + lz[i]
    allowed[i,j] = row_ok[i] & col_ok[j] & num*num < den[i]*thr[j]
                 & (g1[i] == g2[j] | g1[i] < 0 | g2[j] < 0)
                 & ~(row_mono[i] & col_flag[j])
"""

from __future__ import annotations

import torch

from ..utils import graphs
from . import hamming

BIG = 1 << 20
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def allowed_mask(row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
                 col_u, col_v, col_ur, col_oct, col_ok, col_isig2=None,
                 chi2_gate: bool = False) -> torch.Tensor:
    """[M, N] bool: the gates of the top-2 search (module docstring)."""
    du = col_u[None, :] - row_u[:, None]
    dv = col_v[None, :] - row_v[:, None]
    allowed = (
        row_ok[:, None] & col_ok[None, :]
        & (torch.abs(du) < row_rw[:, None])
        & (torch.abs(dv) < row_rw[:, None])
        & (col_oct[None, :] >= row_lo[:, None])
        & (col_oct[None, :] <= row_hi[:, None])
    )
    if chi2_gate:
        e2 = du * du + dv * dv
        dur = row_ur[:, None] - col_ur[None, :]
        e2s = e2 + dur * dur
        return allowed & torch.where(col_ur[None, :] >= 0.0,
                                     e2s * col_isig2[None, :] <= CHI2_STEREO,
                                     e2 * col_isig2[None, :] <= CHI2_MONO)
    return allowed & ((col_ur[None, :] <= 0.0)
                      | (torch.abs(row_ur[:, None] - col_ur[None, :]) <= row_rur[:, None]))


def _top2(D: torch.Tensor):
    rows = torch.arange(D.shape[0], device=D.device)
    best = torch.argmin(D, dim=1)
    best_d = D[rows, best]
    D2 = D.clone()
    D2[rows, best] = BIG
    second = torch.argmin(D2, dim=1)
    second_d = D2[rows, second]
    return best.to(torch.int32), best_d, second.to(torch.int32), second_d


def masked_top2_plain(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
    col_isig2=None, chi2_gate: bool = False,
):
    """Returns (best_i, best_d, second_i, second_d), each [M] int32. A row
    with no allowed pair gives (0, BIG, 0, BIG); one allowed pair gives a
    second of (0, BIG). Ties go to the lowest target index."""
    if row_ok.device.type == "cpu" and not graphs.cpu_flag(row_ok.any()):
        # no live row (a step program's untaken branch in select mode runs
        # such searches): every row's answer without the pairs
        zero = torch.zeros(row_ok.shape, dtype=torch.int32)
        big = torch.full(row_ok.shape, BIG, dtype=torch.int32)
        return zero, big, zero.clone(), big.clone()
    allowed = allowed_mask(row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
                           col_u, col_v, col_ur, col_oct, col_ok, col_isig2, chi2_gate)
    return _top2(torch.where(allowed, hamming.distance_matrix(a_desc, b_desc), BIG))


def masked_top2_nb_plain(
    a_desc, b_desc, row_u, row_v, row_rw, row_ur, row_rur,
    row_lo, row_hi, row_ok, col_u, col_v, col_ur, col_oct, col_ok,
    col_isig2=None, chi2_gate: bool = False,
):
    """B independent searches: every argument carries a leading neighbour
    axis ([B,M,8], [B,N,8], [B,M], [B,N]); returns four [B,M] int32."""
    B = a_desc.shape[0]
    outs = [masked_top2_plain(
        a_desc[i], b_desc[i], row_u[i], row_v[i], row_rw[i], row_ur[i], row_rur[i],
        row_lo[i], row_hi[i], row_ok[i], col_u[i], col_v[i], col_ur[i], col_oct[i], col_ok[i],
        None if col_isig2 is None else col_isig2[i], chi2_gate) for i in range(B)]
    return tuple(torch.stack(x) for x in zip(*outs))


def epi_allowed_mask(row_l, row_den, row_g, row_ok, row_mono,
                     col_u, col_v, col_thr, col_g, col_ok, col_flag) -> torch.Tensor:
    """[M, N] bool: the gates of the epipolar search (module docstring)."""
    num = row_l[:, 0:1] * col_u[None, :] + row_l[:, 1:2] * col_v[None, :] + row_l[:, 2:3]
    return (
        row_ok[:, None] & col_ok[None, :]
        & (num * num < row_den[:, None] * col_thr[None, :])
        & ((row_g[:, None] == col_g[None, :]) | (row_g < 0)[:, None] | (col_g < 0)[None, :])
        & ~(row_mono[:, None] & col_flag[None, :])
    )


def masked_top1_epi_plain(
    a_desc, b_desc, row_l, row_den, row_g, row_ok, row_mono,
    col_u, col_v, col_thr, col_g, col_ok, col_flag,
):
    """Returns (best_i, best_d), each [M] int32; (0, BIG) where no pair is
    allowed, ties to the lowest target index."""
    allowed = epi_allowed_mask(row_l, row_den, row_g, row_ok, row_mono,
                               col_u, col_v, col_thr, col_g, col_ok, col_flag)
    D = torch.where(allowed, hamming.distance_matrix(a_desc, b_desc), BIG)
    best = torch.argmin(D, dim=1)
    return best.to(torch.int32), D[torch.arange(D.shape[0], device=D.device), best]
