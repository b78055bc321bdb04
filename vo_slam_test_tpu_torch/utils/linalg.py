"""Closed-form inverse of 3x3 blocks (port of ``vo_slam_test_tpu/utils/linalg.py``)
and the plain version of the small symmetric eigensolver.

Global BA inverts a [P, 3, 3] batch of damped point-Hessian blocks every LM
iteration. The adjugate over the determinant is elementwise math with no
LAPACK call and no status to read back. (Local BA's point blocks are inverted
inside ``csrc/ba.cu``; ``ops/ba_pallas.py::inv3x3_sym`` is its damped
symmetric form.)

``symeig_jacobi`` is the plain version of ``csrc/symeig.cu`` (through
``ops/symeig_cuda.py::symeig``), which Horn's alignment and EPnP call where
the JAX package calls ``jnp.linalg.svd``/``eigh``: ``torch.linalg.eigh`` and
``svd`` read their status back to the host, which a captured step cannot.

``spd_solve`` is the essential graph's dense solve (``solvers/pose_graph.py``).
"""

from __future__ import annotations

import torch

from . import graphs


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


# ---------------------------------------------------------------------------
# the symmetric eigensolver for small matrices (plain version of csrc/symeig.cu)
# ---------------------------------------------------------------------------

SYMEIG_MAX_N = 12     # EPnP's M^T M
SYMEIG_SWEEPS = 12    # sweep cap
SYMEIG_TOL = 1e-14    # converged: every |a_pq| <= TOL * max |a_ii|


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A x = b`` for one symmetric positive definite [n, n] ``A`` and [n]
    ``b``: a Cholesky factor and two triangular solves (cuSOLVER's LU of one
    large matrix, ``torch.linalg.solve_ex``'s path, does not instantiate
    inside a nested conditional node on the card; ``torch.cholesky_solve``
    does not inside any). A matrix that is not positive definite gives NaN,
    as JAX's Cholesky does."""
    chol, info = torch.linalg.cholesky_ex(A)
    chol = torch.where(info == 0, chol, torch.nan)
    half = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, half, upper=True)[:, 0]


def jacobi_rounds(n: int) -> list:
    """The parallel (round-robin) order of one Jacobi sweep over an n x n
    matrix: n - 1 rounds (n even; n + 1 with a bye when odd) of disjoint
    pairs (p, q), p < q, every pair once per sweep. Position m - 1 stays,
    the others turn: round r pairs (r, m - 1) and ((r + k) mod (m - 1),
    (r - k) mod (m - 1)) for k = 1 .. m/2 - 1 (``csrc/symeig.cu`` builds the
    same rounds)."""
    m = n + (n & 1)
    rounds = []
    for r in range(m - 1):
        pairs = [(r, m - 1)] + [((r + k) % (m - 1), (r - k) % (m - 1)) for k in range(1, m // 2)]
        rounds.append([(min(a, b), max(a, b)) for a, b in pairs if max(a, b) < n])
    return rounds


def _rotation(app, aqq, apq, active):
    """The Jacobi rotation (c, s) that zeroes a_pq (Golub & Van Loan's
    sym.schur2), op for op as the kernel computes it; (1, 0) where a_pq is 0
    or the matrix has converged."""
    tau = (aqq - app) / (2.0 * apq)
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    rot = (apq != 0) & active[:, None]
    return torch.where(rot, c, 1.0), torch.where(rot, s, 0.0)


_ROUND_CACHE: dict = {}


def _round_indices(n: int, device) -> list:
    """Per round of ``jacobi_rounds(n)``: index tensors P, Q, P then Q, and
    the flat positions of (a_pp, a_qq, a_pq) in a row-major n x n matrix."""
    key = (n, str(device))
    if key not in _ROUND_CACHE:
        out = []
        for r in jacobi_rounds(n):
            P = torch.tensor([p for p, _ in r], device=device)
            Q = torch.tensor([q for _, q in r], device=device)
            out.append((P, Q, torch.cat([P, Q]), torch.cat([P * (n + 1), Q * (n + 1), P * n + Q])))
        _ROUND_CACHE[key] = out
    return _ROUND_CACHE[key]


def symeig_jacobi(A: torch.Tensor, return_sweeps: bool = False) -> tuple:
    """Eigenvalues (ascending) and eigenvectors (columns) of a batch of
    symmetric [..., n, n] matrices, n <= ``SYMEIG_MAX_N``: the plain version
    of ``csrc/symeig.cu``, the same arithmetic in the same order.

    In f64: the input is symmetrized ((A + A^T) / 2), then parallel-order
    cyclic Jacobi sweeps (``jacobi_rounds``) rotate it, at most
    ``SYMEIG_SWEEPS``; a matrix whose largest off-diagonal magnitude is at
    most ``SYMEIG_TOL`` times its largest diagonal one at a sweep's start
    stops rotating (a device flag, nothing read back; on the CPU the loop
    also ends once every matrix has stopped). The eigenvalues are
    sorted ascending (stable), and each eigenvector's component of largest
    magnitude (the first such) is made positive. A matrix with a non-finite
    entry gives NaN values and vectors. Returns the input's dtype; with
    ``return_sweeps`` also each matrix's count of sweeps that rotated (the
    work its data needed)."""
    n = A.shape[-1]
    if A.shape[-2] != n or not 1 <= n <= SYMEIG_MAX_N:
        raise ValueError(f"symeig_jacobi: need [..., n, n] with n <= {SYMEIG_MAX_N}, "
                         f"got {tuple(A.shape)}")
    batch = A.shape[:-2]
    B = A.reshape(-1, n, n).to(torch.float64)
    bad = ~torch.isfinite(B).all(-1).all(-1)
    B = torch.where(bad[:, None, None], 0.0, B)
    B = 0.5 * (B + B.transpose(-1, -2))
    V = torch.eye(n, dtype=torch.float64, device=B.device).expand(B.shape)
    BV = torch.cat([B, V], 1)                  # [b, 2n, n]: the matrix above its vectors
    B, V = BV[:, :n], BV[:, n:]                # views: every update writes BV in place
    off_mask = ~torch.eye(n, dtype=torch.bool, device=B.device)
    active = torch.ones(B.shape[0], dtype=torch.bool, device=B.device)
    sweeps = torch.zeros(B.shape[0], dtype=torch.int32, device=B.device)
    for _ in range(SYMEIG_SWEEPS if n > 1 else 0):
        off = torch.where(off_mask, torch.abs(B), 0.0).amax((-1, -2))
        dmax = torch.abs(torch.diagonal(B, dim1=-2, dim2=-1)).amax(-1)
        active = active & ~(off <= SYMEIG_TOL * dmax)
        if B.device.type == "cpu" and not graphs.cpu_flag(active.any()):
            break  # every matrix has converged: the sweeps left rotate nothing
        sweeps = sweeps + active.to(torch.int32)
        for P, Q, PQ, diag_idx in _round_indices(n, B.device):
            h = P.shape[0]
            a = B.reshape(-1, n * n)[:, diag_idx]           # [a_pp | a_qq | a_pq]
            c, s = _rotation(a[:, :h], a[:, h:2 * h], a[:, 2 * h:], active)
            X = B[:, PQ, :]                                  # rows p then rows q
            Xp, Xq = X[:, :h], X[:, h:]
            B.index_copy_(1, PQ, torch.cat([c[..., None] * Xp - s[..., None] * Xq,
                                            s[..., None] * Xp + c[..., None] * Xq], 1))
            cc, ss = c[:, None, :], s[:, None, :]
            W = BV[:, :, PQ]                                 # columns of B and V
            Wp, Wq = W[..., :h], W[..., h:]
            BV.index_copy_(2, PQ, torch.cat([cc * Wp - ss * Wq, ss * Wp + cc * Wq], 2))
    vals, order = torch.sort(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1, stable=True)
    V = torch.gather(V, 2, order[:, None, :].expand(V.shape))
    big = torch.argmax(torch.abs(V), dim=1, keepdim=True)          # first largest per column
    V = torch.where(torch.gather(V, 1, big) < 0, -V, V)
    vals = torch.where(bad[:, None], torch.nan, vals)
    V = torch.where(bad[:, None, None], torch.nan, V)
    out = (vals.to(A.dtype).reshape(*batch, n), V.to(A.dtype).reshape(*batch, n, n))
    return out + (sweeps.reshape(batch),) if return_sweeps else out
