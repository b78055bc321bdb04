"""The port's small symmetric eigensolver (vo_slam_test_tpu_torch/utils/
linalg.py::symeig_jacobi, the plain version of csrc/symeig.cu, through
ops/symeig_cuda.py) against numpy's ``eigh`` in f64, and the Horn alignment
built on it (solvers/ransac.py::horn_align) against the JAX package's SVD
form.

Eigensolver, f64, seeded symmetric matrices of n = 3, 4 and 12: eigenvalues
within 1e-12 of numpy's relative to the largest; each eigenvector of a simple
eigenvalue equal to numpy's up to sign (the port's sign rule: its component
of largest magnitude positive) within 1e-9 over the relative gap; where
eigenvalues repeat, the projectors onto each eigenspace equal; a rank-
deficient matrix's null space spans numpy's; a non-finite matrix gives NaN
(and the others of its batch are untouched); ascending order and
orthonormal vectors throughout.

Horn: where the cross-covariance's singular values are separated, the
rotation equals JAX's within 1e-4 (tests/test_torch_reloc_solvers.py's
HORN_TOL: both are f32 closed forms that round apart). On degenerate input,
where neither form's rotation is unique, both guarantee the same: a proper
rotation whose alignment residual is the same to rounding (collinear points,
a planar reflection), and NaN in gives NaN out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.solvers import ransac as jransac
from vo_slam_test_tpu_torch.ops import symeig_cuda
from vo_slam_test_tpu_torch.solvers import ransac
from vo_slam_test_tpu_torch.utils import linalg

HORN_TOL = 1e-4


def random_sym(rng, b, n, spectrum=None):
    Q = np.linalg.qr(rng.normal(size=(b, n, n)))[0]
    lam = rng.normal(size=(b, n)) * 10 if spectrum is None else np.broadcast_to(spectrum, (b, n))
    return np.einsum("bij,bj,bkj->bik", Q, lam, Q)


def check_against_numpy(A, vals, vecs, gap_tol=1e-6):
    want_vals, want_vecs = np.linalg.eigh(A)
    scale = np.maximum(np.abs(want_vals).max(-1, keepdims=True), 1e-300)
    np.testing.assert_array_less(np.abs(vals - want_vals) / scale, 1e-12)
    assert (np.diff(vals, axis=-1) >= 0).all()
    n = A.shape[-1]
    np.testing.assert_allclose(np.einsum("bki,bkj->bij", vecs, vecs), np.broadcast_to(
        np.eye(n), A.shape), atol=1e-12)
    for b in range(A.shape[0]):
        lam = want_vals[b]
        i = 0
        while i < n:  # eigenspaces: runs of eigenvalues within gap_tol * scale
            j = i + 1
            while j < n and lam[j] - lam[j - 1] <= gap_tol * scale[b, 0]:
                j += 1
            P_got = vecs[b, :, i:j] @ vecs[b, :, i:j].T
            P_want = want_vecs[b, :, i:j] @ want_vecs[b, :, i:j].T
            np.testing.assert_allclose(P_got, P_want, atol=1e-9 * (j - i))
            if j == i + 1:
                v = vecs[b, :, i]
                assert v[np.argmax(np.abs(v))] > 0
            i = j


@pytest.mark.parametrize("n", [3, 4, 12])
def test_random_matrices_match_numpy(n):
    rng = np.random.default_rng(n)
    A = random_sym(rng, 64, n)
    vals, vecs = linalg.symeig_jacobi(torch.as_tensor(A))
    check_against_numpy(A, vals.numpy(), vecs.numpy())


@pytest.mark.parametrize("n", [3, 4, 12])
def test_repeated_eigenvalues_compare_subspaces(n):
    rng = np.random.default_rng(10 + n)
    spectra = [np.ones(n), np.r_[np.full(n - 1, 2.0), -1.0],
               np.r_[np.zeros(n // 2), np.full(n - n // 2, 5.0)]]
    A = np.concatenate([random_sym(rng, 8, n, s) for s in spectra])
    vals, vecs = linalg.symeig_jacobi(torch.as_tensor(A))
    check_against_numpy(A, vals.numpy(), vecs.numpy())


@pytest.mark.parametrize("n,rank", [(3, 2), (4, 1), (12, 8)])
def test_rank_deficient(n, rank):
    """EPnP's minimal sample: M^T M of rank 8 (a four-dimensional null
    space, entries ~1e9)."""
    rng = np.random.default_rng(20 + n)
    X = rng.normal(size=(16, rank, n)) * 3e4
    A = np.einsum("bri,brj->bij", X, X)
    vals, vecs = (t.numpy() for t in linalg.symeig_jacobi(torch.as_tensor(A)))
    check_against_numpy(A, vals, vecs, gap_tol=1e-9)
    null = vecs[:, :, : n - rank]
    scale = np.abs(vals).max(-1)[:, None, None]
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", A, null) / scale, 0.0, atol=1e-12)


def test_non_finite_gives_nan_and_spares_the_batch():
    rng = np.random.default_rng(3)
    A = random_sym(rng, 4, 12)
    A[1, 2, 3] = np.nan
    A[2, 0, 0] = np.inf
    vals, vecs = (t.numpy() for t in linalg.symeig_jacobi(torch.as_tensor(A)))
    assert np.isnan(vals[1:3]).all() and np.isnan(vecs[1:3]).all()
    keep = [0, 3]
    check_against_numpy(A[keep], vals[keep], vecs[keep])


def test_wrapper_and_f32():
    """The wrapper runs the plain version for a CPU tensor; f32 in, f32 out
    (computed in f64), batch dims kept; only the symmetric part counts."""
    rng = np.random.default_rng(4)
    A = random_sym(rng, 6, 4).reshape(2, 3, 4, 4)
    skew = rng.normal(size=A.shape)
    skew = skew - np.swapaxes(skew, -1, -2)
    vals, vecs = symeig_cuda.symeig(torch.as_tensor(A + skew, dtype=torch.float32))
    assert vals.dtype == torch.float32 and vecs.shape == (2, 3, 4, 4)
    want = np.linalg.eigvalsh(A.astype(np.float32).astype(np.float64))
    np.testing.assert_allclose(vals.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        symeig_cuda.symeig(torch.zeros(2, 13, 13))


# ---------------------------------------------------------------------------
# Horn's alignment: the quaternion form against the JAX package's SVD form
# ---------------------------------------------------------------------------


def horn_both(src, dst, w):
    got = ransac.horn_align(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w)).numpy()
    want = np.asarray(jransac.horn_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    return got, want


def residual(T, src, dst, w):
    p = np.einsum("...ij,...nj->...ni", T[..., :3, :3], src) + T[..., None, :3, 3]
    return (w * ((p - dst) ** 2).sum(-1)).sum(-1)


def rotations(rng, b):
    R = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0]
    return R * np.sign(np.linalg.det(R))[:, None, None]


@pytest.mark.parametrize("n", [3, 10, 50])
def test_horn_matches_jax_separated_singular_values(n):
    """Random rigid motions with 1 cm noise, three points (the RANSAC
    triples) to fifty, random weights: the singular values are separated."""
    rng = np.random.default_rng(n)
    b = 128
    src = rng.normal(size=(b, n, 3)).astype(np.float32)
    R, t = rotations(rng, b), rng.normal(size=(b, 3))
    dst = (np.einsum("bij,bnj->bni", R, src) + t[:, None] + rng.normal(size=(b, n, 3)) * 0.01
           ).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (b, n)).astype(np.float32)
    H = np.einsum("bni,bnj->bij", dst - dst.mean(1, keepdims=True),
                  src - src.mean(1, keepdims=True))
    s = np.linalg.svd(H, compute_uv=False)
    keep = (np.diff(s, axis=-1) < -1e-3 * s[:, :1]).all(-1)   # separated
    assert keep.sum() > 0.9 * b
    got, want = horn_both(src, dst, w)
    np.testing.assert_allclose(got[keep], want[keep], atol=HORN_TOL)
    Rg = got[..., :3, :3].astype(np.float64)
    np.testing.assert_allclose(np.einsum("bki,bkj->bij", Rg, Rg),
                               np.broadcast_to(np.eye(3), Rg.shape), atol=1e-5)
    assert (np.linalg.det(Rg) > 0.999).all()


def test_horn_degenerate_inputs():
    """Collinear points (rank-1 cross-covariance), a mirrored planar set
    (the reflection SVD's det fix turns into a rotation), and NaN: the
    rotation need not equal JAX's, the alignment residual must, to
    rounding; both proper rotations; NaN in, NaN out."""
    rng = np.random.default_rng(7)
    line = np.outer(np.linspace(-1, 1, 6), [1.0, 2.0, 0.5]).astype(np.float32)
    plane = np.c_[rng.normal(size=(8, 2)), np.zeros(8)].astype(np.float32)
    mirror = plane * np.float32([1, -1, 1])
    src = np.stack([line, line, plane[:6]])
    dst = np.stack([line + 1.0, line @ rotations(rng, 1)[0].T.astype(np.float32),
                    mirror[:6] + 0.5])
    w = np.ones(src.shape[:2], np.float32)
    got, want = horn_both(src, dst, w)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(residual(got, src, dst, w), residual(want, src, dst, w),
                               rtol=1e-4, atol=1e-5)
    assert (np.linalg.det(got[:, :3, :3].astype(np.float64)) > 0.999).all()
    bad = src.copy()
    bad[0, 1, 2] = np.nan
    got_nan, want_nan = horn_both(bad, dst, w)
    assert np.isnan(got_nan[0, :3]).all() and np.isnan(want_nan[0, :3]).all()
    np.testing.assert_allclose(got_nan[1:], got[1:], atol=0)
