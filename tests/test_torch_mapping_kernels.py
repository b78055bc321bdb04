"""The plain versions of the mapping path's kernels against the JAX package:
the chi2 mode of the masked top-2 (fuse into a keyframe), the
neighbour-batched top-2 (fuse into the neighbours) and the epipolar top-1
(triangulation), each against the XLA oracle and the Pallas kernel in
interpret mode, as tests/test_match_pallas.py runs them.

Tolerance: none. The gates are the oracles' f32 expressions in the same
order and the outputs are integers, so every output must be equal, ties
(duplicated target descriptors) and empty rows included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.ops import match_pallas as jmp
from vo_slam_test_tpu_torch.ops import epi_instances, match_cuda, match_pallas

NAMES = ("best_i", "best_d", "second_i", "second_d")


def chi2_instance(seed, M, N):
    """numpy arrays in the JAX argument order plus col_isig2: rows projected
    within a few pixels of a target so the chi2 bound decides many pairs, a
    stereo/mono mix of targets, duplicated target descriptors (ties) and 16
    rows with nothing allowed."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(M, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(N, 8), dtype=np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]
    a[5] = b[7]
    cu = rng.uniform(0, 640, N).astype(np.float32)
    cv = rng.uniform(0, 480, N).astype(np.float32)
    c_oct = rng.integers(0, 8, N).astype(np.int32)
    cur = np.where(rng.random(N) < 0.5, -1.0, cu - rng.uniform(5, 60, N)).astype(np.float32)
    pick = rng.integers(0, N, M)
    ru = (cu[pick] + rng.normal(0, 2.0, M)).astype(np.float32)
    rv = (cv[pick] + rng.normal(0, 2.0, M)).astype(np.float32)
    rur = np.where(cur[pick] >= 0, cur[pick] + rng.normal(0, 2.0, M),
                   ru - rng.uniform(5, 60, M)).astype(np.float32)
    pred = (c_oct[pick] + rng.integers(0, 2, M)).astype(np.int32)
    row_ok = rng.random(M) < 0.9
    row_ok[:16] = False
    return [a, b, ru, rv, (3.0 * 1.2 ** pred).astype(np.float32), rur, np.zeros(M, np.float32),
            pred - 1, pred, row_ok, cu, cv, cur, c_oct, rng.random(N) < 0.95,
            (1.0 / (1.2 ** c_oct) ** 2).astype(np.float32)]


def epi_instance(seed, M, N):
    """numpy arrays in the JAX argument order: lines through target
    keypoints over three decades of scale, unknown groups, a mono/flag mix,
    ties and 16 empty rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(M, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(N, 8), dtype=np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]
    cu = rng.uniform(0, 640, N).astype(np.float32)
    cv = rng.uniform(0, 480, N).astype(np.float32)
    c_oct = rng.integers(0, 8, N)
    pick = rng.integers(0, N, M)
    ang = rng.uniform(0, np.pi, M)
    s = 10.0 ** rng.uniform(-3, 0, M)
    lx, ly = (s * np.cos(ang)).astype(np.float32), (s * np.sin(ang)).astype(np.float32)
    lz = (-(lx * cu[pick] + ly * cv[pick]) + s * rng.normal(0, 3.0, M)).astype(np.float32)
    row_ok = rng.random(M) < 0.9
    row_ok[:16] = False
    return [a, b, np.stack([lx, ly, lz], 1).astype(np.float32), (lx * lx + ly * ly).astype(np.float32),
            np.where(rng.random(M) < 0.25, -1, rng.integers(0, 4, M)).astype(np.int32),
            row_ok, rng.random(M) < 0.5, cu, cv, (3.84 * (1.2 ** c_oct) ** 2).astype(np.float32),
            np.where(rng.random(N) < 0.25, -1, rng.integers(0, 4, N)).astype(np.int32),
            rng.random(N) < 0.95, rng.random(N) < 0.3]


def to_port(args):
    """Descriptors become int32 bit patterns; everything else as is."""
    return [torch.as_tensor(np.ascontiguousarray(x).view(np.int32)) if x.dtype == np.uint32
            else torch.as_tensor(np.array(x)) for x in args]


def to_jax(args):
    return [jnp.asarray(x) for x in args]


def assert_equal(port_out, jax_out, label):
    for p, j, name in zip(port_out, jax_out, NAMES):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=f"{label}: {name}")


@pytest.mark.parametrize("seed,M,N", [(0, 256, 128), (1, 4096, 1024)])
def test_chi2_plain_matches_jax(seed, M, N):
    args = chi2_instance(seed, M, N)
    p = to_port(args)
    got = match_pallas.masked_top2_plain(*p[:15], col_isig2=p[15], chi2_gate=True)
    assert (got[1] < match_pallas.BIG).sum() > M // 4   # the gate decides many pairs
    assert (got[1][:16] == match_pallas.BIG).all()
    j = to_jax(args)
    assert_equal(got, jmp.masked_top2_xla(*j[:15], col_isig2=j[15], chi2_gate=True), "xla")
    assert_equal(got, jmp.masked_top2_pallas(*j[:15], col_isig2=j[15], chi2_gate=True,
                                             interpret=True), "pallas")
    # the wrapper routes CPU tensors to the plain version
    assert_equal(match_cuda.masked_top2(*p[:15], col_isig2=p[15], chi2_gate=True),
                 [x.numpy() for x in got], "wrapper")


def test_chi2_gate_boundary():
    """Pairs placed on the 5.991 / 7.815 bounds (err * isig2 within a few
    ulps of the bound, on either side) are decided as the oracle decides
    them."""
    M, N = 128, 128
    args = chi2_instance(3, M, N)
    args[9][:] = True
    args[14][:] = True
    args[4][:] = 1e6               # no window limit
    args[7][:], args[8][:] = -1, 8  # every octave
    args[13][:] = 0
    args[15][:] = 1.0
    args[12][:] = np.where(np.arange(N) % 2 == 0, -1.0, 100.0).astype(np.float32)
    # row i sits at distance sqrt(bound) from column i along u
    for i in range(M):
        bound = np.float32(5.991) if args[12][i] < 0 else np.float32(7.815)
        args[10][i] = np.float32(50.0)
        args[11][i] = np.float32(60.0)
        args[2][i] = np.float32(50.0)
        args[3][i] = np.float32(60.0) + np.sqrt(bound).astype(np.float32) * (1 + (i % 3 - 1) * 1e-6)
        args[5][i] = np.float32(100.0)
    p = to_port(args)
    got = match_pallas.masked_top2_plain(*p[:15], col_isig2=p[15], chi2_gate=True)
    j = to_jax(args)
    assert_equal(got, jmp.masked_top2_xla(*j[:15], col_isig2=j[15], chi2_gate=True), "xla")


@pytest.mark.parametrize("seed,B,M,N", [(4, 4, 256, 128), (5, 16, 1024, 1024)])
def test_nb_plain_matches_jax(seed, B, M, N):
    per = [chi2_instance(seed * 100 + i, M, N) for i in range(B)]
    if B == 16:
        for inst in per:  # the fuse call site: one shared source set
            inst[0] = per[0][0]
    stacked = [np.stack([inst[k] for inst in per]) for k in range(16)]
    p = to_port(stacked)
    if B == 16:
        p[0] = p[0][0][None].expand(B, M, 8)
    got = match_pallas.masked_top2_nb_plain(*p[:15], col_isig2=p[15], chi2_gate=True)
    assert all(g.shape == (B, M) for g in got)
    j = to_jax(stacked)
    assert_equal(got, jmp.masked_top2_nb(*j[:15], col_isig2=j[15], chi2_gate=True), "xla vmap")
    if B == 4:
        assert_equal(got, jmp.masked_top2_nb_pallas(*j[:15], col_isig2=j[15], chi2_gate=True,
                                                    interpret=True), "pallas")
    else:  # the production shape: one mid-batch neighbour against the kernel
        b = 9
        want = jmp.masked_top2_pallas(*[x[b] for x in j[:15]], col_isig2=j[15][b],
                                      chi2_gate=True, interpret=True)
        assert_equal([g[b] for g in got], want, "pallas b=9")
    assert_equal(match_cuda.masked_top2_nb(*p[:15], col_isig2=p[15], chi2_gate=True),
                 [x.numpy() for x in got], "wrapper")


@pytest.mark.parametrize("seed,M,N", [(6, 128, 128), (7, 1024, 1024)])
def test_epi_plain_matches_jax(seed, M, N):
    args = epi_instance(seed, M, N)
    p = to_port(args)
    got = match_pallas.masked_top1_epi_plain(*p)
    assert (got[1] < match_pallas.BIG).sum() > M // 4
    assert (got[1][:16] == match_pallas.BIG).all() and (got[0][:16] == 0).all()
    j = to_jax(args)
    assert_equal(got, jmp.masked_top1_epi_xla(*j), "xla")
    assert_equal(got, jmp.masked_top1_epi_pallas(*j, interpret=True), "pallas")
    assert_equal(match_cuda.masked_top1_epi(*p), [x.numpy() for x in got], "wrapper")


def test_epi_ties_go_to_lowest_column():
    """Identical descriptors and a line through every target: the lowest
    allowed column wins, as the oracle's argmin does."""
    M = N = 128
    args = epi_instance(8, M, N)
    args[0][:] = 0
    args[1][:] = 0
    args[2][:] = np.array([0.0, 0.0, 0.0], np.float32)  # den 0: nothing passes ...
    args[3][:] = 0.0
    args[9][:] = 1.0
    p = to_port(args)
    got = match_pallas.masked_top1_epi_plain(*p)
    assert (got[1] == match_pallas.BIG).all()            # ... num^2 < 0 never holds
    args[2][:] = np.array([0.0, 1.0, -240.0], np.float32)  # the line v = 240
    args[3][:] = 1.0
    args[8][:] = 240.0
    args[4][:] = -1
    args[6][:] = False
    p = to_port(args)
    got = match_pallas.masked_top1_epi_plain(*p)
    want = jmp.masked_top1_epi_xla(*to_jax(args))
    assert_equal(got, want, "xla")
    first_ok = int(np.argmax(args[11]))
    assert (got[0][args[5]] == first_ok).all()


# epi_instances.EPI_EDGE_CASES' kinds at sizes up to 256 (N = 1, 33 and 177 are
# not multiples of a warp or of a block)
EPI_EDGE_CPU = [("nonfinite", 256, 128), ("den_zero", 128, 128), ("thr_inf", 128, 128),
                ("boundary", 256, 256), ("all_dead", 128, 128), ("block_positions", 256, 128),
                ("ties", 128, 128), ("random", 200, 1), ("random", 200, 33), ("random", 250, 177),
                ("boundary", 250, 177)]


def _pad_rows_cols(args, M, N):
    """The Pallas kernel takes M and N in multiples of 128: dead rows
    (row_ok False) and columns that no pair may use (col_ok False) fill the
    rest, which leaves the first M rows' answers as they are."""
    Mp, Np = -(-M // 128) * 128, -(-N // 128) * 128
    return [np.pad(x, [(0, (Mp if k < 7 else Np) - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
            for k, x in enumerate(args)]


@pytest.mark.parametrize("kind,M,N", EPI_EDGE_CPU)
def test_epi_plain_matches_jax_on_edges(kind, M, N):
    """The epipolar search's edge instances (``epi_instances.epi_edge_arrays``):
    the plain version equals ``masked_top1_epi_xla`` on every row and
    ``masked_top1_epi_pallas`` in interpret mode on every row but one set.
    On the CPU the interpret path contracts the line value into an FMA, so on
    the boundary rows chosen to be moved by a contraction
    (``epi_instances.epi_contraction_rows``) it may let the pair through (the
    pair's distance is 0, so it wins): there it gives the plain answer or
    that pair, nothing else."""
    x = epi_instances.epi_edge_arrays(kind, M, N)
    got = [g.numpy() for g in match_pallas.masked_top1_epi_plain(*to_port(x))]
    as_u32 = lambda a: [v.view(np.uint32) if k < 2 else v for k, v in enumerate(a)]  # noqa: E731
    assert_equal([torch.as_tensor(g) for g in got], jmp.masked_top1_epi_xla(*to_jax(as_u32(x))),
                 "xla")
    pal = [np.asarray(p)[:M] for p in jmp.masked_top1_epi_pallas(
        *to_jax(as_u32(_pad_rows_cols(x, M, N))), interpret=True)]
    fused = epi_instances.epi_contraction_rows(M, N) if kind == "boundary" else np.array([], int)
    rest = np.setdiff1d(np.arange(M), fused)
    for p, g, name in zip(pal, got, NAMES):
        np.testing.assert_array_equal(p[rest], g[rest], err_msg=f"pallas: {name}")
    same = (pal[0][fused] == got[0][fused]) & (pal[1][fused] == got[1][fused])
    assert (same | ((pal[0][fused] == fused) & (pal[1][fused] == 0))).all()
    if kind == "boundary":  # the instance holds what it claims: only the inside pairs pass
        i = np.arange(min(M, N))
        wins = (got[0][i] == i) & (got[1][i] == 0)
        assert (wins == (i % 3 == 1)).all()
    if kind == "all_dead":
        assert (got[1] == match_pallas.BIG).all() and (got[0] == 0).all()
    if kind == "block_positions":
        assert (got[1][np.setdiff1d(np.arange(M), 17 * np.arange(16))] == match_pallas.BIG).all()


def test_wrappers_refuse_other_devices():
    p = to_port(epi_instance(9, 16, 16))
    meta = [x.to("meta") for x in p]
    with pytest.raises(ValueError, match="unsupported device"):
        match_cuda.masked_top1_epi(*meta)
    q = to_port(chi2_instance(9, 16, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        match_cuda.masked_top2(*[x.to("meta") for x in q[:15]], col_isig2=q[15].to("meta"),
                               chi2_gate=True)
