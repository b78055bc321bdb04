"""Seeded instances of the epipolar top-1 search (``masked_top1_epi``) as
numpy arrays in its argument order, descriptors as int32 bit patterns.

They hold the kernel (``csrc/epi.cu``) against its plain version and its
first design: ``chip_smoke.py``, ``perf/kernel_split.py epi`` and the tests
(``tests/test_torch_mapping_kernels.py`` against the JAX oracles on the CPU,
``tests/test_torch_kernels_gpu.py`` on the card) draw the same instances from
here. numpy only.
"""

from __future__ import annotations

import numpy as np


def descriptors(rng, M, N):
    """Random source and target descriptors; every third target repeats its
    neighbour's, so distances tie."""
    a = rng.integers(0, 2**32, size=(M, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(N, 8), dtype=np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]
    return a.view(np.int32), b.view(np.int32)


def random_epi_arrays(rng, M, N):
    """Seeded epipolar instance: each source row's line passes near a target
    keypoint, line scales span three decades, a quarter of the rows and
    targets have unknown featVec groups, a mono/epipole-flag mix, ties and 16
    empty rows."""
    a, b = descriptors(rng, M, N)
    cu = rng.uniform(0, 640, N).astype(np.float32)
    cv = rng.uniform(0, 480, N).astype(np.float32)
    c_oct = rng.integers(0, 8, N)
    pick = rng.integers(0, N, M)
    ang = rng.uniform(0, np.pi, M)
    s = 10.0 ** rng.uniform(-3, 0, M)
    lx, ly = (s * np.cos(ang)).astype(np.float32), (s * np.sin(ang)).astype(np.float32)
    lz = (-(lx * cu[pick] + ly * cv[pick]) + s * rng.normal(0, 3.0, M)).astype(np.float32)
    row_l = np.stack([lx, ly, lz], 1).astype(np.float32)
    den = (lx * lx + ly * ly).astype(np.float32)
    row_ok = rng.random(M) < 0.9
    row_ok[:16] = False
    return [
        a, b, row_l, den,
        np.where(rng.random(M) < 0.25, -1, rng.integers(0, 4, M)).astype(np.int32),
        row_ok, rng.random(M) < 0.5, cu, cv,
        (3.84 * (1.2 ** c_oct) ** 2).astype(np.float32),
        np.where(rng.random(N) < 0.25, -1, rng.integers(0, 4, N)).astype(np.int32),
        rng.random(N) < 0.95, rng.random(N) < 0.3,
    ]


# the epipolar search's edge instances: (kind, M, N) at the card's sizes
# (M = 1000 and N = 1, 33, 777 are not multiples of a warp or of a block)
EPI_EDGE_CASES = (("nonfinite", 1024, 1024), ("den_zero", 1024, 1024), ("thr_inf", 1024, 1024),
                  ("boundary", 1024, 1024), ("all_dead", 1024, 1024),
                  ("block_positions", 1024, 1024), ("ties", 1024, 1024), ("random", 1000, 1),
                  ("random", 1000, 33), ("random", 1000, 777), ("boundary", 1000, 777))
_NONFINITE = np.array([np.nan, np.inf, -np.inf], np.float32)


def _fma_f32(x, y, z):
    """f32 fma(x, y, z): the product is exact in f64, and the sum rounds once
    more to f32 (the double rounding can differ from a true fma in rare ties,
    which only weakens the selection below, never the instance)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def epi_edge_arrays(kind, M, N):
    """One edge instance of the epipolar search as numpy arrays in
    ``masked_top1_epi``'s argument order (descriptors as int32 bit patterns),
    built on ``random_epi_arrays``:

    - ``nonfinite``: NaN and +-inf in each line component, in den, in col_u,
      col_v and col_thr, and den = inf with finite lines;
    - ``den_zero``: den = 0 and -0 on live rows (nothing may pass, also not
      against thr = inf, where den * thr is NaN), some with a zero line;
    - ``thr_inf``: thr = inf, 0 and negative on a third of the columns;
    - ``boundary``: row i against column i (the same descriptor, distance 0,
      so the pair wins exactly when it is allowed) with num^2 = den * thr
      exactly in f32 (not allowed), one ulp of thr inside (allowed) and one
      outside. Half the rows take dyadic lines and integer coordinates, whose
      line value is exact in any rounding order; the other half take full
      f32 values whose line value, rounded op by op, differs from each fused
      (FMA) order and is larger in magnitude: a contracted gate lets those
      pairs through;
    - ``all_dead``: no live row;
    - ``block_positions``: one live row at each position of a 16-row block
      (row 17 p of block p);
    - ``ties``: four distinct target descriptors repeated, sources equal to
      one of them, and thr so large that most pairs pass: ties to the lowest
      column;
    - ``random``: ``random_epi_arrays`` as it is (for odd shapes)."""
    rng = np.random.default_rng([M, N, sum(map(ord, kind))])
    x = random_epi_arrays(rng, M, N)
    a, b, row_l, den, row_g, row_ok, row_mono, cu, cv, thr, col_g, col_ok, col_flag = x
    if kind == "nonfinite":
        k = 0
        for comp in range(3):
            for v in _NONFINITE:
                if 16 + k < M:
                    row_l[16 + k, comp] = v
                k += 1
        for v in _NONFINITE:
            if 16 + k < M:
                den[16 + k] = v
            k += 1
        den[16 + k:16 + k + 8] = np.inf
        row_ok[16:16 + k + 8] = True
        for arr, off in ((cu, 0), (cv, 3), (thr, 6)):
            arr[off:off + 3] = _NONFINITE[:max(0, min(3, N - off))]
        col_ok[:9] = True
    elif kind == "den_zero":
        den[16::3] = 0.0
        den[17::3] = -0.0
        row_l[16::6] = 0.0
        row_ok[16:] = True
        thr[::4] = np.inf
    elif kind == "thr_inf":
        thr[0::3] = np.inf
        thr[1::6] = 0.0
        thr[4::6] = -1.0
    elif kind == "boundary":
        n = min(M, N)
        i = np.arange(n)
        b[:n] = a[:n]
        row_ok[:n], col_ok[:n] = True, True
        row_g[:n], row_mono[:n] = -1, False
        den[:n] = np.float32(2.0) ** rng.integers(-4, 5, n)
        exact = i % 2 == 0
        # dyadic lines, integer coordinates: products and sums exact
        lx = (rng.integers(-8, 9, n) / 16.0).astype(np.float32)
        ly = (rng.integers(-8, 9, n) / 16.0).astype(np.float32)
        u = rng.integers(0, 640, n).astype(np.float32)
        v = rng.integers(0, 480, n).astype(np.float32)
        k = (rng.integers(1, 64, n) / 8.0).astype(np.float32)
        lz = (k - (lx * u + ly * v)).astype(np.float32)
        # full f32 values on the odd rows, drawn until the op-by-op line value
        # differs from both fused orders and is larger in magnitude than either
        need = np.flatnonzero(~exact)
        got = 0
        for _ in range(100):
            if got == len(need):
                break
            m = 8 * len(need)
            fx = rng.normal(0, 1, m).astype(np.float32)
            fy = rng.normal(0, 1, m).astype(np.float32)
            fu = rng.uniform(0, 640, m).astype(np.float32)
            fv = rng.uniform(0, 480, m).astype(np.float32)
            fz = (-(fx * fu + fy * fv) + rng.normal(0, 0.5, m)).astype(np.float32)
            op = np.abs((fx * fu + fy * fv) + fz)
            good = np.flatnonzero((np.abs(_fma_f32(fx, fu, fy * fv) + fz) < op)
                                  & (np.abs(_fma_f32(fy, fv, fx * fu) + fz) < op))
            good = good[:len(need) - got]
            rows = need[got:got + len(good)]
            lx[rows], ly[rows], u[rows], v[rows], lz[rows] = (
                fx[good], fy[good], fu[good], fv[good], fz[good])
            got += len(good)
        assert got == len(need), "too few contraction-sensitive pairs drawn"
        row_l[:n] = np.stack([lx, ly, lz], 1)
        cu[:n], cv[:n] = u, v
        num = (lx * u + ly * v) + lz  # numpy rounds op by op
        on = ((num * num) / den[:n]).astype(np.float32)  # exact: den is a power of two
        side = i % 3  # 0 on the boundary, 1 one ulp inside, 2 one ulp outside
        thr[:n] = np.where(side == 0, on, np.where(side == 1, np.nextafter(on, np.inf),
                                                   np.nextafter(on, -np.inf)))
        assert np.array_equal((num * num)[side == 0], (den[:n] * thr[:n])[side == 0])
    elif kind == "all_dead":
        row_ok[:] = False
    elif kind == "block_positions":
        row_ok[:] = False
        pos = 17 * np.arange(16)
        row_ok[pos[pos < M]] = True
    elif kind == "ties":
        b[:] = b[np.arange(N) % 4]
        a[:] = b[rng.integers(0, min(N, 4), M)]
        thr[:] = 1e30
    elif kind != "random":
        raise ValueError(kind)
    return x


def epi_contraction_rows(M, N):
    """The ``boundary`` instance's rows whose pair a contracted (FMA) line
    value lets through where the op-by-op value does not: the full-f32 rows
    (odd) on the boundary or one ulp outside it."""
    i = np.arange(min(M, N))
    return i[(i % 2 == 1) & (i % 3 != 1)]
