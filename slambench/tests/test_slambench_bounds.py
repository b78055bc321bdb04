"""The benchmark's copies of the kernels' bound functions against brute-force
counts on small instances, and ``bound_ms`` itself."""

import numpy as np
import pytest
import torch

from slambench import kernels as K
from slambench.reference import RING


def _f32(x):
    return np.float32(x)


def test_bound_ms_is_the_larger_of_bytes_and_operations():
    ms, by = K.bound_ms(3.35e12, {"f32": 1.0})
    assert by == "bytes" and ms == pytest.approx(1e3)
    ms, by = K.bound_ms(0, {"alu": K.OP_RATES["alu"]})
    assert by == "operations" and ms == pytest.approx(1e3)
    # classes on separate pipes, and all of them through the dispatch rate
    ms, _ = K.bound_ms(0, {"f32": K.FMA_PER_S, "alu": K.FMA_PER_S / 2})
    assert ms == pytest.approx(1.5e3)


def _ba_instance(rng, WF=16, wk=6, O=5, L=64, n_live=40, dup=False):
    slot = np.full((O, L), -1, np.int32)
    for p in range(n_live):
        k = rng.integers(2, O + 1)
        slot[:k, p] = rng.choice(WF, k, replace=False)
        if dup and p % 3 == 0:
            slot[1, p] = slot[0, p] = rng.choice([0, 2, 4])
    povar = (rng.random((O, L)) < 0.8).astype(np.float32) * (slot >= 0)
    return dict(slot=torch.as_tensor(slot), povar=torch.as_tensor(povar),
                posesT=torch.zeros((16, WF)), wk=wk, n_pts=torch.tensor(n_live, dtype=torch.int32))


def _brute_ba(inst):
    slot, povar, wk = inst["slot"].numpy(), inst["povar"].numpy(), inst["wk"]
    obs = wobs = ps = pairs = 0
    for p in range(int(inst["n_pts"])):
        slots = set()
        for o in range(slot.shape[0]):
            s = slot[o, p]
            obs += s >= 0
            if 0 <= s < wk and povar[o, p] > 0:
                wobs += 1
                slots.add(int(s))
        ps += len(slots)
        pairs += len(slots) ** 2
    return dict(live_points=int(inst["n_pts"]), observations=obs, window_observations=wobs,
                point_slots=ps, slot_pairs=pairs)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("kind", ["acc", "cost", "backsub"])
def test_ba_bound_matches_brute_force(kind, dup):
    inst = _ba_instance(np.random.default_rng(1), dup=dup)
    c = _brute_ba(inst)
    assert K.ba_counts(inst) == c
    O, WF, wk = inst["slot"].shape[0], inst["posesT"].shape[1], inst["wk"]
    pts, obs, wobs, ps, pairs = (c[k] for k in ("live_points", "observations",
                                                 "window_observations", "point_slots",
                                                 "slot_pairs"))
    n_bytes = {"acc": 64 * WF + pts * (12 + 4 * O) + obs * 24 + pts * 48 + ps * 72
               + 4 * (wk * 42 + (wk * 6) ** 2 + wk * 6 + 1),
               "cost": 64 * WF + pts * (12 + 4 * O) + obs * 20 + 4,
               "backsub": pts * 60 + ps * 72 + wk * 24}[kind]
    ops = {"acc": obs * 182 + wobs * 180 + ps * 72 + pairs * 108 + pts * 40,
           "cost": obs * 38, "backsub": ps * 18 + pts * 12}[kind]
    assert K.ba_bound(kind, inst) == K.bound_ms(n_bytes, {"f32": ops})


def _brute_live(a):
    L, H, W = a.shape
    live = 0
    for lv in range(L):
        for y in range(H):
            for x in range(W):
                hit = a[lv, y, x] != 0
                for dx, dy in RING:
                    hit = hit or a[lv, (y + dy) % H, (x + dx) % W] != 0
                live += bool(hit)
    return live


@pytest.mark.parametrize("case", ["zeros", "one_pixel", "corner", "random"])
def test_fast_live_pixels_and_bound(case):
    x = torch.zeros((2, 12, 15))
    if case == "one_pixel":
        x[1, 6, 7] = 9.0
    elif case == "corner":
        x[0, 0, 0] = 1.0  # its ring wraps to the other three corners
    elif case == "random":
        x = torch.as_tensor((np.random.default_rng(3).random((2, 12, 15)) < 0.05) * 7.0,
                            dtype=torch.float32)
    want = _brute_live(x.numpy())
    assert K.fast_live_pixels(x) == want
    if case in ("one_pixel", "corner"):
        assert want == 17
    assert K.fast_bound(x) == K.bound_ms(8 * x.numel(),
                                         {"alu": K.FAST_PAIR_OPS["alu"] * ((want + 1) // 2)})


def test_orb_bound_counts_per_keypoint():
    ms, by = K.orb_bound(1000)
    assert (ms, by) == K.bound_ms(1000 * (749 + 512) * 4 + 12000 + 4096 + 36000,
                                  {"f32": 1000 * (2 * 749 + 2304 + 30)})


def _epi_args(rng, M=24, N=30, dead=False):
    row_l = rng.normal(size=(M, 3)).astype(np.float32)
    a = [rng.integers(0, 2**31, (M, 8)).astype(np.int32), rng.integers(0, 2**31, (N, 8)).astype(np.int32),
         row_l, rng.random(M).astype(np.float32) * 4, rng.integers(-1, 3, M).astype(np.int32),
         rng.random(M) < (0.0 if dead else 0.8), rng.random(M) < 0.2,
         rng.normal(size=N).astype(np.float32), rng.normal(size=N).astype(np.float32),
         rng.random(N).astype(np.float32), rng.integers(-1, 3, N).astype(np.int32),
         rng.random(N) < 0.8, rng.random(N) < 0.2]
    return [torch.as_tensor(x) for x in a]


def _brute_epi(x):
    _, _, row_l, den, row_g, row_ok, row_mono, cu, cv, thr, col_g, col_ok, col_flag = (
        t.numpy() for t in x)
    M, N = len(row_ok), len(col_ok)
    allowed = np.zeros((M, N), bool)
    for i in range(M):
        for j in range(N):
            if row_ok[i] and col_ok[j]:
                num = _f32(_f32(row_l[i, 0] * cu[j]) + _f32(row_l[i, 1] * cv[j])) + row_l[i, 2]
                allowed[i, j] = (_f32(num * num) < _f32(den[i] * thr[j])
                                 and (row_g[i] == col_g[j] or row_g[i] < 0 or col_g[j] < 0)
                                 and not (row_mono[i] and col_flag[j]))
    return allowed


@pytest.mark.parametrize("dead", [False, True])
def test_epi_bound_matches_brute_force(dead):
    x = _epi_args(np.random.default_rng(5), dead=dead)
    allowed = _brute_epi(x)
    assert torch.equal(K.epi_allowed_mask(*x[2:]), torch.as_tensor(allowed))
    M, N = x[0].shape[0], x[1].shape[0]
    live_r, live_c = int(x[5].sum()), int(x[11].sum())
    rows_a, cols_a, n = int(allowed.any(1).sum()), int(allowed.any(0).sum()), int(allowed.sum())
    n_bytes = M * 9 + live_r * 21 + 32 * (rows_a + cols_a) + ((N + live_c * 17) if live_r else 0)
    ops = {"f32": 6 * live_r * live_c, "alu": 5 * live_r * live_c + 18 * n, "popc": 8 * n}
    assert K.epi_bound(x) == K.bound_ms(n_bytes, ops)
    assert (n == 0) == dead


def _top2_args(rng, M=20, N=28, chi2=False):
    a = [rng.integers(0, 2**31, (M, 8)).astype(np.int32), rng.integers(0, 2**31, (N, 8)).astype(np.int32),
         (rng.random(M) * 50).astype(np.float32), (rng.random(M) * 50).astype(np.float32),
         (rng.random(M) * 20 + 5).astype(np.float32), (rng.random(M) * 50 - 10).astype(np.float32),
         (rng.random(M) * 5).astype(np.float32), rng.integers(0, 3, M).astype(np.int32),
         rng.integers(2, 6, M).astype(np.int32), rng.random(M) < 0.8,
         (rng.random(N) * 50).astype(np.float32), (rng.random(N) * 50).astype(np.float32),
         (rng.random(N) * 50 - 10).astype(np.float32), rng.integers(0, 8, N).astype(np.int32),
         rng.random(N) < 0.8]
    isig = (rng.random(N) * 0.05).astype(np.float32) if chi2 else None
    return [torch.as_tensor(x) for x in a], None if isig is None else torch.as_tensor(isig)


def _brute_top2(x, isig, chi2):
    (r_u, r_v, r_rw, r_ur, r_rur, r_lo, r_hi, r_ok, c_u, c_v, c_ur, c_oct, c_ok) = (
        t.numpy() for t in x)
    allowed = np.zeros((len(r_ok), len(c_ok)), bool)
    for i in range(len(r_ok)):
        for j in range(len(c_ok)):
            if not (r_ok[i] and c_ok[j]):
                continue
            du, dv = _f32(c_u[j] - r_u[i]), _f32(c_v[j] - r_v[i])
            ok = abs(du) < r_rw[i] and abs(dv) < r_rw[i] and r_lo[i] <= c_oct[j] <= r_hi[i]
            if chi2:
                e2 = _f32(_f32(du * du) + _f32(dv * dv))
                dur = _f32(r_ur[i] - c_ur[j])
                if c_ur[j] >= 0:
                    ok = ok and _f32(_f32(e2 + _f32(dur * dur)) * isig[j]) <= _f32(K.CHI2_STEREO)
                else:
                    ok = ok and _f32(e2 * isig[j]) <= _f32(K.CHI2_MONO)
            else:
                ok = ok and (c_ur[j] <= 0 or abs(_f32(r_ur[i] - c_ur[j])) <= r_rur[i])
            allowed[i, j] = ok
    return allowed


@pytest.mark.parametrize("chi2", [False, True])
def test_top2_bound_matches_brute_force(chi2):
    x, isig = _top2_args(np.random.default_rng(6), chi2=chi2)
    allowed = _brute_top2(x[2:15], None if isig is None else isig.numpy(), chi2)
    assert torch.equal(K.allowed_mask(*x[2:15], isig, chi2), torch.as_tensor(allowed))
    M, N = x[0].shape[0], x[1].shape[0]
    live_r, live_c = int(x[9].sum()), int(x[14].sum())
    n = int(allowed.sum())
    rows_a, cols_a = int(allowed.any(1).sum()), int(allowed.any(0).sum())
    n_bytes = (M * 17 + live_r * 28 + (N + live_c * (20 if chi2 else 16)) * (live_r > 0)
               + 32 * (rows_a + cols_a))
    pairs = live_r * live_c
    ops = {"f32": 0, "alu": 0, "popc": 0}
    if chi2:
        stereo = int((x[14] & (x[12] >= 0)).sum())
        ops["f32"] += 6 * pairs + 3 * live_r * stereo
        ops["alu"] += 6 * pairs
    else:
        ops["f32"] += 3 * pairs
        ops["alu"] += 7 * pairs
    ops["alu"] += 19 * n
    ops["popc"] += 8 * n
    assert K.top2_bound(x, isig, chi2) == K.bound_ms(n_bytes, ops)
    assert 0 < n < live_r * live_c


def test_batched_top2_counts_a_shared_source_set_once():
    x, isig = _top2_args(np.random.default_rng(7), chi2=True)
    B = 3
    xb = [t[None].expand((B,) + t.shape).contiguous() for t in x]
    xb[0] = x[0][None].expand((B,) + x[0].shape)  # stride 0: one source set
    one = K.top2_bound(x, isig, True)
    many = K.top2_bound(xb, isig[None].expand(B, -1), True)
    assert many[0] > one[0]
    xc = list(xb)
    xc[0] = xb[0].contiguous()
    assert K.top2_bound(xc, isig[None].expand(B, -1), True)[0] >= many[0]
