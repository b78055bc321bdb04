"""The bounds that ``chip_smoke.py`` prints beside the kernels' times, checked
on the CPU: the counts they are made of against brute-force numpy counts on
small instances, and ``bound_ms`` itself. Importing ``chip_smoke`` needs no
card and no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.ops.fast import CIRCLE16
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _dup_slots(rng, WF, wk, O, L, n_live):
    """Observer slots where every third point is seen twice by one window
    slot."""
    slot = np.full((O, L), -1, np.int32)
    for p in range(n_live):
        k = rng.integers(2, O + 1)
        slot[:k, p] = rng.choice(WF, k, replace=False)
        if p % 3 == 0:
            slot[1, p] = slot[0, p] = rng.choice([0, 2, 4])
    return slot


def _instance(kind, seed=0):
    rng = np.random.default_rng(seed)
    WF, wk, O, L, n_live = 16, 6, 5, 64, 40
    slot = _dup_slots(rng, WF, wk, O, L, n_live) if kind == "dup" else None
    return chip_smoke.random_ba_instance(rng, WF, wk, O, L, n_live, "cpu", slot=slot)


def _brute_counts(inst):
    slot, povar, wk = inst["slot"].numpy(), inst["povar"].numpy(), inst["wk"]
    n = int(inst["n_pts"])
    obs = wobs = ps = pairs = 0
    for p in range(n):
        slots = set()
        for o in range(slot.shape[0]):
            s = slot[o, p]
            obs += s >= 0
            if 0 <= s < wk and povar[o, p] > 0:
                wobs += 1
                slots.add(int(s))
        ps += len(slots)
        pairs += len(slots) ** 2
    return dict(live_points=n, observations=obs, window_observations=wobs, point_slots=ps,
                slot_pairs=pairs)


@pytest.mark.parametrize("kind", ["distinct", "dup"])
def test_ba_counts_match_brute_force(kind):
    inst = _instance(kind)
    want = _brute_counts(inst)
    assert chip_smoke.ba_counts(inst) == want
    assert want["observations"] > want["window_observations"] > 0
    # two observations of one point by one slot are one (point, slot)
    assert (want["window_observations"] > want["point_slots"]) == (kind == "dup")


@pytest.mark.parametrize("kind", ["acc", "cost", "backsub"])
def test_ba_bound_follows_the_counts(kind):
    inst = _instance("dup", seed=1)
    ms, by, counts = chip_smoke.ba_bound(kind, inst)
    c = _brute_counts(inst)
    assert counts == c
    O, WF, wk = inst["slot"].shape[0], inst["posesT"].shape[1], inst["wk"]
    pts, obs, wobs, ps, pairs = (c[k] for k in ("live_points", "observations",
                                                 "window_observations", "point_slots",
                                                 "slot_pairs"))
    # bytes: inputs of live points read once, outputs written once
    n_bytes = {
        "acc": 64 * WF + pts * (12 + 4 * O) + obs * 24 + pts * 48 + ps * 72
        + 4 * (wk * 42 + (wk * 6) ** 2 + wk * 6 + 1),
        "cost": 64 * WF + pts * (12 + 4 * O) + obs * 20 + 4,
        "backsub": pts * 60 + ps * 72 + wk * 24,
    }[kind]
    ops = {"acc": obs * 182 + wobs * 180 + ps * 72 + pairs * 108 + pts * 40,
           "cost": obs * 38, "backsub": ps * 18 + pts * 12}[kind]
    want_ms, want_by = chip_smoke.bound_ms(n_bytes, {"f32": ops})
    assert (ms, by) == (want_ms, want_by)
    assert ms == max(n_bytes / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.FMA_PER_S) * 1e3


def test_ba_bound_grows_with_the_live_work():
    small = chip_smoke.random_ba_instance(np.random.default_rng(2), 16, 6, 5, 64, 10, "cpu")
    large = chip_smoke.random_ba_instance(np.random.default_rng(2), 16, 6, 5, 64, 60, "cpu")
    for kind in ("acc", "cost", "backsub"):
        assert chip_smoke.ba_bound(kind, small)[0] < chip_smoke.ba_bound(kind, large)[0]


def _brute_live_pixels(levels):
    a = levels.numpy()
    L, H, W = a.shape
    live = 0
    for lv in range(L):
        for y in range(H):
            for x in range(W):
                hit = a[lv, y, x] != 0
                for dx, dy in CIRCLE16:
                    hit = hit or a[lv, (y + dy) % H, (x + dx) % W] != 0
                live += bool(hit)
    return live


def test_fast_live_pixels_on_a_small_pyramid():
    spec = PyramidSpec(80, 60, 4, 1.2)
    gray = np.random.default_rng(0).integers(1, 256, (60, 80)).astype(np.uint8)
    levels = interior(build_pyramid(torch.as_tensor(gray), spec).raw, spec)
    want = _brute_live_pixels(levels)
    assert chip_smoke.fast_live_pixels(levels) == want
    # every level pixel is live, and so is a fringe around the smaller levels
    n_level = sum(h * w for h, w in spec.sizes)
    assert n_level <= want < levels.numel()
    ms, by, counts = chip_smoke.fast_bound(levels)
    assert counts == dict(pixels=levels.numel(), live_pixels=want)
    assert (ms, by) == chip_smoke.bound_ms(
        8 * levels.numel(), {"alu": chip_smoke.FAST_PAIR_OPS["alu"] * ((want + 1) // 2)})


@pytest.mark.parametrize("case", ["zeros", "one_pixel", "corner"])
def test_fast_live_pixels_edge_cases(case):
    x = torch.zeros((2, 12, 15))
    if case == "one_pixel":
        x[1, 6, 7] = 9.0
    elif case == "corner":
        x[0, 0, 0] = 1.0  # its ring wraps to the other three corners
    assert chip_smoke.fast_live_pixels(x) == _brute_live_pixels(x) == (0 if case == "zeros" else 17)


def test_level_pixels_of_the_main_path():
    """640x480, 8 levels at 1.2: the levels hold 950,532 of the batch's
    2,457,600 pixels."""
    spec = PyramidSpec(640, 480, 8, 1.2)
    assert sum(h * w for h, w in spec.sizes) == 950_532
    assert spec.n_levels * spec.height * spec.width == 2_457_600


def _f32(x):
    return np.float32(x)


def _brute_epi_allowed(x):
    """The epipolar gates pair by pair in f32, rounded op by op."""
    _, _, row_l, den, row_g, row_ok, row_mono, cu, cv, thr, col_g, col_ok, col_flag = (
        t.numpy() for t in x)
    M, N = len(row_ok), len(col_ok)
    allowed = np.zeros((M, N), bool)
    with np.errstate(all="ignore"):
        for i in range(M):
            for j in range(N):
                if not (row_ok[i] and col_ok[j]):
                    continue
                num = _f32(_f32(row_l[i, 0] * cu[j]) + _f32(row_l[i, 1] * cv[j])) + row_l[i, 2]
                allowed[i, j] = (_f32(num * num) < _f32(den[i] * thr[j])
                                 and (row_g[i] == col_g[j] or row_g[i] < 0 or col_g[j] < 0)
                                 and not (row_mono[i] and col_flag[j]))
    return allowed


def _epi_args(kind):
    from vo_slam_test_tpu_torch.ops import epi_instances

    if kind in ("random", "dead"):
        x = epi_instances.random_epi_arrays(np.random.default_rng(5), 40, 48)
        if kind == "dead":
            x[5][:] = False
    else:
        x = epi_instances.epi_edge_arrays(kind, 48, 40)
    return chip_smoke._tensors(x, "cpu")


@pytest.mark.parametrize("kind", ["random", "dead", "nonfinite", "ties", "block_positions"])
def test_epi_bound_matches_brute_force(kind):
    """Bytes: row_ok and the outputs for every row, a live row's line, den,
    group and mono flag, col_ok and a live column's gate fields only when
    the launch has a live row, and a descriptor only for a row or column
    with an allowed pair."""
    x = _epi_args(kind)
    allowed = _brute_epi_allowed(x)
    M, N = x[0].shape[0], x[1].shape[0]
    live_r, live_c = int(x[5].sum()), int(x[11].sum())
    rows_a, cols_a, n_allowed = int(allowed.any(1).sum()), int(allowed.any(0).sum()), int(allowed.sum())
    n_bytes = M * (1 + 8) + live_r * (12 + 4 + 4 + 1) + 32 * (rows_a + cols_a)
    if live_r:
        n_bytes += N + live_c * (4 + 4 + 4 + 4 + 1)
    ops = {"f32": 6 * live_r * live_c, "alu": 5 * live_r * live_c + 18 * n_allowed,
           "popc": 8 * n_allowed}
    ms, by, counts = chip_smoke.epi_bound(x)
    assert counts == dict(live_rows=live_r, live_cols=live_c, live_pairs=live_r * live_c,
                          allowed_pairs=n_allowed, rows_with_allowed=rows_a,
                          cols_with_allowed=cols_a)
    assert (ms, by) == chip_smoke.bound_ms(n_bytes, ops)
    if kind == "dead":
        assert n_bytes == M * 9 and n_allowed == 0
    else:
        assert 0 < rows_a <= live_r and 0 < cols_a <= live_c


def _brute_top2_allowed(x, isig, chi2):
    """The top-2 gates of one search pair by pair in f32."""
    from vo_slam_test_tpu_torch.ops import match_pallas

    (r_u, r_v, r_rw, r_ur, r_rur, r_lo, r_hi, r_ok, c_u, c_v, c_ur, c_oct, c_ok) = (
        t.numpy() for t in x)
    M, N = len(r_ok), len(c_ok)
    allowed = np.zeros((M, N), bool)
    for i in range(M):
        for j in range(N):
            if not (r_ok[i] and c_ok[j]):
                continue
            du, dv = _f32(c_u[j] - r_u[i]), _f32(c_v[j] - r_v[i])
            ok = abs(du) < r_rw[i] and abs(dv) < r_rw[i] and r_lo[i] <= c_oct[j] <= r_hi[i]
            if chi2:
                e2 = _f32(_f32(du * du) + _f32(dv * dv))
                dur = _f32(r_ur[i] - c_ur[j])
                if c_ur[j] >= 0:
                    ok = ok and _f32(_f32(e2 + _f32(dur * dur)) * isig[j]) <= _f32(
                        match_pallas.CHI2_STEREO)
                else:
                    ok = ok and _f32(e2 * isig[j]) <= _f32(match_pallas.CHI2_MONO)
            else:
                ok = ok and (c_ur[j] <= 0 or abs(_f32(r_ur[i] - c_ur[j])) <= r_rur[i])
            allowed[i, j] = ok
    return allowed


@pytest.mark.parametrize("site", ["window", "chi2", "batched", "dead"])
def test_top2_bound_matches_brute_force(site):
    """As the epipolar bound: a search's column fields only when it has a
    live row, descriptors only for rows and columns with an allowed pair, a
    source set shared by the batched searches (stride 0) once."""
    rng = np.random.default_rng(6)
    isig = None
    if site in ("window", "dead"):
        args = chip_smoke.random_top2_instance(rng, 24, 40, "cpu")
        if site == "dead":
            args[9][:] = False
    elif site == "chi2":
        full = chip_smoke.random_chi2_instance(rng, 24, 40, "cpu")
        args, isig = full[:15], full[15]
    else:
        full = chip_smoke.random_nb_instance(rng, 3, 24, 40, "cpu")
        args, isig = full[:15], full[15]
    chi2 = isig is not None
    batched = site == "batched"
    x = [t if batched else t[None] for t in args]
    iv = None if isig is None else (isig if batched else isig[None])
    B, M, N = x[0].shape[0], x[0].shape[1], x[1].shape[1]
    masks = np.stack([_brute_top2_allowed([t[b] for t in x[2:15]],
                                          None if iv is None else iv[b].numpy(), chi2)
                      for b in range(B)])
    n_bytes, pairs, stereo_pairs = B * M * 17, 0, 0
    for b in range(B):
        live_r, live_c = int(x[9][b].sum()), int(x[14][b].sum())
        n_bytes += live_r * 28 + ((N + live_c * (20 if chi2 else 16)) if live_r else 0)
        pairs += live_r * live_c
        stereo_pairs += live_r * int((x[14][b] & (x[12][b] >= 0)).sum())
    src_rows = int(masks.any(2).any(0).sum()) if batched else int(masks.any(2).sum())
    n_bytes += 32 * (src_rows + int(masks.any(1).sum()))
    n_allowed = int(masks.sum())
    if chi2:
        ops = {"f32": 6 * pairs + 3 * stereo_pairs, "alu": 6 * pairs + 19 * n_allowed}
    else:
        ops = {"f32": 3 * pairs, "alu": 7 * pairs + 19 * n_allowed}
    ops["popc"] = 8 * n_allowed
    ms, by, counts = chip_smoke.top2_bound(args, isig, chi2)
    assert counts["allowed_pairs"] == n_allowed and counts["live_pairs"] == pairs
    assert counts["rows_with_allowed"] == src_rows
    assert (ms, by) == chip_smoke.bound_ms(n_bytes, ops)
    if site == "dead":
        assert n_allowed == 0 and n_bytes == B * M * 17
    else:
        assert n_allowed > 0


@pytest.mark.parametrize("n_bytes,ops,by", [
    (3.35e9, {"f32": 1.0}, "bytes"),                      # 1 ms of bytes
    (8.0, {"f32": 33.5e9}, "operations"),                 # 1 ms of f32
    (8.0, {"alu": 16.75e9}, "operations"),                # 1 ms on the integer pipe
    (8.0, {"popc": 4.1875e9}, "operations"),              # 1 ms of popc
    (8.0, {"f32": 20e9, "alu": 13.5e9}, "operations"),    # 1 ms of dispatch
])
def test_bound_ms_is_the_larger_term_and_names_it(n_bytes, ops, by):
    ms, got_by = chip_smoke.bound_ms(n_bytes, ops)
    t_bytes = n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = max([n / chip_smoke.OP_RATES[k] for k, n in ops.items()]
                + [sum(ops.values()) / chip_smoke.DISPATCH_PER_S]) * 1e3
    assert got_by == by
    assert ms == pytest.approx(1.0, rel=1e-12) and ms == max(t_bytes, t_ops)


def test_chip_smoke_imports_without_a_card_or_jax():
    code = ("import sys; import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'vo_slam_test_tpu')]; assert not bad, bad; "
            "sys.exit(0 if chip_smoke.main() == 1 or __import__('torch').cuda.is_available() "
            "else 2)")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
