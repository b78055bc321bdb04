#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vo_slam_test_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card and its power limit;
2. builds the CUDA kernels from ``vo_slam_test_tpu_torch/csrc`` with nvcc
   (sm_90a, one nvcc per source, all started together) and times the launch
   floor: an empty kernel, and two in a row (``launch_floor_ms``);
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times both with CUDA events:
   - FAST on a frame's [8,480,640] pyramid, IC angle + rBRIEF on its 1024
     keypoints, Hamming top-2 at 1024x1024 on a real frame pair and on a
     seeded instance with ties and empty rows;
   - top-2 at 4096x1024 (the local-map search), chi2 top-2 at 4096x1024
     (fuse into a keyframe), neighbour-batched chi2 top-2 at 16x1024x1024
     (fuse into the neighbours) and the epipolar top-1 at 1024x1024
     (triangulation), each on an instance captured from the SlamSystem path
     and on a seeded instance with ties, empty rows and a stereo/mono mix.
     Every output must be equal. IC angle + rBRIEF, the four top-2 sites and
     the epipolar top-1 are also held bit for bit against their first designs
     (``perf/orb_v1.cu``, ``perf/match_v1.cu``, ``perf/epi_v1.cu``), which
     are timed beside them (``v1_ms``); the epipolar top-1 also on seeded edge
     instances (``EPI_EDGE_CASES``: non-finite lines, den = 0, thr = inf,
     pairs on the gate's boundary, no live row, one live row at each position
     of a block, ties, odd N);
   - the local-BA kernels (LM accumulate + Schur reduction, robust cost,
     point back-substitution) on the first LM iteration of a captured local
     BA and on a seeded full-width instance (a stereo/mono mix, outliers past
     the Huber threshold, empty slots), within the tolerances of
     ``check_ba``, two launches bit-equal, the accumulate kernel's cost
     bit-equal to the cost kernel's and its window mask words equal to the
     plain ``window_mask``; the accumulate kernel is timed with the buffers
     the solver carries over a BA call's iterations (its ``Wc`` zeroed once),
     after two calls on them are checked bit for bit against the call on
     fresh buffers, and once with a fresh ``Wc`` as earlier runs timed it;
4. main path 1: the port's FusedTracker over the synthetic corner sequence
   (30 frames, 1000 features, 8 levels: the fr1 extraction settings, as
   ``run_slam --synthetic`` uses): 30/30 tracked frames, ATE < 1 cm, every
   kernel of the path launched;
5. main path 2: the port's SlamSystem (tracking against the local map, the
   keyframe policy and the local-mapping chain with local BA on every
   keyframe event) over the first 40 frames of the 240-frame room orbit at
   640x480 with the default MapCaps: 40/40 tracked frames, >= 5 keyframe
   events, ATE < 1 cm, the chi2 and neighbour-batched kernels launched once
   per keyframe event, the epipolar kernel once per neighbour past the
   baseline gate, each BA kernel once per LM iteration the solver reports,
   and a second run giving identical map tensors;
6. main path 3: the same frames through ``SlamSystem(chunk=8)``: the same
   checks, with local BA skipped (and no BA launch) on the events a later
   keyframe of the same chunk overtakes;
7. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line. Every bound is computed from this run's inputs and counts the work
   the function needs, whatever computes it; a kernel timed under its bound
   fails the run (the bound is then wrong). No plain version may see a CUDA
   tensor on any main path. Any
   failed check raises: the exit code is then non-zero and no result line is
   printed. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from vo_slam_test_tpu_torch.ops.epi_instances import (EPI_EDGE_CASES, epi_edge_arrays,
                                                      random_epi_arrays)
from vo_slam_test_tpu_torch.ops.epi_instances import descriptors as _descriptors

# published H100 SXM peaks (dense): HBM bandwidth and the f32 rate, an FMA
# counted as two operations
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# instruction rates by class, from the f32 rate and compute capability 9.0's
# per-SM throughput table (CUDA C++ Programming Guide, "Arithmetic
# Instructions"): 128 lanes per SM per clock for f32 add/mul/FMA, 64 for
# 32-bit integer add, compare/min/max (f32 too) and logic, 16 for popc; four
# schedulers issue at most 128 lanes' instructions per SM per clock in all
FMA_PER_S = F32_FLOPS / 2
OP_RATES = {"f32": FMA_PER_S, "alu": FMA_PER_S / 2, "popc": FMA_PER_S / 8}
DISPATCH_PER_S = FMA_PER_S
TOP2_OUTS = ("best_i", "best_d", "second_i", "second_d")
SLICE_FRAMES = 40
CHUNK = 8
# the JAX package's SlamSystem with local BA on over the same 40 frames, on
# the CPU (tools/room_orbit_reference.py --impl jax): printed beside main path
# 2's result, not a gate
JAX_CPU_KF_FRAMES = [0, 1, 5, 12, 21, 22, 30, 39]
JAX_CPU_ATE_CM = 0.7782
# main path 2 with the first design of ba_accumulate (perf/ba_v1.cu, whose sums
# were plain f32 in another order; perf/ba_order_probe.py reproduces the run):
# printed beside this run's, not a gate
FIRST_DESIGN_ATE_CM = 0.7483
FIRST_DESIGN_BA_ITERS = [(0, 5, 10), (1, 5, 6), (5, 5, 10), (12, 5, 10), (21, 5, 10), (22, 5, 1),
                         (30, 5, 1), (39, 5, 10)]


def bound_ms(n_bytes: float, ops: dict):
    """Least time for the work: the larger of bytes over the memory rate and
    the operations' time. ``ops`` counts instructions by class (OP_RATES);
    the classes run on separate pipes, so their time is the largest of each
    class over its rate and of all of them over the dispatch rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max([n / OP_RATES[k] for k, n in ops.items()]
                + [sum(ops.values()) / DISPATCH_PER_S])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_graph_ms(fn, n_per_graph=20, reps=5) -> float:
    """Device time of one call of ``fn``: ``n_per_graph`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (no host launch
    gaps in the measurement)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n_per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_per_graph)


def time_eager_ms(fn, iters=10) -> float:
    """Time of one eager call of ``fn`` between CUDA events, launches
    included (used for the plain versions, which are many small ops)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_times_ms(fn, reps=5) -> dict:
    """Device ms per call of ``fn`` by kernel name, from the CUDA kernel events
    of a ``torch.profiler`` window over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name[:40]] = per.get(e.name[:40], 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return {k: round(v, 4) for k, v in per.items()}


def fast_live_pixels(levels) -> int:
    """Pixels of a [L,H,W] batch whose FAST score can be non-zero: the centre
    or one of the 16 ring pixels (indices wrap, as the function defines) is
    non-zero. Everywhere else every difference is 0 and so is the score,
    whatever computes it."""
    from vo_slam_test_tpu_torch.ops.fast import CIRCLE16

    nz = levels != 0
    live = nz.clone()
    for dx, dy in CIRCLE16:
        live |= torch.roll(nz, shifts=(-dy, -dx), dims=(-2, -1))
    return int(live.sum())


# per pair of live pixels, held in the two 16-bit lanes of a word: 17 packed
# subtracts (the centre's bias and the 16 differences) and 80 three-input
# packed minima and maxima (for the dark and for the bright arcs: 16 runs of
# three ring positions, 16 nine-arcs of three runs, 8 for the final maximum),
# all on the integer pipe (VIMNMX3.S16x2 runs at that pipe's full rate on this
# card: perf/kernel_split.py)
FAST_PAIR_OPS = {"alu": 17 + 2 * (16 + 16 + 8)}


def fast_bound(levels):
    """Bound of one FAST launch from this run's input: bytes for every pixel
    read once and its score written once; operations only for the pixels
    whose score can be non-zero (``fast_live_pixels``), two to a word, at the
    fewest instructions the card's instruction set needs (FAST_PAIR_OPS).
    -> (ms, bound_by, counts)."""
    n, live = levels.numel(), fast_live_pixels(levels)
    ms, by = bound_ms(8 * n, {k: v * ((live + 1) // 2) for k, v in FAST_PAIR_OPS.items()})
    return ms, by, dict(pixels=n, live_pixels=live)


def _tensors(arrs, device):
    return [torch.as_tensor(np.ascontiguousarray(x)).to(device) for x in arrs]


def random_top2_instance(rng, M, N, device):
    """Seeded instance with clustered windows, duplicated target descriptors
    (distance ties) and 16 rows with nothing allowed."""
    a, b = _descriptors(rng, M, N)
    row_ok = rng.random(M) < 0.85
    row_ok[:16] = False
    lo = rng.integers(-1, 4, M).astype(np.int32)
    return _tensors([
        a, b,
        rng.uniform(0, 640, M).astype(np.float32), rng.uniform(0, 480, M).astype(np.float32),
        rng.uniform(0.5, 120, M).astype(np.float32), rng.uniform(-10, 640, M).astype(np.float32),
        rng.uniform(5, 120, M).astype(np.float32), lo,
        (lo + rng.integers(0, 3, M)).astype(np.int32), row_ok,
        rng.uniform(0, 640, N).astype(np.float32), rng.uniform(0, 480, N).astype(np.float32),
        np.where(rng.random(N) < 0.4, -1.0, rng.uniform(0, 640, N)).astype(np.float32),
        rng.integers(0, 8, N).astype(np.int32), rng.random(N) < 0.9,
    ], device)


def random_chi2_instance(rng, M, N, device):
    """Seeded chi2-mode instance, shaped like fuse's: each source row is
    projected within a few pixels of a target keypoint at the target's
    octave band, so the chi2 bound decides many pairs; half the targets are
    stereo; ties and 16 empty rows -> the 15 arguments and ``col_isig2``."""
    a, b = _descriptors(rng, M, N)
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
    return _tensors([
        a, b, ru, rv, (3.0 * 1.2 ** pred).astype(np.float32), rur, np.zeros(M, np.float32),
        pred - 1, pred, row_ok, cu, cv, cur, c_oct, rng.random(N) < 0.95,
        (1.0 / (1.2 ** c_oct) ** 2).astype(np.float32),
    ], device)


def random_nb_instance(rng, B, M, N, device):
    """B seeded chi2 instances sharing one source set, as
    ``fuse_curr_into_neighbors`` passes it (a stride-0 ``expand``)."""
    insts = [random_chi2_instance(rng, M, N, device) for _ in range(B)]
    args = [torch.stack(x) for x in zip(*insts)]
    args[0] = insts[0][0][None].expand(B, M, 8)
    return args


def random_epi_instance(rng, M, N, device):
    """``epi_instances.random_epi_arrays`` on ``device`` -> the 13 arguments
    of ``masked_top1_epi``."""
    return _tensors(random_epi_arrays(rng, M, N), device)


def epi_edge_instance(kind, M, N, device):
    """``epi_instances.epi_edge_arrays`` on ``device``."""
    return _tensors(epi_edge_arrays(kind, M, N), device)


def seeded_mapping_instances(device):
    """The seeded instances of the mapping path's four search sites, drawn in
    this order from one generator -> {site: (args, kwargs)}."""
    rng = np.random.default_rng(1)
    chi2_kw = lambda x: (x[:15], dict(col_isig2=x[15], chi2_gate=True))  # noqa: E731
    return {
        "top2_m4096": (random_top2_instance(rng, 4096, 1024, device), {}),
        "top2_chi2": chi2_kw(random_chi2_instance(rng, 4096, 1024, device)),
        "top2_nb": chi2_kw(random_nb_instance(rng, 16, 1024, 1024, device)),
        "top1_epi": (random_epi_instance(rng, 1024, 1024, device), {}),
    }


def random_ba_instance(rng, WF, wk, O, L, n_live, device, slot=None):
    """Seeded local-BA instance in the layout of ``ba_accumulate``: poses
    near the identity looking down +z, ``n_live`` points 2-6 m ahead (the
    rest empty pads), each seen by 2..O distinct keyframe slots (valid
    first, then empty slots), a stereo/mono mix, one observation in ten
    moved beyond the Huber threshold, two fixed window slots and slots past
    the window -> dict of the wrapper's arguments (the Pass-1 case: act is
    every valid observation). ``slot`` [O,L] (i32, -1 none), when given,
    replaces the drawn observer slots."""
    from vo_slam_test_tpu_torch import lie

    fx, fy, cx, cy, bf = 517.3, 516.5, 318.6, 255.3, 40.0
    xi = np.concatenate([rng.normal(0, 0.1, (WF, 3)), rng.normal(0, 0.05, (WF, 3))], 1)
    poses = lie.se3_exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
    X = np.zeros((3, L), np.float32)
    X[:, :n_live] = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (n_live, 3)).T
    if slot is None:
        slot = np.full((O, L), -1, np.int32)
        n_obs = rng.integers(2, O + 1, n_live)
        for p in range(n_live):
            slot[:n_obs[p], p] = rng.choice(WF, n_obs[p], replace=False)
    pc = np.einsum("sij,jl->sil", poses[:, :3, :3], X) + poses[:, :3, 3:]   # [WF,3,L]
    s = np.maximum(slot, 0)
    cols = np.arange(L)[None].repeat(O, 0)
    x, y, z = pc[s, 0, cols], pc[s, 1, cols], pc[s, 2, cols]
    u = fx * x / z + cx + rng.normal(0, 0.5, (O, L))
    v = fy * y / z + cy + rng.normal(0, 0.5, (O, L))
    outl = rng.random((O, L)) < 0.1
    u = np.where(outl, u + rng.choice([-1, 1], (O, L)) * rng.uniform(10, 40, (O, L)), u)
    ur = np.where(rng.random((O, L)) < 0.5, u - bf / z + rng.normal(0, 0.5, (O, L)), -1.0)
    valid = slot >= 0
    octave = rng.integers(0, 8, (O, L))
    fixed = np.zeros(WF, bool)
    fixed[[1, 3]] = True
    povar = valid & (slot < wk) & ~fixed[s]
    f32 = lambda a: np.where(valid, a, 0.0).astype(np.float32)  # noqa: E731
    args = _tensors([poses.reshape(WF, 16).T, X, slot, f32(u), f32(v),
                     np.where(valid, ur, -1.0).astype(np.float32), f32(1.2 ** (-2.0 * octave)),
                     valid.astype(np.float32), povar.astype(np.float32),
                     np.array([fx, fy, cx, cy, bf], np.float32)], device)
    return dict(lam=torch.tensor(1e-4, dtype=torch.float32, device=device), posesT=args[0],
                X=args[1], slot=args[2], u=args[3], v=args[4], ur=args[5], isig2=args[6],
                act=args[7], povar=args[8], cam5=args[9], wk=wk, huber=True,
                n_pts=torch.tensor(n_live, dtype=torch.int32, device=device))


def ba_counts(inst):
    """Live points, valid observations, observations by a variable window
    slot, (point, window slot) pairs and pairs of window slots of one point
    (what the BA kernels' work follows)."""
    slot, povar, wk = inst["slot"], inst["povar"] > 0, inst["wk"]
    n = int(inst["n_pts"])
    valid = slot[:, :n] >= 0
    win = (slot[:, :n, None] == torch.arange(wk, device=slot.device)) & povar[:, :n, None]
    per_pt = win.any(0).sum(1)                                          # window slots per point
    return dict(live_points=n, observations=int(valid.sum()),
                window_observations=int(win.sum()), point_slots=int(per_pt.sum()),
                slot_pairs=int((per_pt * per_pt).sum()))


# f32 instructions per unit of work that the function needs, whatever computes
# it: per valid observation a residual with its robust weight ~38, the
# Jacobians 108, its terms of Hll and bl 36; per observation by a window slot
# its Wc row 72 and its terms of the pose block (21 of the symmetric 6x6) and
# gradient 108; per (point, window slot) Wc Hinv and the right side 72; per
# pair of window slots of a point the 6x6 block of S_red 108; per live point
# the closed-form inverse ~40. Back-substitution: 18 per (point, window slot)
# and 12 per point
def ba_bound(kind, inst):
    """Bound of one BA kernel call from this run's inputs -> (ms, bound_by,
    counts). Bytes: each input read once and each output written once, for
    live points only (pads are neither read nor needed): X (12) and the slot
    column (4 O) per live point, the five observation fields (and povar) per
    valid observation, the poses; outputs Hinv and bl (48) per live point,
    Wc rows (72) per (point, window slot), the pose blocks and the Schur
    matrix once."""
    c = ba_counts(inst)
    O = inst["slot"].shape[0]
    WF, wk = inst["posesT"].shape[1], inst["wk"]
    pts, obs, wobs, ps, pairs = (c[k] for k in ("live_points", "observations",
                                                 "window_observations", "point_slots",
                                                 "slot_pairs"))
    if kind == "acc":
        n_bytes = (64 * WF + pts * (12 + 4 * O) + obs * 24 + pts * 48 + ps * 72
                   + 4 * (wk * 42 + (wk * 6) ** 2 + wk * 6 + 1))
        ops = obs * (38 + 108 + 36) + wobs * (72 + 108) + ps * 72 + pairs * 108 + pts * 40
    elif kind == "cost":
        n_bytes = 64 * WF + pts * (12 + 4 * O) + obs * 20 + 4
        ops = obs * 38
    else:
        n_bytes = pts * (48 + 12) + ps * 72 + wk * 24
        ops = ps * 18 + pts * 12
    ms, by = bound_ms(n_bytes, {"f32": ops})
    return ms, by, c


def check_ba(label, kind, got, inst, plain):
    """Kernel output against the plain version on the same inputs, at the
    JAX package's kernel-test tolerances (tests/test_local_ba.py:201-209):
    the cost to rtol 1e-5, Hpp, bp, bl and Wc to 2e-5 x their largest
    entry. The rest, whose f32 rounding the damped point inverse amplifies
    (a near-singular block's inverse is rounding noise in both versions):
    each Hinv block to 1e-5 x its condition number x its largest entry (the
    blocks' sums differ by ~n eps in f32, which the inverse scales by the
    condition number); S_red and rhs_red against the plain Schur contraction
    of the kernel's own Hinv, Wc and bl, to 1e-4 of the same sums of absolute
    values (sums of up to L terms in another order); dx_pt to
    1e-4 of its forward error scale |Hinv| (|bl| + |Wc|^T |dx_pose|) (a sum
    of 6 wk + 3 terms in another order: ~n eps). -> max |kernel - plain|
    over the entries compared with the plain version directly."""
    from vo_slam_test_tpu_torch.ops import ba_pallas

    def close(name, g, w, atol, rtol=0.0):
        err = (g - w).abs()
        bad = ~(err <= atol + rtol * w.abs())
        if bool(bad.any()):
            raise AssertionError(f"{label}: {name} differs from the plain version: max |err| "
                                 f"{float(err.max())}, {int(bad.sum())} entries out of tolerance")
        return float(err.max()) if err.numel() else 0.0

    if kind == "cost":
        return close("cost", got, plain, 0.0, 1e-5)
    if kind == "backsub":
        Wc, Hinv, bl, dxp = inst[:4]
        wk, _, L = Wc.shape
        scale = torch.einsum("ijl,jl->il", Hinv.reshape(3, 3, L).abs(), bl.abs() + torch.einsum(
            "wikl,wi->kl", Wc.reshape(wk, 6, 3, L).abs(), dxp.abs()))
        return close("dx_pt", got, plain, 1e-4 * scale)
    err = 0.0
    names = ("Hpp", "bp", "S_red", "rhs_red", "cost", "Hinv", "bl", "Wc")
    for name in ("Hpp", "bp", "bl", "Wc"):
        i = names.index(name)
        err = max(err, close(name, got[i], plain[i], 2e-5 * float(plain[i].abs().max())))
    err = max(err, close("cost", got[4], plain[4], 0.0, 1e-5))
    L = plain[5].shape[1]
    cond = torch.linalg.cond(plain[5].T.reshape(L, 3, 3).double()).float()
    err = max(err, close("Hinv", got[5], plain[5], 1e-5 * cond * plain[5].abs().amax(0)))
    S, rhs, S_abs, rhs_abs = schur_of(got[7], got[5], got[6])
    close("S_red", got[2], S, 1e-4 * S_abs)
    close("rhs_red", got[3], rhs, 1e-4 * rhs_abs)
    return err


def schur_of(Wc, Hinv, bl):
    """The Schur blocks S_red = sum_l (Wc_a Hinv) Wc_b^T and rhs_red =
    sum_l (Wc_a Hinv) bl of given blocks, and the same sums of absolute
    values: the scale of their rounding (the points' terms cancel, so the
    sum itself is no scale)."""
    wk, _, L = Wc.shape
    W4 = Wc.reshape(wk, 6, 3, L)
    WH = torch.einsum("wikl,kjl->wijl", W4, Hinv.reshape(3, 3, L))
    WHa = torch.einsum("wikl,kjl->wijl", W4.abs(), Hinv.reshape(3, 3, L).abs())
    n = wk * 6
    return (torch.einsum("wikl,vmkl->wivm", WH, W4).reshape(n, n),
            torch.einsum("wikl,kl->wi", WH, bl).reshape(n, 1),
            torch.einsum("wikl,vmkl->wivm", WHa, W4.abs()).reshape(n, n),
            torch.einsum("wikl,kl->wi", WHa, bl.abs()).reshape(n, 1))


def check_equal(label, got, want, names):
    """Every output equal -> max |kernel - plain| (0)."""
    err = 0.0
    for g, w, what in zip(got, want, names):
        err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel differs from the plain version on {what}")
    return err


# instructions per allowed pair: 8 XOR, 7 adds, the packed key (shift, or)
# and the top-2 compares (2) on the ALU, 8 popc; the top-1 search has 1 compare
TOP2_PAIR_OPS = {"alu": 19, "popc": 8}
TOP1_PAIR_OPS = {"alu": 18, "popc": 8}


def _count(ops: dict, n: int, into: dict) -> None:
    for k, v in ops.items():
        into[k] = into.get(k, 0) + v * n


def top2_bound(args, col_isig2=None, chi2=False):
    """Bound of one top-2 launch from this run's inputs ([M,...] for one
    search, [B,M,...] for the batched form). Only live rows (row_ok) and
    live columns (col_ok) cost more than their flag, and only pairs that
    pass the gates need descriptors. Bytes: row_ok for every row and the four
    outputs (16 per row); the gate parameters of each live row (28); in a
    search with a live row, col_ok for every column and the gate parameters
    of each live column (16, + 4 for col_isig2); the 32-byte descriptor of
    each row and each column with an allowed pair, a source set shared by the
    neighbours (stride 0) once. Operations on each live pair (live rows x
    live columns of the same search): the window, octave and stereo gate, 3
    f32 and 7 ALU; in chi2 mode 6 f32 (+3 for a stereo column) and 6 ALU.
    Then TOP2_PAIR_OPS on each allowed pair. -> (ms, bound_by, counts)."""
    from vo_slam_test_tpu_torch.ops import match_pallas

    batched = args[0].dim() == 3
    x = [t if batched else t[None] for t in args]
    isig = None if col_isig2 is None else (col_isig2 if batched else col_isig2[None])
    B, M, N = x[0].shape[0], x[0].shape[1], x[1].shape[1]
    row_ok, col_ok = x[9], x[14]
    live_r = row_ok.sum(1, dtype=torch.int64)
    live_c = col_ok.sum(1, dtype=torch.int64)
    mask = torch.stack([match_pallas.allowed_mask(
        *[t[b] for t in x[2:15]], None if isig is None else isig[b], chi2) for b in range(B)])
    allowed = int(mask.sum())
    rows_a = mask.any(2)
    src_rows = (int(rows_a.any(0).sum()) if batched and args[0].stride(0) == 0
                else int(rows_a.sum()))
    cols_a = int(mask.any(1).sum())
    col_bytes = (N + live_c * (16 + (4 if chi2 else 0))) * (live_r > 0)
    n_bytes = (B * M * 17 + int(live_r.sum()) * 28 + int(col_bytes.sum())
               + (src_rows + cols_a) * 32)
    live_pairs = int((live_r * live_c).sum())
    ops = {}
    if chi2:
        stereo_c = (col_ok & (x[12] >= 0)).sum(1, dtype=torch.int64)
        _count({"f32": 6, "alu": 6}, live_pairs, ops)
        _count({"f32": 3}, int((live_r * stereo_c).sum()), ops)
    else:
        _count({"f32": 3, "alu": 7}, live_pairs, ops)
    _count(TOP2_PAIR_OPS, allowed, ops)
    ms, by = bound_ms(n_bytes, ops)
    return ms, by, dict(live_rows=int(live_r.sum()), live_cols=int(live_c.sum()),
                        live_pairs=live_pairs, allowed_pairs=allowed,
                        rows_with_allowed=src_rows, cols_with_allowed=cols_a)


def epi_bound(args):
    """Bound of one epipolar top-1 launch from this run's inputs. Only live
    rows (row_ok) and live columns (col_ok) cost more than their flag, and
    only pairs that pass the gates need descriptors. Bytes: row_ok for every
    row and the two outputs (8 per row); the line, den, group and mono flag
    of each live row (21); with a live row in the launch, col_ok for every
    column and the u, v, thr, group and epipole flag of each live column
    (17); the 32-byte descriptor of each row and each column with an allowed
    pair. Operations on each live pair: the line value and the two products,
    6 f32; the compare, the group escape and the mono/epipole rejection, 5
    ALU. Then TOP1_PAIR_OPS on each allowed pair. -> (ms, bound_by,
    counts)."""
    from vo_slam_test_tpu_torch.ops import match_pallas

    M, N = args[0].shape[0], args[1].shape[0]
    live_r, live_c = int(args[5].sum()), int(args[11].sum())
    mask = match_pallas.epi_allowed_mask(*args[2:])
    allowed = int(mask.sum())
    rows_a, cols_a = int(mask.any(1).sum()), int(mask.any(0).sum())
    ops = {}
    _count({"f32": 6, "alu": 5}, live_r * live_c, ops)
    _count(TOP1_PAIR_OPS, allowed, ops)
    n_bytes = (M * 9 + live_r * 21 + ((N + live_c * 17) if live_r else 0)
               + (rows_a + cols_a) * 32)
    ms, by = bound_ms(n_bytes, ops)
    return ms, by, dict(live_rows=live_r, live_cols=live_c, live_pairs=live_r * live_c,
                        allowed_pairs=allowed, rows_with_allowed=rows_a,
                        cols_with_allowed=cols_a)


PERF_DIR = Path(__file__).resolve().parent / "perf"
# the first designs of rows 2-6, built beside the current kernels and timed
# with them (perf/kernel_split.py takes them apart)
V1_SOURCES = (("orb_v1", PERF_DIR), ("match_v1", PERF_DIR), ("epi_v1", PERF_DIR))


def v1_launchers(_build):
    """The first designs of rows 2-6 (``perf/orb_v1.cu``, ``perf/match_v1.cu``,
    ``perf/epi_v1.cu``) -> (orb, top2, epi): each maps a split mode (0: the
    whole kernel) to a callable that takes the current C entry's arguments,
    so ``orb_call``, ``top2_call`` and ``epi_call`` launch it as the wrappers
    launch the current kernel."""
    from vo_slam_test_tpu_torch.ops import match_cuda, orb_cuda

    def launcher(name, symbol, argtypes):
        fn = getattr(ctypes.CDLL(str(_build.library_path(name, PERF_DIR))), symbol)
        fn.argtypes = list(argtypes[:-1]) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def with_mode(mode):
            def call(*args):  # the C entry's arguments, the stream last
                rc = fn(*args[:-1], mode, args[-1])
                if rc != 0:
                    raise RuntimeError(f"{symbol}: cudaError {rc}")
            return call
        return with_mode

    return (launcher("orb_v1", "orb_v1_launch", orb_cuda.KERNEL.argtypes),
            launcher("match_v1", "masked_top2_v1_launch", match_cuda.KERNEL.argtypes),
            launcher("epi_v1", "masked_top1_epi_v1_launch", match_cuda.KERNEL_EPI.argtypes))


def orb_call(kernel, raw, blur, level, ys, xs):
    """Launch ``kernel`` (``orb_cuda.KERNEL`` or a first-design launcher) on
    ``orb_angle_desc``'s arguments, as the wrapper does -> (angle, desc)."""
    from vo_slam_test_tpu_torch.ops import orb_cuda

    pat, umax = orb_cuda._tables(raw.device)
    N = level.shape[0]
    angle = torch.empty((N,), dtype=torch.float32, device=raw.device)
    desc = torch.empty((N, 8), dtype=torch.int32, device=raw.device)
    kernel(raw.data_ptr(), blur.data_ptr(), level.data_ptr(), ys.data_ptr(), xs.data_ptr(),
           pat.data_ptr(), umax.data_ptr(), N, *raw.shape, angle.data_ptr(), desc.data_ptr(),
           torch.cuda.current_stream().cuda_stream)
    return angle, desc


def top2_call(kernel, args, kw):
    """Launch ``kernel`` (a top-2 call site's ``_build.Kernel`` or a
    first-design launcher) on the arguments of ``masked_top2`` ([M,...]) or
    ``masked_top2_nb`` ([B,M,...]), as their wrappers do -> four [B,M]
    int32."""
    from vo_slam_test_tpu_torch.ops import match_cuda

    batched = args[0].dim() == 3
    x = [t if batched else t[None] for t in args]
    isig = kw.get("col_isig2")
    if isig is not None and not batched:
        isig = isig[None]
    B, M, N = x[0].shape[0], x[0].shape[1], x[1].shape[1]
    return match_cuda._launch_top2("top2_call", kernel, x[0], x[1], x[2:10], x[10:15], isig,
                                   kw.get("chi2_gate", False), B, M, N)


def epi_call(kernel, args):
    """Launch ``kernel`` (``match_cuda.KERNEL_EPI``, a first-design launcher
    or a build variant) on ``masked_top1_epi``'s 13 arguments (contiguous, on
    the card, as the wrapper checks them) -> (best_i, best_d)."""
    M, N = args[0].shape[0], args[1].shape[0]
    assert all(t.is_cuda and t.is_contiguous() for t in args), "epi_call: contiguous CUDA tensors"
    outs = [torch.empty((M,), dtype=torch.int32, device=args[0].device) for _ in range(2)]
    kernel(*[t.data_ptr() for t in args], M, N, *[o.data_ptr() for o in outs],
           torch.cuda.current_stream().cuda_stream)
    return tuple(outs)


def bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def frame_instances(seq, cfg, device):
    """Phases 1-3's inputs from frames 0 and 1 of the first main path's
    sequence: a FusedTracker, frame 0's pyramid and its selected keypoints
    (the ORB kernel's input), both frames' extraction, frame 0's points and
    the frame-pair top-2 arguments at r=15 with identity poses -> dict."""
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused, select_keypoints
    from vo_slam_test_tpu_torch.matching import matcher
    from vo_slam_test_tpu_torch.ops.pyramid import build_pyramid
    from vo_slam_test_tpu_torch.pipeline import tracking

    tracker = tracking.FusedTracker(cfg, device=device)
    spec, cam = tracker.spec, tracker.camera
    (gray0, depth0, _), (gray1, depth1, _) = seq[0], seq[1]
    gray0 = torch.as_tensor(gray0).to(device)
    pyr = build_pyramid(gray0, spec)
    sel = select_keypoints(pyr, spec, tracker.budgets)
    f0 = extract_fused(gray0, torch.as_tensor(depth0).to(device), cam, spec, tracker.budgets)
    f1 = extract_fused(torch.as_tensor(gray1).to(device), torch.as_tensor(depth1).to(device),
                       cam, spec, tracker.budgets)
    eye = torch.eye(4, device=device)
    pts, pts_ok = tracking._spawn_temp_points(f0, eye, cam)
    top2_args = matcher.projection_top2_args(
        pts, f0.desc, f0.octave, pts_ok, f1.uv_und, f1.u_right, f1.octave, f1.desc, f1.valid,
        torch.zeros_like(f1.valid), eye, eye, tracker.scale_factors,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.b, float(cam.width), float(cam.height), 15.0)
    return dict(tracker=tracker, pyr=pyr, sel=sel, f0=f0, f1=f1, eye=eye, pts=pts,
                pts_ok=pts_ok, top2_args=top2_args)


class PlainGuard:
    """Wraps plain versions; records any call that gets a CUDA tensor."""

    def __init__(self, targets):
        self.targets = targets
        self.cuda_calls = []
        self.saved = []

    def __enter__(self):
        for mod, attr in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def guarded(*args, _fn=fn, _attr=attr, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    self.cuda_calls.append(_attr)
                return _fn(*args, **kw)
            setattr(mod, attr, guarded)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []


def capture_instances(match_cuda, ba_cuda, system, cfg, frames):
    """Drive the SlamSystem path over ``frames`` and keep a copy of the
    arguments of the local-map top-2 (M=4096), chi2 top-2,
    neighbour-batched and epipolar call whose search found the most rows
    with an allowed pair, and of the first LM iteration (accumulate,
    back-substitution, cost) of the local BA with the most live points."""
    got, score = {}, {}
    names = ("masked_top2", "masked_top2_nb", "masked_top1_epi")
    orig = {n: getattr(match_cuda, n) for n in names}
    ba_names = ("ba_accumulate", "ba_backsub", "ba_cost")
    orig_ba = {n: getattr(ba_cuda, n) for n in ba_names}
    ba_best = {"n": -1}

    def recorder(name):
        def wrapped(*args, **kw):
            key = {"masked_top2_nb": "top2_nb", "masked_top1_epi": "top1_epi"}.get(name)
            if name == "masked_top2":
                key = "top2_chi2" if kw.get("chi2_gate") else (
                    "top2_m4096" if kw.get("kernel") is match_cuda.KERNEL_LOCAL else None)
            out = orig[name](*args, **kw)
            if key is not None:
                n_rows = int((out[1] < (1 << 20)).sum())
                if n_rows >= score.get(key, -1):
                    score[key] = n_rows
                    got[key] = ([a.clone() for a in args],
                                {k: v.clone() if isinstance(v, torch.Tensor) else v
                                 for k, v in kw.items() if k != "kernel"})
            return out
        return wrapped

    def ba_recorder(name):
        def wrapped(*args, **kw):
            keep = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
            if name == "ba_accumulate":
                n = int(kw["n_pts"])
                if n > ba_best["n"]:
                    ba_best.clear()
                    ba_best.update(n=n, acc=([keep(a) for a in args], dict(n_pts=keep(kw["n_pts"]))))
            elif (name == "ba_backsub" and "acc" in ba_best and name not in ba_best
                  and bool(torch.isfinite(args[3]).all())):
                # the first back-substitution of that BA whose pose step is
                # finite (a Cholesky of an indefinite system gives NaN), with
                # the mask words of its iteration
                ba_best[name] = [keep(a) for a in args[:4]] + [keep(kw["mask"])]
            return orig_ba[name](*args, **kw)
        return wrapped

    for n in names:
        setattr(match_cuda, n, recorder(n))
    for n in ba_names:
        setattr(ba_cuda, n, ba_recorder(n))
    try:
        s = system.SlamSystem(cfg)
        for f in frames:
            s.track(*f)
        torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(match_cuda, n, fn)
        for n, fn in orig_ba.items():
            setattr(ba_cuda, n, fn)
    missing = {"top2_m4096", "top2_chi2", "top2_nb", "top1_epi"} - set(got)
    if missing or "ba_backsub" not in ba_best:
        raise AssertionError(f"the capture run launched no {sorted(missing)} or no full LM "
                             f"iteration ({sorted(ba_best)})")
    # the batched search shares one source set across neighbours: time it as
    # the path passes it (stride 0)
    args, kw = got["top2_nb"]
    args[0] = args[0][0][None].expand_as(args[0])
    (lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk, huber), kw = ba_best["acc"]
    got["ba"] = dict(lam=lam, posesT=posesT, X=X, slot=slot, u=u, v=v, ur=ur, isig2=isig2,
                     act=act, povar=povar, cam5=cam5, wk=wk, huber=huber, n_pts=kw["n_pts"])
    got["ba_backsub"] = ba_best["ba_backsub"]
    return got


def n_baseline_neighbours(m, kf_id, cam) -> int:
    """The triangulation's neighbour count past the baseline gate
    (localMapping.cpp:136, 172-174), computed apart from the port's code."""
    w_row = m.covis[kf_id] * m.kf_valid.to(torch.int32)
    order = torch.argsort(-w_row, stable=True)[:10]
    nb = torch.where(w_row[order] > 0, order, -1)
    ow1 = torch.linalg.inv(m.kf_pose[kf_id])[:3, 3]
    ow2 = torch.linalg.inv(m.kf_pose[nb.clamp(min=0)])[:, :3, 3]
    return int(((nb >= 0) & (torch.linalg.norm(ow2 - ow1, dim=-1) > cam.b)).sum())


def run_slice(system, triangulate, cfg, frames, timed: bool, profile_frames=()):
    """One SlamSystem run over ``frames`` (interruptBA lowered: every
    keyframe event runs local BA). timed:
    CUDA events per frame and around each keyframe's mapping step, host syncs
    per frame (sync debug mode). Otherwise: the epipolar searches the path
    should launch, counted apart, and a torch.profiler window over
    ``profile_frames``."""
    s = system.SlamSystem(cfg)
    rec = dict(frame_ms=[], wall_ms=[], syncs=[], sync_sites={}, map_events=[], epi_expected=0,
               profile=None)
    orig_bg, orig_tri = system.background_step, triangulate.create_new_map_points
    cur = [0]

    def timed_bg(m, did_kf, kf_id, *a, **k):
        if not did_kf:
            return orig_bg(m, did_kf, kf_id, *a, **k)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_bg(m, did_kf, kf_id, *a, **k)
        e1.record()
        rec["map_events"].append((cur[0], e0, e1))
        return out

    def counted_tri(m, kf_id, caps, cam, *a, **k):
        rec["epi_expected"] += n_baseline_neighbours(m, kf_id, cam)
        return orig_tri(m, kf_id, caps, cam, *a, **k)

    if timed:
        system.background_step = timed_bg
    else:
        triangulate.create_new_map_points = counted_tri
    prof = None
    try:
        for i, (gray, depth, ts) in enumerate(frames):
            cur[0] = i
            if not timed:
                if profile_frames and i == profile_frames[0]:
                    from torch.profiler import ProfilerActivity, profile

                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.__enter__()
                    t_prof = time.perf_counter()
                s.track(gray, depth, ts)
                if prof is not None and i == profile_frames[-1]:
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t_prof) * 1e3 / len(profile_frames)
                    prof.__exit__(None, None, None)
                    rec["profile"] = (prof, wall)
                    prof = None
                continue
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                s.track(gray, depth, ts)
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            torch.cuda.synchronize()
            rec["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["frame_ms"].append(start.elapsed_time(end))
            sync_ws = [w for w in caught if "synchroniz" in str(w.message)]
            rec["syncs"].append(len(sync_ws))
            for w in sync_ws:
                site = f"{w.filename.split('vo_slam_test_tpu_torch/')[-1]}:{w.lineno}"
                rec["sync_sites"][site] = rec["sync_sites"].get(site, 0) + 1
        torch.cuda.synchronize()
    finally:
        system.background_step, triangulate.create_new_map_points = orig_bg, orig_tri
        if prof is not None:
            prof.__exit__(None, None, None)
    rec["map_ms"] = {i: e0.elapsed_time(e1) for i, e0, e1 in rec["map_events"]}
    return s, rec


def run_chunked(system, cfg, frames, chunk):
    """One SlamSystem(chunk=...) run over ``frames``: host wall ms of each
    ``track`` call that completed a chunk (tracking and mapping of its
    frames), synchronized."""
    s = system.SlamSystem(cfg, chunk=chunk)
    chunk_ms = []
    for i, (gray, depth, ts) in enumerate(frames):
        t0 = time.perf_counter()
        s.track(gray, depth, ts)
        if (i + 1) % chunk == 0:
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return s, chunk_ms


def expected_stops(made_kf, chunk):
    """Events whose local BA a later keyframe of the same chunk overtakes
    (the rule of ``chunk_ba_stops``, computed apart from the port)."""
    stops = set()
    for c0 in range(0, len(made_kf), chunk):
        kfs = [i for i in range(c0, min(c0 + chunk, len(made_kf))) if made_kf[i]]
        stops.update(kfs[:-1])
    return stops


def check_ba_launches(label, s, kf_frames, launches, stops):
    """Every keyframe event has its LM iteration counts; stopped events ran
    none, the others ran pass 1; each BA kernel launched once per iteration
    run."""
    iters = {f: (n1, n2) for f, n1, n2 in s.ba_iters}
    n_iter = sum(n1 + n2 for n1, n2 in iters.values())
    bad = [f for f in kf_frames if (iters.get(f) == (0, 0)) != (f in stops) or f not in iters]
    if sorted(iters) != kf_frames or bad:
        raise AssertionError(f"{label}: LM iterations {s.ba_iters} do not fit the keyframe "
                             f"events {kf_frames} (stopped: {sorted(stops)})")
    if any(launches[k] != n_iter for k in ("ba_acc", "ba_cost", "ba_backsub")):
        raise AssertionError(f"{label}: BA kernel launches {launches} != {n_iter} LM iterations")
    print(f"  {n_iter} LM iterations, each BA kernel launched once per iteration")


def check_same_maps(label, s_a, s_b):
    diff = [f for f in s_a.map.__dataclass_fields__
            if not torch.equal(getattr(s_a.map, f), getattr(s_b.map, f))]
    if diff or s_a.ba_iters != s_b.ba_iters:
        raise AssertionError(f"two runs of {label} gave different map tensors {diff} or LM "
                             f"iterations {s_a.ba_iters} / {s_b.ba_iters}")
    print(f"  two runs: all {len(s_a.map.__dataclass_fields__)} map tensors and the LM "
          f"iteration counts identical")


def device_profile(prof, n_frames, wall_ms):
    """Device busy ms per frame, kernels per frame and the top kernels from
    the CUDA kernel events of a profiler window."""
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel.setdefault(e.name, [0.0, 0])
            by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / n_frames
            by_kernel[e.name][1] += 1
    busy = sum(v[0] for v in by_kernel.values())
    n_launch = sum(v[1] for v in by_kernel.values()) / n_frames
    print(f"profile of {n_frames} frames: wall {wall_ms:.3f} ms/frame (profiler on), device busy "
          f"{busy:.3f} ms/frame in {n_launch:.0f} kernels/frame, idle share {1 - busy / wall_ms:.3f}")
    for k, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:8.3f} ms/frame {cnt / n_frames:6.0f}/frame  {k[:90]}")
    return busy, n_launch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import (
        _build, ba_cuda, ba_pallas, brief, fast, fast_cuda, match_cuda, match_pallas, orb_cuda,
        orientation, pattern)
    from vo_slam_test_tpu_torch.ops.pyramid import interior
    from vo_slam_test_tpu_torch.matching import matcher
    from vo_slam_test_tpu_torch.pipeline import system, tracking
    from vo_slam_test_tpu_torch.slam_map import triangulate

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    t_start = time.perf_counter()

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(extra=V1_SOURCES)
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)} "
          + " ".join(f"{k}={v['seconds']:.2f}s" for k, v in built.items()))
    for k, v in built.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k}.cu: {line.strip()}")
    noop = _build.Kernel("noop", "noop_launch", [ctypes.c_int, ctypes.c_void_p])
    floor = {f"launches_{n}": time_graph_ms(
        lambda: noop(n, torch.cuda.current_stream().cuda_stream)) for n in (1, 2)}
    # a launch that does nothing, and two in a row (each waits for the one
    # before it): what a kernel of one or two launches costs before any work
    print(json.dumps({"launch_floor_ms": floor}))
    orb_v1, top2_v1, epi_v1 = v1_launchers(_build)
    all_kernels = {"fast": fast_cuda.KERNEL, "orb": orb_cuda.KERNEL, "top2": match_cuda.KERNEL,
                   "top2_m4096": match_cuda.KERNEL_LOCAL, "top2_chi2": match_cuda.KERNEL_CHI2,
                   "top2_nb": match_cuda.KERNEL_NB, "top1_epi": match_cuda.KERNEL_EPI,
                   "ba_acc": ba_cuda.KERNEL_ACC, "ba_cost": ba_cuda.KERNEL_COST,
                   "ba_backsub": ba_cuda.KERNEL_BACKSUB}
    ba_keys = ("ba_acc", "ba_cost", "ba_backsub")
    plains = [(fast, "fast_score"), (orientation, "ic_angle"), (brief, "compute_descriptors"),
              (match_pallas, "masked_top2_plain"), (match_pallas, "masked_top2_nb_plain"),
              (match_pallas, "masked_top1_epi_plain"), (ba_pallas, "ba_accumulate_plain"),
              (ba_pallas, "ba_cost_plain"), (ba_pallas, "ba_backsub_plain")]

    # -- data: the first main path's sequence -------------------------------
    t0 = time.perf_counter()
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    frames = [seq[i] for i in range(len(seq))]
    print(f"rendered {len(frames)} frames {frames[0][0].shape} in {time.perf_counter() - t0:.1f} s")
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    inst = frame_instances(seq, cfg, dev)
    tracker, pyr, sel = inst["tracker"], inst["pyr"], inst["sel"]
    spec, cam = tracker.spec, tracker.camera
    levels = interior(pyr.raw, spec)
    kernels = {}

    # -- phase 1: FAST ------------------------------------------------------
    got = fast_cuda.fast_score(levels)
    want = fast.fast_score(levels)
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"FAST kernel differs from the plain version: max |err| {err}")
    for a, b in zip(fast.select_candidates(got, spec), fast.select_candidates(want, spec)):
        if not torch.equal(a, b):
            raise AssertionError("FAST candidates differ between kernel and plain scores")
    L, H, W = levels.shape
    if not bool(((levels == levels.round()) & (levels >= 0) & (levels <= 255)).all()):
        raise AssertionError("the pyramid levels are not integers in [0, 255]")
    fb, fby, counted = fast_bound(levels)
    counted["level_pixels"] = sum(h * w for h, w in spec.sizes)
    kernels["fast"] = dict(
        name="fast_score", shape=f"{L}x{H}x{W}", route="cuda", source="vo_slam_test_tpu_torch/csrc/fast.cu",
        replaces="vo_slam_test_tpu/ops/fast_pallas.py:131", max_abs_err=err,
        ms=time_graph_ms(lambda: fast_cuda.fast_score(levels)),
        plain_ms=time_eager_ms(lambda: fast.fast_score(levels)),
        bound_ms=fb, bound_by=fby, library_ms=None, counted=counted)
    print(f"phase fast [{L},{H},{W}]: equal on every pixel, candidates equal; counted {counted}; "
          f"kernel {kernels['fast']['ms']:.4f} ms, plain {kernels['fast']['plain_ms']:.4f} ms, "
          f"bound {fb:.4f} ms ({fby})")

    # -- phase 2: IC angle + rBRIEF -----------------------------------------
    n_valid = int(sel.valid.sum())
    orb_in = (pyr.raw, pyr.blur, sel.level, sel.ys, sel.xs)
    ang, desc = orb_cuda.orb_angle_desc(*orb_in)
    ang_ref = orientation.ic_angle(pyr.raw, sel.level, sel.ys, sel.xs)
    desc_ref = brief.compute_descriptors(pyr.blur, sel.level, sel.ys, sel.xs, ang_ref)
    d = (ang - ang_ref).abs()
    ang_err = float(torch.minimum(d, 360.0 - d).max())
    flips = np.unpackbits((desc ^ desc_ref).cpu().numpy().view(np.uint8), axis=1).sum(1)
    print(f"phase orb N={sel.level.shape[0]} ({n_valid} valid): max angle err {ang_err} deg, "
          f"flipped bits: max {int(flips.max())} per descriptor, {int(flips.sum())} in all")
    if ang_err > 1e-3 or flips.max() > 0:
        raise AssertionError("ORB kernel differs from the plain version beyond tolerance")
    if not all(bits_equal(x, y) for x, y in zip((ang, desc), orb_call(orb_v1(0), *orb_in))):
        raise AssertionError("ORB kernel differs from its first design (perf/orb_v1.cu)")
    N = sel.level.shape[0]
    n_disc = int(pattern.circular_patch_mask().sum())
    # per keypoint: 2 FMAs per disc pixel (the moments), 9 per pattern pair
    # (rotation, rounding, compare), 30 more; all counted as f32 instructions
    ob, oby = bound_ms(N * (n_disc + 512) * 4 + N * 12 + 256 * 16 + N * 36,
                       {"f32": N * (2 * n_disc + 256 * 9 + 30)})
    kernels["orb"] = dict(
        name="orb_angle_desc", shape=f"N={N}", route="cuda", source="vo_slam_test_tpu_torch/csrc/orb.cu",
        replaces="vo_slam_test_tpu/ops/orb_pallas.py:137", max_abs_err=ang_err,
        ms=time_graph_ms(lambda: orb_cuda.orb_angle_desc(*orb_in)),
        v1_ms=time_graph_ms(lambda: orb_call(orb_v1(0), *orb_in)),
        plain_ms=time_eager_ms(lambda: brief.compute_descriptors(
            pyr.blur, sel.level, sel.ys, sel.xs,
            orientation.ic_angle(pyr.raw, sel.level, sel.ys, sel.xs))),
        bound_ms=ob, bound_by=oby, library_ms=None)
    print(f"  kernel {kernels['orb']['ms']:.4f} ms (first design {kernels['orb']['v1_ms']:.4f} ms, "
          f"bit-equal), plain {kernels['orb']['plain_ms']:.4f} ms, bound {ob:.4f} ms ({oby})")

    # -- phase 3: masked Hamming top-2 at 1024x1024 ---------------------------
    f0, f1, eye, pts, pts_ok = (inst[k] for k in ("f0", "f1", "eye", "pts", "pts_ok"))
    real_args = inst["top2_args"]
    rand_args = random_top2_instance(np.random.default_rng(0), 1024, 1024, dev)
    top2_err = 0.0
    for label, args in (("frame pair", real_args), ("random ties/empty rows", rand_args)):
        got = match_cuda.masked_top2(*args)
        want = match_pallas.masked_top2_plain(*args)
        top2_err = max(top2_err, check_equal(f"top-2 on {label}", got, want, TOP2_OUTS))
        check_equal(f"top-2 on {label} against its first design (perf/match_v1.cu)", got,
                    [o[0] for o in top2_call(top2_v1(0), args, {})], TOP2_OUTS)
        n_match = int((got[1] <= matcher.TH_HIGH).sum())
        print(f"phase top2 {label} {tuple(args[0].shape)}x{tuple(args[1].shape)}: "
              f"all four outputs equal; {n_match} rows with best <= {matcher.TH_HIGH}")
    Mr, Nr = real_args[0].shape[0], real_args[1].shape[0]
    mb, mby, counted = top2_bound(real_args)
    kernels["top2"] = dict(
        name="masked_top2", shape=f"{Mr}x{Nr}", route="cuda", source="vo_slam_test_tpu_torch/csrc/match.cu",
        replaces="vo_slam_test_tpu/ops/match_pallas.py:121", max_abs_err=top2_err,
        ms=time_graph_ms(lambda: match_cuda.masked_top2(*real_args)),
        v1_ms=time_graph_ms(lambda: top2_call(top2_v1(0), real_args, {})),
        plain_ms=time_eager_ms(lambda: match_pallas.masked_top2_plain(*real_args)),
        bound_ms=mb, bound_by=mby, library_ms=None, counted=counted)
    print(f"  frame pair: counted {counted}; kernel {kernels['top2']['ms']:.4f} ms (first design "
          f"{kernels['top2']['v1_ms']:.4f} ms, equal), plain {kernels['top2']['plain_ms']:.4f} ms, "
          f"bound {mb:.6f} ms ({mby})")

    # -- data: the second main path's sequence --------------------------------
    # the first 40 frames of the 240-frame orbit (the per-frame motion of the
    # orbit scales with 1/n_frames: never n_frames=40)
    t0 = time.perf_counter()
    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    room_frames = [room[i] for i in range(SLICE_FRAMES)]
    room_cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx,
                          camera_cy=room.cy, camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                          camera_k3=0, camera_fps=30)
    print(f"rendered {len(room_frames)} room-orbit frames {room_frames[0][0].shape} in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- phases 4-7: the mapping path's kernels -------------------------------
    t0 = time.perf_counter()
    # frames 0-12 hold keyframe events at 0, 1, 5 and 12 (JAX on the CPU);
    # the first with keypoints left for triangulation is frame 12's
    captured = capture_instances(match_cuda, ba_cuda, system, room_cfg, room_frames[:13])
    print(f"captured the slice path's kernel instances from frames 0-12 in "
          f"{time.perf_counter() - t0:.1f} s")
    seeded = seeded_mapping_instances(dev)
    specs = {
        "top2_m4096": ("masked_top2_m4096", match_cuda.masked_top2, match_pallas.masked_top2_plain,
                       "vo_slam_test_tpu/ops/match_pallas.py:121", "match.cu", TOP2_OUTS),
        "top2_chi2": ("masked_top2_chi2", match_cuda.masked_top2, match_pallas.masked_top2_plain,
                      "vo_slam_test_tpu/ops/match_pallas.py:121", "match.cu", TOP2_OUTS),
        "top2_nb": ("masked_top2_nb", match_cuda.masked_top2_nb,
                    match_pallas.masked_top2_nb_plain,
                    "vo_slam_test_tpu/ops/match_pallas.py:238", "match.cu", TOP2_OUTS),
        "top1_epi": ("masked_top1_epi", match_cuda.masked_top1_epi,
                     match_pallas.masked_top1_epi_plain,
                     "vo_slam_test_tpu/ops/match_pallas.py:393", "epi.cu", ("best_i", "best_d")),
    }
    for key, (kname, kfn, pfn, replaces, src, outs) in specs.items():
        err = 0.0
        for label, (args, kw) in (("captured", captured[key]), ("seeded", seeded[key])):
            got = kfn(*args, **kw)
            want = pfn(*args, **kw)
            err = max(err, check_equal(f"{kname} on the {label} instance", got, want, outs))
            if key == "top1_epi":
                check_equal(f"{kname} on the {label} instance against its first design "
                            f"(perf/epi_v1.cu)", got, epi_call(epi_v1(0), args), outs)
            else:
                v1 = top2_call(top2_v1(0), args, kw)
                check_equal(f"{kname} on the {label} instance against its first design "
                            f"(perf/match_v1.cu)", got,
                            v1 if key == "top2_nb" else [o[0] for o in v1], outs)
            shape = "x".join(str(s) for s in args[0].shape[:-1]) + f"x{args[1].shape[-2]}"
            print(f"phase {kname} {label} {shape}: all {len(outs)} outputs equal; "
                  f"{int((got[1] < match_pallas.BIG).sum())} rows with an allowed pair")
        args, kw = captured[key]
        if key == "top1_epi":
            kb, kby, counted = epi_bound(args)
        else:
            kb, kby, counted = top2_bound(args, kw.get("col_isig2"), kw.get("chi2_gate", False))
        kernels[key] = dict(
            name=kname, shape=shape, route="cuda", source=f"vo_slam_test_tpu_torch/csrc/{src}",
            replaces=replaces, max_abs_err=err,
            ms=time_graph_ms(lambda: kfn(*args, **kw)),
            plain_ms=time_eager_ms(lambda: pfn(*args, **kw)),
            bound_ms=kb, bound_by=kby, library_ms=None, counted=counted)
        kernels[key]["v1_ms"] = time_graph_ms(
            (lambda: epi_call(epi_v1(0), args)) if key == "top1_epi"
            else (lambda: top2_call(top2_v1(0), args, kw)))
        print(f"  captured: counted {counted}; kernel {kernels[key]['ms']:.4f} ms (first design "
              f"{kernels[key]['v1_ms']:.4f} ms, equal), plain {kernels[key]['plain_ms']:.4f} ms, "
              f"bound {kb:.6f} ms ({kby})")

    # -- phase 7b: the epipolar search's edge instances ---------------------------
    for kind, M, N in EPI_EDGE_CASES:
        args = epi_edge_instance(kind, M, N, dev)
        got = match_cuda.masked_top1_epi(*args)
        check_equal(f"masked_top1_epi on the {kind} {M}x{N} edge instance", got,
                    match_pallas.masked_top1_epi_plain(*args), ("best_i", "best_d"))
        check_equal(f"masked_top1_epi on the {kind} {M}x{N} edge instance against its first "
                    f"design (perf/epi_v1.cu)", got, epi_call(epi_v1(0), args),
                    ("best_i", "best_d"))
    print(f"phase masked_top1_epi edge instances {[f'{k} {m}x{n}' for k, m, n in EPI_EDGE_CASES]}: "
          f"both outputs equal to the plain version and to the first design on each")

    # -- phases 8-10: the local-BA kernels ------------------------------------
    # the captured instance: the first LM iteration of the frames 0-12 event
    # with the most live points; the seeded one at the full-width sizes (WF 64,
    # wk 24, O 12, L 8192) with 1500 live points
    def acc_args(inst):
        return (inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"],
                inst["ur"], inst["isig2"], inst["act"], inst["povar"], inst["cam5"], inst["wk"],
                inst["huber"])

    def cost_args(inst):
        return acc_args(inst)[1:9] + (inst["cam5"], inst["huber"])

    ba_seeded = random_ba_instance(np.random.default_rng(2), 64, 24, 12, 8192, 1500, dev)
    sub_rng = np.random.default_rng(3)
    ba_insts = {}
    for label, inst in (("captured", captured["ba"]), ("seeded", ba_seeded)):
        mask = ba_cuda.ba_mask(inst["slot"].shape[1], dev)
        acc = ba_cuda.ba_accumulate(*acc_args(inst), n_pts=inst["n_pts"], mask=mask)
        if label == "captured":  # as the solver called it, with its iteration's mask
            sub = captured["ba_backsub"]
        else:
            dxp = torch.as_tensor(sub_rng.normal(0, 1e-3, (inst["wk"], 6)), dtype=torch.float32)
            sub = (acc[7], acc[5], acc[6], dxp.to(dev), mask)
        n = int(inst["n_pts"])
        want = ba_pallas.window_mask(inst["slot"][:, :n], inst["povar"][:, :n], inst["wk"])
        if not (torch.equal(mask[:n], want) and torch.equal(sub[4][:n], want)
                and bool((mask[n:] == 0).all())):
            raise AssertionError(f"ba_accumulate on the {label} instance: its window mask words "
                                 f"differ from the plain window_mask")
        ba_insts[label] = (inst, sub)
    ba_specs = {
        "ba_acc": ("ba_accumulate", lambda i, s: ba_cuda.ba_accumulate(*acc_args(i), n_pts=i["n_pts"]),
                   lambda i, s: ba_pallas.ba_accumulate_plain(*acc_args(i)), "acc",
                   "vo_slam_test_tpu/ops/ba_pallas.py:285"),
        "ba_cost": ("ba_cost", lambda i, s: ba_cuda.ba_cost(*cost_args(i), n_pts=i["n_pts"]),
                    lambda i, s: ba_pallas.ba_cost_plain(*cost_args(i)), "cost",
                    "vo_slam_test_tpu/ops/ba_pallas.py:338"),
        "ba_backsub": ("ba_backsub",
                       lambda i, s: ba_cuda.ba_backsub(*s[:4], n_pts=i["n_pts"], mask=s[4]),
                       lambda i, s: ba_pallas.ba_backsub_plain(*s[:4]), "backsub",
                       "vo_slam_test_tpu/ops/ba_pallas.py:365"),
    }
    for key, (kname, kfn, pfn, kind, replaces) in ba_specs.items():
        err = 0.0
        for label, (inst, sub) in ba_insts.items():
            got, again = kfn(inst, sub), kfn(inst, sub)
            want = pfn(inst, sub)
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in
                       zip(outs, again if isinstance(again, tuple) else (again,))):
                raise AssertionError(f"{kname} on the {label} instance: two launches differ")
            err = max(err, check_ba(f"{kname} on the {label} instance", kind, got,
                                    sub if kind == "backsub" else inst, want))
            if kind == "acc":  # the LM accept test compares this cost with ba_cost's
                cost = ba_cuda.ba_cost(*cost_args(inst), n_pts=inst["n_pts"])
                if not torch.equal(got[4].view(torch.int32), cost.view(torch.int32)):
                    raise AssertionError(f"{kname} on the {label} instance: its cost "
                                         f"{float(got[4])} is not ba_cost's {float(cost)}")
            print(f"phase {kname} {label}: within tolerance of the plain version, two launches "
                  f"bit-equal{', cost bit-equal to ba_cost' if kind == 'acc' else ''}; "
                  f"{ba_counts(inst)}")
        inst, sub = ba_insts["captured"]
        kb, kby, counted = ba_bound(kind, inst)
        O, L = inst["slot"].shape
        timed, note = (lambda: kfn(inst, sub)), ""
        if key == "ba_acc":
            # as the solver runs it: Wc zeroed once per BA call and carried, with
            # the scratch and the mask words, over the call's LM iterations
            wc = torch.zeros((inst["wk"], 18, L), dtype=torch.float32, device=dev)
            scratch, mask = ba_cuda.ba_scratch(inst["wk"], L, dev), ba_cuda.ba_mask(L, dev)
            timed = lambda: ba_cuda.ba_accumulate(  # noqa: E731
                *acc_args(inst), n_pts=inst["n_pts"], wc=wc, scratch=scratch, mask=mask)
            # what is timed is what was checked: the first and a later call on
            # the carried buffers give the fresh-buffer call's bits
            fresh = kfn(inst, sub)
            n = int(inst["n_pts"])
            want = ba_pallas.window_mask(inst["slot"][:, :n], inst["povar"][:, :n], inst["wk"])
            for rep in ("first", "second"):
                carried = timed()
                if not (all(bits_equal(a, b) for a, b in zip(carried, fresh))
                        and torch.equal(mask[:n], want) and bool((mask[n:] == 0).all())):
                    raise AssertionError(f"{kname} on the captured instance: the {rep} call on "
                                         f"the carried Wc, scratch and mask differs from the "
                                         f"call on fresh buffers")
            print(f"  {kname} on the carried buffers: two calls bit-equal to the fresh-buffer "
                  f"call, mask words equal to the plain window_mask")
            note = (f" with the solver's carried Wc (with a fresh Wc zeroed in every call: "
                    f"{time_graph_ms(lambda: kfn(inst, sub)):.4f} ms)")
        kernels[key] = dict(
            name=kname, shape=f"WF={inst['posesT'].shape[1]} wk={inst['wk']} O={O} L={L}",
            route="cuda", source="vo_slam_test_tpu_torch/csrc/ba.cu", replaces=replaces,
            max_abs_err=err, ms=time_graph_ms(timed),
            plain_ms=time_eager_ms(lambda: pfn(inst, sub)),
            bound_ms=kb, bound_by=kby, library_ms=None, counted=counted)
        print(f"  captured: kernel {kernels[key]['ms']:.4f} ms{note}, plain "
              f"{kernels[key]['plain_ms']:.4f} ms, bound {kb:.6f} ms ({kby})")
        # device time of each launch inside the call (torch.profiler kernel events)
        print(f"  device ms per call by kernel: {launch_times_ms(lambda: kfn(inst, sub))}")

    # -- main path 1: FusedTracker -------------------------------------------
    tracker = tracking.FusedTracker(cfg)
    with PlainGuard(plains) as guard:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        frame_ms, wall_ms, syncs = [], [], []
        for gray, depth, ts in frames:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                tracker.track(gray, depth, ts)
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            frame_ms.append(start.elapsed_time(end))
            syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        launches1 = {k: v.launches for k, v in all_kernels.items()}
    traj, stats = tracker.results()
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    ate = ate_rmse(tracker.timestamps, gt, tracker.timestamps, traj)
    n_ok = sum(s.ok for s in stats)
    steady = np.array(frame_ms[1:])
    print(f"main path 1 (FusedTracker): tracked {n_ok}/{len(stats)} frames, ATE {ate * 100:.4f} cm; "
          f"matches/frame {[s.n_matches for s in stats]}")
    print(f"  per-frame ms (CUDA events, frames 1..29): median {np.median(steady):.3f}, "
          f"mean {steady.mean():.3f}, min {steady.min():.3f}, max {steady.max():.3f}; "
          f"frame 0 {frame_ms[0]:.3f}; host wall median {np.median(wall_ms[1:]):.3f}")
    print(f"  host syncs per frame (sync debug mode): {syncs}")
    print(f"  kernel launches: {launches1}; plain versions on CUDA: {guard.cuda_calls}")
    if n_ok != len(frames) or not ate < 0.01:
        raise AssertionError(f"main path 1 failed: {n_ok}/{len(frames)} tracked, ATE {ate} m")
    if launches1["fast"] != 30 or launches1["orb"] != 30 or launches1["top2"] < 29:
        raise AssertionError(f"kernel launch counts off on main path 1: {launches1}")
    if guard.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard.cuda_calls}")

    # host-side stage breakdown of one frame (synchronized around each stage)
    from vo_slam_test_tpu_torch.frontend import extractor

    g1 = torch.as_tensor(frames[1][0]).to(dev)
    d1 = torch.as_tensor(frames[1][1]).to(dev)
    stage_fns = [
        ("build_pyramid", lambda: extractor.build_pyramid(g1, spec)),
        ("select_keypoints", lambda: extractor.select_keypoints(pyr, spec, tracker.budgets)),
        ("_stage_b", lambda: extractor._stage_b(pyr, spec, sel, d1, cam)),
        ("match+solve r=15", lambda: tracking._match_and_solve(
            f1, f0, pts, pts_ok, eye, eye, tracker.scale_factors, tracker.inv_level_sigma2,
            cam, 15.0)),
    ]
    parts = []
    for label, fn in stage_fns:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        parts.append(f"{label} {(time.perf_counter() - t0) * 1e3 / 5:.3f}")
    print("stage wall ms (synchronized): " + ", ".join(parts))

    # -- main path 2: SlamSystem over the room orbit -------------------------
    with PlainGuard(plains) as guard:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        s1, rec1 = run_slice(system, triangulate, room_cfg, room_frames, timed=True)
        launches2 = {k: v.launches for k, v in all_kernels.items()}
        # second run: the determinism check, the epipolar searches the path
        # should launch (counted apart) and a profiler window
        s2, rec2 = run_slice(system, triangulate, room_cfg, room_frames, timed=False,
                             profile_frames=tuple(range(10, 15)))
    traj2, stats2, _ = s1.results()
    gt2 = np.stack([room.poses[i] for i in range(SLICE_FRAMES)])
    ate2 = ate_rmse(s1.timestamps, gt2, s1.timestamps, traj2)
    n_ok2 = sum(s.ok for s in stats2)
    kf_frames = [i for i, o in enumerate(s1._outs) if o.made_kf]
    n_events = len(kf_frames)
    fm = np.array(rec1["frame_ms"])
    map_ms = rec1["map_ms"]
    track_ms = np.array([fm[i] - map_ms.get(i, 0.0) for i in range(1, len(fm))])
    print(f"main path 2 (SlamSystem, room orbit {SLICE_FRAMES} frames 640x480): tracked "
          f"{n_ok2}/{len(stats2)} frames, ATE {ate2 * 100:.4f} cm; keyframe events at frames "
          f"{kf_frames}; live keyframes {s1.n_keyframes}, points {s1.n_points}")
    print(f"  beside the JAX package on the CPU (tools/room_orbit_reference.py --impl jax): "
          f"keyframes at {JAX_CPU_KF_FRAMES}, ATE {JAX_CPU_ATE_CM} cm; LM iterations per event "
          f"(frame, pass 1, pass 2): {s1.ba_iters}")
    print(f"  beside the first design of ba_accumulate (another f32 summation order): the same "
          f"keyframe frames, ATE {FIRST_DESIGN_ATE_CM} cm, LM iterations "
          f"{FIRST_DESIGN_BA_ITERS} ({sum(a + b for _, a, b in FIRST_DESIGN_BA_ITERS)} in all); "
          f"this run differs at "
          f"{[x for x, y in zip(s1.ba_iters, FIRST_DESIGN_BA_ITERS) if tuple(x) != y]}")
    print(f"  per frame (n_features, n_matches, n_inliers): "
          f"{[(s.n_features, s.n_matches, s.n_inliers) for s in stats2]}")
    print(f"  per-frame ms (CUDA events, tracking + mapping): {[round(float(x), 3) for x in fm]}")
    print(f"  frames 1..{SLICE_FRAMES - 1}: median {np.median(fm[1:]):.3f}, mean "
          f"{fm[1:].mean():.3f}; tracking step alone median {np.median(track_ms):.3f}; "
          f"host wall median {np.median(rec1['wall_ms'][1:]):.3f}")
    print(f"  mapping step ms on keyframe frames: "
          f"{ {i: round(v, 3) for i, v in map_ms.items()} }")
    print(f"  host syncs per frame (sync debug mode): {rec1['syncs']}; over the run by the "
          f"line that synced: {rec1['sync_sites']}")
    print(f"  kernel launches: {launches2}; "
          f"epipolar searches past the baseline gate (counted apart): {rec2['epi_expected']}; "
          f"plain versions on CUDA: {guard.cuda_calls}")
    if rec2["profile"] is not None:
        prof, wall = rec2["profile"]
        busy2, nl2 = device_profile(prof, 5, wall)
    if n_ok2 != SLICE_FRAMES or n_events < 5 or not ate2 < 0.01:
        raise AssertionError(f"main path 2 failed: {n_ok2}/{SLICE_FRAMES} tracked, "
                             f"{n_events} keyframe events, ATE {ate2} m")
    if (launches2["fast"] != SLICE_FRAMES or launches2["orb"] != SLICE_FRAMES
            or launches2["top2"] < 1 or launches2["top2_m4096"] < 1
            or launches2["top2_chi2"] != n_events
            or launches2["top2_nb"] != n_events or launches2["top1_epi"] < 1
            or launches2["top1_epi"] != rec2["epi_expected"]):
        raise AssertionError(f"kernel launch counts off on main path 2: {launches2}, "
                             f"{n_events} keyframe events, {rec2['epi_expected']} epipolar searches")
    if guard.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard.cuda_calls}")
    check_ba_launches("main path 2", s1, kf_frames, launches2, set())
    check_same_maps("main path 2", s1, s2)

    # -- main path 3: SlamSystem(chunk=8) over the same frames -----------------
    with PlainGuard(plains) as guard3:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        s3, chunk_ms = run_chunked(system, room_cfg, room_frames, CHUNK)
        launches3 = {k: v.launches for k, v in all_kernels.items()}
        s4, chunk_ms4 = run_chunked(system, room_cfg, room_frames, CHUNK)
    traj3, stats3, _ = s3.results()
    ate3 = ate_rmse(s3.timestamps, gt2, s3.timestamps, traj3)
    n_ok3 = sum(s.ok for s in stats3)
    kf_frames3 = [i for i, o in enumerate(s3._outs) if o.made_kf]
    stops3 = expected_stops([o.made_kf for o in s3._outs], CHUNK)
    print(f"main path 3 (SlamSystem chunk={CHUNK}, the same {SLICE_FRAMES} frames): tracked "
          f"{n_ok3}/{len(stats3)} frames, ATE {ate3 * 100:.4f} cm; keyframe events at frames "
          f"{kf_frames3}, BA skipped by a later keyframe of the chunk at {sorted(stops3)}; live "
          f"keyframes {s3.n_keyframes}, points {s3.n_points}")
    print(f"  LM iterations per event (frame, pass 1, pass 2): {s3.ba_iters}")
    print(f"  per-chunk wall ms (track + map {CHUNK} frames, synchronized): "
          f"{[round(x, 3) for x in chunk_ms]}; second run {[round(x, 3) for x in chunk_ms4]}")
    print(f"  kernel launches: {launches3}; plain versions on CUDA: {guard3.cuda_calls}")
    if n_ok3 != SLICE_FRAMES or len(kf_frames3) < 5 or not ate3 < 0.01:
        raise AssertionError(f"main path 3 failed: {n_ok3}/{SLICE_FRAMES} tracked, "
                             f"{len(kf_frames3)} keyframe events, ATE {ate3} m")
    if (launches3["top2_chi2"] != len(kf_frames3) or launches3["top2_nb"] != len(kf_frames3)
            or launches3["fast"] != SLICE_FRAMES):
        raise AssertionError(f"kernel launch counts off on main path 3: {launches3}")
    if guard3.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard3.cuda_calls}")
    check_ba_launches("main path 3", s3, kf_frames3, launches3, stops3)
    check_same_maps("main path 3", s3, s4)

    for k in ("fast", "orb", "top2"):
        kernels[k]["launches"] = launches1[k]
    for k in ("top2_m4096", "top2_chi2", "top2_nb", "top1_epi") + ba_keys:
        kernels[k]["launches"] = launches2[k]
    # ba_accumulate is two launches in a row, the others one
    for k, v in kernels.items():
        v["launch_floor_x"] = v["ms"] / floor["launches_2" if k == "ba_acc" else "launches_1"]
    under = {k: (v["ms"], v["bound_ms"]) for k, v in kernels.items() if v["ms"] < v["bound_ms"]}
    if under:
        raise AssertionError(f"kernels timed under their bounds, so the bounds are wrong: {under}")
    keys = ("name", "shape", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "v1_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launch_floor_x",
            "counted")
    print(f"total {time.perf_counter() - t_start:.1f} s after the card query")
    print(json.dumps({"main_path": {
        "fused_tracker": {"frame_ms_median": float(np.median(steady)), "ate_m": float(ate),
                          "host_syncs": syncs},
        "slam_system": {"frame_ms_median": float(np.median(fm[1:])),
                        "tracking_ms_median": float(np.median(track_ms)),
                        "mapping_ms": {str(i): v for i, v in map_ms.items()},
                        "ate_m": float(ate2), "keyframe_frames": kf_frames,
                        "ba_iters": s1.ba_iters, "host_syncs": rec1["syncs"]},
        "slam_system_chunk8": {"chunk_ms": chunk_ms, "ate_m": float(ate3),
                               "keyframe_frames": kf_frames3, "ba_iters": s3.ba_iters,
                               "launches": launches3},
        "card": smi}}))
    order = ("fast", "orb", "top2", "top2_m4096", "top2_chi2", "top2_nb", "top1_epi") + ba_keys
    print(json.dumps({"kernels": [{key: kernels[k][key] for key in keys if key in kernels[k]}
                                  for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
