#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vo_slam_test_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card and its power limit;
2. builds the CUDA kernels from ``vo_slam_test_tpu_torch/csrc`` with nvcc
   (sm_90a, one nvcc per source, all started together) and times the launch
   floor: an empty kernel, and two in a row (``launch_floor_ms``);
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times both with CUDA events:
   - FAST on a frame's [8,480,640] pyramid; its 3x3-NMS mode (no path calls
     it) on that pyramid and on a random [2,480,640] batch, each equal to the
     plain version on every pixel and to its first design
     (``perf/fast_nms_v1.cu``) bit for bit, the two timed in turns; IC angle
     + rBRIEF on its 1024 keypoints, Hamming top-2 at 1024x1024 on a real
     frame pair and on a seeded instance with ties and empty rows;
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
7. main path 4, the kidnap: ``SlamSystem(vocabulary=...)`` (loop closing on,
   the default) over the reference's relocalization scenario at 640x480
   (tests/test_reloc.py: frames 0-7 of SyntheticRGBD(n_frames=12, seed=31,
   motion_scale=0.3), three black frames, frames 2-5 again; MapCaps(max_kf=32,
   max_pt=8192)) with the scene vocabulary build_vocabulary(k=8, levels=3,
   seed=2) of the port's extract_fused descriptors of frames 0-2, in three
   variants counted together: default, depth-poor return frames (EPnP) and
   ``reloc_parity=True``. Each must track frames 0-7, lose 8-10, first
   relocalize at frame >= 11 with the recovered pose within 5 cm of the same
   view's phase-1 estimate, and close no loop; parity mode relocalizes on the
   default's frame; a second default run gives identical maps; every kernel
   is launched. Every epipolar search of the path (live featVec groups) and
   FAST and the top-2 on the black frames are held bit for bit against their
   plain versions. Then transform, bow_vector and scores_vs_keyframes at
   ORBvoc scale (synth_vocabulary(k=10, levels=6), 10^6 words) on one frame's
   1000 descriptors against the CPU's results;
8. main path 5, the pan loop of tests/test_loop_e2e.py at 640x480 (60 frames,
   SyntheticRGBD(seed=41), camera_fps=3, MapCaps(max_kf=32, max_pt=8192),
   the vocabulary build_vocabulary(k=8, levels=3, seed=3) of the port's
   extract_fused descriptors of seven frames) with the drift se3(tx=0.5,
   ty=0.2, ry=-0.08) injected after frame 27 by ``inject_drift``, then the
   old side severed too (``pan_sever_old``), in three variants: chunk=4,
   chunk=1, chunk=4 with global BA. Each
   must track > 90% of frames, close exactly one loop, set loop edges and
   bring the island keyframes' median residual against their pre-drift
   poses under 0.35 |t_D|; two runs of the chunk=4 variant with global BA
   give identical maps; every loop-fuse launch of the chi2 top-2 is held bit for bit against
   the plain version; the chunk=4 run with the JAX package's own (one-sided)
   instrument must reproduce the JAX package's CPU outcome (no closure);
   then global BA on tests/test_global_ba.py's fabricated scene (gba_scene),
   where its steps are taken, at the tests' caps (the card against the CPU
   within 1e-5) and at the default MapCaps: two calls identical, the robust
   cost lower, every keyframe within 1 cm of the truth; timed;
9. main path 6, the CLI on files: ``run_slam.main`` in this process on a TUM
   directory written here (path 2's 40 frames as zlib PNGs, gray as R=G=B and
   depth as round(d*5000) u16, with a ``configs/tum_fr1.yaml``-keyed config):
   the frames must decode to the written ones; ``--slam`` with every output
   flag (HUD and map render only where PIL / matplotlib are installed) must
   track 40/40 with >= 5 keyframe events and ATE < 1 cm from the written
   trajectory, and its outputs must read back; ``--slam --vocabulary <that
   vocabulary> --chunk 4`` must track 40/40; the first run's map is saved,
   loaded (fields equal) and resumed one frame (ok); ``--synthetic --frames
   30 --sync`` (FrameToFrameTracker) must keep every frame ok with >= 100
   matches and >= 50 inliers from frame 1 and ATE < 3 cm; ``--synthetic
   --frames 30`` must track 30/30; FAST, ORB and the frame-pair top-2 must be
   launched. Per run: frame ms, decode ms, host quad-tree ms and host syncs a
   frame and the reader that served. Then the host-path ``OrbExtractor`` on
   the card against the CPU on path 1's frame 0 (every field equal, angles
   within 1e-3 deg);
10. main path 7, the off-nominal regimes. 7a: ``SlamSystem`` (no vocabulary,
   MapCaps(max_kf=32, max_pt=8192)) at 640x480 over the JAX package's moving
   object (SyntheticRGBD(n_frames=12, seed=41, motion_scale=0.5,
   moving_patch=(0.9, 0.06)), tests/test_scenarios.py), sparse texture
   (n_frames=12, seed=43, motion_scale=0.4, texture_corners=0.06) and
   Milestone B (n_frames=10, seed=21, motion_scale=0.5, tests/test_system.py),
   held to those tests' gates (every frame ok; ATE < 4 cm, < 2 cm for
   Milestone B; moving object: median inliers > 80, a rejection > 20; sparse
   texture: median matches < 600, a keyframe; Milestone B: > 300 points,
   median inliers > 100), every kernel of the path launched, each BA kernel
   once per LM iteration, a second moving-object run giving identical maps,
   and every top-2 launch of the moving-object run bit-equal to the plain
   version; frame median and host syncs per frame recorded. 7b: local BA past
   every cap on tests/test_local_ba_saturation.py's seed-3 dense map, built on
   the card by ``datasets/synth_map.build``: the
   window keeps the strongest covisibles, observers valid-first, one
   ``local_bundle_adjust`` at least halves the window's reprojection error and
   moves nothing outside its problem, and rows 7-9 on its first LM iteration
   are held against their plain versions (``check_ba``) and timed with their
   live-point bounds (``saturated_window`` in the kernels line);
11. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line. Every bound is computed from this run's inputs and counts the work
   the function needs, whatever computes it; a kernel timed under its bound
   fails the run (the bound is then wrong). No plain version may see a CUDA
   tensor on any main path. Any
   failed check raises: the exit code is then non-zero and no result line is
   printed. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
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


# the 3x3-NMS mode adds, per pair of live pixels: 8 packed compares against the
# neighbours' scores, 7 ands of the results and 1 select
FAST_NMS_PAIR_OPS = {"alu": 8 + 7 + 1}


def fast_bound(levels, nms: bool = False):
    """Bound of one FAST launch from this run's input: bytes for every pixel
    read once and its score written once; operations only for the pixels
    whose score can be non-zero (``fast_live_pixels``), two to a word, at the
    fewest instructions the card's instruction set needs (FAST_PAIR_OPS, and
    with ``nms`` the comparison's FAST_NMS_PAIR_OPS: a pixel whose score is 0
    writes 0 whatever its neighbours hold). -> (ms, bound_by, counts)."""
    n, live = levels.numel(), fast_live_pixels(levels)
    ops = {k: v + (FAST_NMS_PAIR_OPS.get(k, 0) if nms else 0) for k, v in FAST_PAIR_OPS.items()}
    ms, by = bound_ms(8 * n, {k: v * ((live + 1) // 2) for k, v in ops.items()})
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


def ba_acc_args(inst):
    """``ba_accumulate``'s positional arguments from a BA instance dict."""
    return (inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"],
            inst["ur"], inst["isig2"], inst["act"], inst["povar"], inst["cam5"], inst["wk"],
            inst["huber"])


def ba_cost_args(inst):
    return ba_acc_args(inst)[1:9] + (inst["cam5"], inst["huber"])


def ba_kernel_specs(ba_cuda, ba_pallas):
    """Rows 7-9: {key: (name, kernel call, plain call, check kind, TPU kernel)};
    each call takes (instance, back-substitution arguments)."""
    return {
        "ba_acc": ("ba_accumulate",
                   lambda i, s: ba_cuda.ba_accumulate(*ba_acc_args(i), n_pts=i["n_pts"]),
                   lambda i, s: ba_pallas.ba_accumulate_plain(*ba_acc_args(i)), "acc",
                   "vo_slam_test_tpu/ops/ba_pallas.py:285"),
        "ba_cost": ("ba_cost", lambda i, s: ba_cuda.ba_cost(*ba_cost_args(i), n_pts=i["n_pts"]),
                    lambda i, s: ba_pallas.ba_cost_plain(*ba_cost_args(i)), "cost",
                    "vo_slam_test_tpu/ops/ba_pallas.py:338"),
        "ba_backsub": ("ba_backsub",
                       lambda i, s: ba_cuda.ba_backsub(*s[:4], n_pts=i["n_pts"], mask=s[4]),
                       lambda i, s: ba_pallas.ba_backsub_plain(*s[:4]), "backsub",
                       "vo_slam_test_tpu/ops/ba_pallas.py:365"),
    }


def hold_ba(ba_cuda, spec, where, inst, sub) -> float:
    """One BA kernel (a ``ba_kernel_specs`` entry) on an instance: two launches
    bit-equal, within ``check_ba``'s tolerances of the plain version, and for
    the accumulate its cost bit-equal to ``ba_cost``'s (the LM accept test
    compares the two) -> max |kernel - plain|."""
    kname, kfn, pfn, kind, _ = spec
    got, again = kfn(inst, sub), kfn(inst, sub)
    want = pfn(inst, sub)
    torch.cuda.synchronize()
    outs = got if isinstance(got, tuple) else (got,)
    if not all(bits_equal(a, b) for a, b in
               zip(outs, again if isinstance(again, tuple) else (again,))):
        raise AssertionError(f"{kname} on {where}: two launches differ")
    err = check_ba(f"{kname} on {where}", kind, got, sub if kind == "backsub" else inst, want)
    if kind == "acc":
        cost = ba_cuda.ba_cost(*ba_cost_args(inst), n_pts=inst["n_pts"])
        if not bits_equal(got[4], cost):
            raise AssertionError(f"{kname} on {where}: its cost {float(got[4])} is not "
                                 f"ba_cost's {float(cost)}")
    return err


def ba_carried_acc(ba_cuda, ba_pallas, inst, fresh, dev, where):
    """``ba_accumulate`` as the solver runs it: ``Wc`` zeroed once per BA call
    and carried, with the scratch and the mask words, over the call's LM
    iterations. What is timed is what was checked: the first and a later call
    on the carried buffers give the bits of ``fresh`` (the call on fresh
    buffers) -> the carried call."""
    L = inst["slot"].shape[1]
    wc = torch.zeros((inst["wk"], 18, L), dtype=torch.float32, device=dev)
    scratch, mask = ba_cuda.ba_scratch(inst["wk"], L, dev), ba_cuda.ba_mask(L, dev)
    timed = lambda: ba_cuda.ba_accumulate(  # noqa: E731
        *ba_acc_args(inst), n_pts=inst["n_pts"], wc=wc, scratch=scratch, mask=mask)
    n = int(inst["n_pts"])
    want = ba_pallas.window_mask(inst["slot"][:, :n], inst["povar"][:, :n], inst["wk"])
    for rep in ("first", "second"):
        carried = timed()
        if not (all(bits_equal(a, b) for a, b in zip(carried, fresh))
                and torch.equal(mask[:n], want) and bool((mask[n:] == 0).all())):
            raise AssertionError(f"ba_accumulate on {where}: the {rep} call on the carried Wc, "
                                 f"scratch and mask differs from the call on fresh buffers")
    print(f"  ba_accumulate on the carried buffers ({where}): two calls bit-equal to the "
          f"fresh-buffer call, mask words equal to the plain window_mask")
    return timed


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
# the first designs of rows 1b and 2-6, built beside the current kernels and timed
# with them (perf/kernel_split.py takes them apart)
V1_SOURCES = (("orb_v1", PERF_DIR), ("match_v1", PERF_DIR), ("epi_v1", PERF_DIR),
              ("fast_nms_v1", PERF_DIR))


def fast_nms_v1_launcher(_build):
    """The first design of the FAST kernel's 3x3-NMS mode
    (``perf/fast_nms_v1.cu``), a callable taking ``fast_cuda.KERNEL_NMS``'s
    arguments; ``fast_call`` launches either."""
    from vo_slam_test_tpu_torch.ops import fast_cuda

    fn = ctypes.CDLL(str(_build.library_path("fast_nms_v1", PERF_DIR))).fast_score_nms_v1_launch
    fn.argtypes = fast_cuda.KERNEL_NMS.argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"fast_score_nms_v1_launch: cudaError {rc}")
    return call


def fast_call(kernel, levels):
    """Launch ``kernel`` (``fast_cuda.KERNEL_NMS``, the first design or a
    build variant) on a [L,H,W] batch as ``fast_cuda.fast_score`` does ->
    [L,H,W] f32."""
    out = torch.empty(levels.shape, dtype=torch.float32, device=levels.device)
    kernel(levels.data_ptr(), levels.stride(0), levels.stride(1), out.data_ptr(), *levels.shape,
           torch.cuda.current_stream().cuda_stream)
    return out


def fast_nms_random_levels(device):
    """The NMS phase's second input: a [2,480,640] batch of seeded integers
    in [0, 255] (many ties; every block live)."""
    return torch.as_tensor(np.random.default_rng(11).integers(
        0, 256, (2, 480, 640)).astype(np.float32)).to(device)


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


# the FAST kernel's 3x3-NMS mode runs in its own phase only: no path calls it
OFF_PATH = ("fast_nms",)


def kernel_counters() -> dict:
    """Every kernel's launch counter by its key in the kernels line."""
    from vo_slam_test_tpu_torch.ops import ba_cuda, fast_cuda, match_cuda, orb_cuda

    return {"fast": fast_cuda.KERNEL, "orb": orb_cuda.KERNEL, "top2": match_cuda.KERNEL,
            "top2_m4096": match_cuda.KERNEL_LOCAL, "top2_chi2": match_cuda.KERNEL_CHI2,
            "top2_nb": match_cuda.KERNEL_NB, "top1_epi": match_cuda.KERNEL_EPI,
            "ba_acc": ba_cuda.KERNEL_ACC, "ba_cost": ba_cuda.KERNEL_COST,
            "ba_backsub": ba_cuda.KERNEL_BACKSUB, "fast_nms": fast_cuda.KERNEL_NMS}


def plain_versions() -> list:
    """(module, name) of every kernel's plain version, for ``PlainGuard``."""
    from vo_slam_test_tpu_torch.ops import ba_pallas, brief, fast, match_pallas, orientation

    return [(fast, "fast_score"), (fast, "fast_score_nms"), (orientation, "ic_angle"),
            (brief, "compute_descriptors"),
            (match_pallas, "masked_top2_plain"), (match_pallas, "masked_top2_nb_plain"),
            (match_pallas, "masked_top1_epi_plain"), (ba_pallas, "ba_accumulate_plain"),
            (ba_pallas, "ba_cost_plain"), (ba_pallas, "ba_backsub_plain")]


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


class BaCapture:
    """Wraps the local-BA kernel wrappers and keeps a copy of the first LM
    iteration of the BA with the most live points: the accumulate call's
    arguments and the first back-substitution whose pose step is finite (a
    Cholesky of an indefinite system gives NaN), with the mask words of its
    iteration. ``instance()`` -> (the accumulate inputs as a dict in
    ``random_ba_instance``'s layout, the back-substitution arguments)."""

    NAMES = ("ba_accumulate", "ba_backsub", "ba_cost")

    def __init__(self, ba_cuda):
        self.ba_cuda = ba_cuda
        self.best = {"n": -1}
        self.orig = {}

    def __enter__(self):
        best = self.best
        for name in self.NAMES:
            fn = self.orig[name] = getattr(self.ba_cuda, name)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                keep = lambda a: a.clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
                if _name == "ba_accumulate":
                    n = int(kw["n_pts"])
                    if n > best["n"]:
                        best.clear()
                        best.update(n=n, acc=([keep(a) for a in args], keep(kw["n_pts"])))
                elif (_name == "ba_backsub" and "acc" in best and "sub" not in best
                      and bool(torch.isfinite(args[3]).all())):
                    best["sub"] = [keep(a) for a in args[:4]] + [keep(kw["mask"])]
                return _fn(*args, **kw)
            setattr(self.ba_cuda, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ba_cuda, name, fn)

    def instance(self):
        if "sub" not in self.best:
            raise AssertionError(f"no full LM iteration was captured ({sorted(self.best)})")
        (lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk, huber), n_pts = \
            self.best["acc"]
        return (dict(lam=lam, posesT=posesT, X=X, slot=slot, u=u, v=v, ur=ur, isig2=isig2,
                     act=act, povar=povar, cam5=cam5, wk=wk, huber=huber, n_pts=n_pts),
                self.best["sub"])


def capture_instances(match_cuda, ba_cuda, system, cfg, frames):
    """Drive the SlamSystem path over ``frames`` and keep a copy of the
    arguments of the local-map top-2 (M=4096), chi2 top-2,
    neighbour-batched and epipolar call whose search found the most rows
    with an allowed pair, and of the first LM iteration (accumulate,
    back-substitution, cost) of the local BA with the most live points."""
    got, score = {}, {}
    names = ("masked_top2", "masked_top2_nb", "masked_top1_epi")
    orig = {n: getattr(match_cuda, n) for n in names}

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

    for n in names:
        setattr(match_cuda, n, recorder(n))
    try:
        with BaCapture(ba_cuda) as cap:
            s = system.SlamSystem(cfg)
            for f in frames:
                s.track(*f)
            torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(match_cuda, n, fn)
    missing = {"top2_m4096", "top2_chi2", "top2_nb", "top1_epi"} - set(got)
    if missing:
        raise AssertionError(f"the capture run launched no {sorted(missing)}")
    # the batched search shares one source set across neighbours: time it as
    # the path passes it (stride 0)
    args, kw = got["top2_nb"]
    args[0] = args[0][0][None].expand_as(args[0])
    got["ba"], got["ba_backsub"] = cap.instance()
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

    def timed_bg(m, loop_state, did_kf, kf_id, *a, **k):
        if not did_kf:
            return orig_bg(m, loop_state, did_kf, kf_id, *a, **k)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_bg(m, loop_state, did_kf, kf_id, *a, **k)
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


def kidnap_sequence():
    """Main path 4's sequence and config: the reference's kidnap scenario
    (tests/test_reloc.py:38-57) at 640x480, 1000 features, 8 levels."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD

    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    return seq, cfg


def kidnap_frames(seq, depth_poor: bool):
    """Frames 0-7 tracked, three black frames (sensor dropout), then frames
    2-5 again (a return to a mapped view), without depth when ``depth_poor``
    -> 15 (gray, depth, timestamp)."""
    H, W = seq.height, seq.width
    black_g, no_depth = np.zeros((H, W), np.uint8), np.zeros((H, W), np.float32)
    return ([seq[i] for i in range(8)] + [(black_g, no_depth, 8.0 + j) for j in range(3)]
            + [(seq[i][0], no_depth if depth_poor else seq[i][1], 20.0 + i) for i in range(2, 6)])


def kidnap_vocabulary(seq, cfg, device):
    """The scene vocabulary of main path 4: build_vocabulary(k=8, levels=3,
    seed=2) over the port's extract_fused descriptors of frames 0-2 (the
    reference's test builds it from its host OrbExtractor, not ported)."""
    from vo_slam_test_tpu_torch.bow.vocabulary import build_vocabulary
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
    from vo_slam_test_tpu_torch.pipeline import tracking

    tr = tracking.FusedTracker(cfg, device=device)
    descs = []
    for i in range(3):
        g, d, _ = seq[i]
        f = extract_fused(torch.as_tensor(g).to(device), torch.as_tensor(d).to(device),
                          tr.camera, tr.spec, tr.budgets)
        descs.append(f.desc[f.valid].cpu().numpy())
    return build_vocabulary(np.concatenate(descs), k=8, levels=3, seed=2, device=device)


def run_kidnap(system, cfg, voc, frames, parity: bool, recorder=None, profile_frames=()):
    """One SlamSystem run over the kidnap frames with the vocabulary (loop
    closing on, the default), through ``run_timed``."""
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    s = system.SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc,
                          reloc_parity=parity)
    return s, run_timed(s, frames, recorder, profile_frames)


def run_timed(s, frames, recorder=None, profile_frames=()):
    """``s.track`` over ``frames``: CUDA events per frame and host syncs per
    frame (sync debug mode); ``recorder`` (a LaunchRecorder) learns the frame;
    a torch.profiler window over ``profile_frames`` (consecutive) ->
    rec["profile"] = (profiler, host wall ms per frame)."""
    from torch.profiler import ProfilerActivity, profile

    rec = dict(frame_ms=[], syncs=[], sync_sites={}, profile=None)
    prof = None
    for i, (gray, depth, ts) in enumerate(frames):
        if recorder is not None:
            recorder.frame = i
        if profile_frames and i == profile_frames[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            s.track(gray, depth, ts)
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        torch.cuda.synchronize()
        rec["frame_ms"].append(start.elapsed_time(end))
        sync_ws = [w for w in caught if "synchroniz" in str(w.message)]
        rec["syncs"].append(len(sync_ws))
        for w in sync_ws:
            site = f"{w.filename.split('vo_slam_test_tpu_torch/')[-1]}:{w.lineno}"
            rec["sync_sites"][site] = rec["sync_sites"].get(site, 0) + 1
        if prof is not None and i == profile_frames[-1]:
            wall = (time.perf_counter() - t_prof) * 1e3 / len(profile_frames)
            prof.__exit__(None, None, None)
            rec["profile"], prof = (prof, wall), None
    return rec


def kidnap_report(label, s, rec):
    """Print main path 4's per-variant numbers and hold it to the reference's
    asserts (tests/test_reloc.py:59-72): frames 0-7 tracked, 8-10 lost, the
    first relocalization at frame >= 11, the recovered pose within 5 cm of
    the same frame's phase-1 estimate; with loop closing on, no loop closes
    (the kidnap keeps fewer than MIN_KF_GAP keyframes) -> the numbers."""
    traj, stats, _ = s.results()
    oks = [st.ok for st in stats]
    reloc = s.reloc_frames
    fm = np.array(rec["frame_ms"])
    lost = [i for i, ok in enumerate(oks) if not ok]
    tracked = [i for i, ok in enumerate(oks) if ok and i not in reloc and i > 0]
    first_ok = 11 + oks[11:].index(True) if any(oks[11:]) else None
    rel = (float(np.linalg.norm(traj[first_ok][:3, 3] - traj[first_ok - 9][:3, 3]))
           if first_ok is not None else float("nan"))
    print(f"  {label}: frames ok {sum(oks)}/{len(oks)} {[int(o) for o in oks]}; lost {lost}; "
          f"reloc_frames {reloc}; recovered pose {rel * 100:.4f} cm from the phase-1 estimate "
          f"of the same view")
    print(f"    per frame (n_features, n_matches, n_inliers): "
          f"{[(x.n_features, x.n_matches, x.n_inliers) for x in stats]}; keyframe events at "
          f"{[i for i, o in enumerate(s._outs) if o.made_kf]}; LM iterations {s.ba_iters}")
    print(f"    winning candidate (slot, n_bow, n_ransac, n_obs) per relocalization attempt: "
          f"{ {i: o.reloc_winner for i, o in enumerate(s._outs) if o.reloc_winner} }")
    print(f"    frame ms (CUDA events): tracked median {np.median(fm[tracked]):.3f} "
          f"({len(tracked)} frames), lost {[round(float(fm[i]), 3) for i in lost]}, relocalized "
          f"{[round(float(fm[i]), 3) for i in reloc]}, frame 0 {fm[0]:.3f}")
    print(f"    host syncs per frame: {rec['syncs']}; by the line that synced: {rec['sync_sites']}")
    print(f"    loop closing: closures {s.loop_closures}, attempts {s.loop_attempts}")
    if not (all(oks[:8]) and not any(oks[8:11]) and reloc and reloc[0] >= 11 and rel < 0.05
            and not s.loop_closures and not s.loop_attempts):
        raise AssertionError(f"main path 4 ({label}) failed: ok {oks}, reloc_frames {reloc}, "
                             f"recovered pose {rel} m from the phase-1 estimate, loop closures "
                             f"{s.loop_closures}")
    return dict(oks=oks, reloc=reloc, rel_m=rel, frame_ms=rec["frame_ms"], syncs=rec["syncs"],
                tracked_ms_median=float(np.median(fm[tracked])),
                lost_ms=[float(fm[i]) for i in lost], reloc_ms=[float(fm[i]) for i in reloc],
                winners={str(i): o.reloc_winner for i, o in enumerate(s._outs) if o.reloc_winner})


PAN_VOC_FRAMES = (0, 6, 12, 20, 26, 36, 50)
# the JAX package's SlamSystem over main path 5 on the CPU, chunk=4, with the
# vocabulary this script builds on the card and its own (one-sided) drift
# instrument (perf/loop_path5_jax_cpu.py --voc): no closure, the one Sim3
# attempt (frame, winner, accepted) rejected
JAX_CPU_PAN_ONE_SIDED = dict(closures=[], attempts=[(36, -1, False)])
PAN_CUT_FRAME, PAN_DRIFT_FRAME = 19, 27  # tests/test_loop_e2e.py's hooks
PAN_CHUNK = 4


def se3(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0) -> np.ndarray:
    """[4,4] f32 exp of the twist (translation, rotation), on the CPU."""
    from vo_slam_test_tpu_torch import lie

    xi = torch.tensor([tx, ty, tz, rx, ry, rz], dtype=torch.float32)
    return lie.se3_exp(xi).numpy()


def pan_trajectory() -> np.ndarray:
    """tests/test_loop_e2e.py::pan_trajectory (60 T_w_c): recede from the back
    wall under a small sweep, pan onto the side wall until the start view has
    left the frustum, pan back, keep receding over the old wall."""
    settle = [se3(tx=0.12 * np.sin(0.8 * i), ty=0.1 * np.sin(1.3 * i),
                  tz=-0.15 * i, ry=0.05 * np.sin(1.1 * i)) for i in range(14)]
    z0 = -0.15 * 13
    yaws = ([0.1 + 0.133 * i for i in range(12)] + [1.7] * 4
            + [1.7 - 0.133 * i for i in range(12)] + [0.1 - 0.02 * i for i in range(4)])
    pan = [se3(tx=0.05 * np.sin(3 * y), tz=z0, ry=y) for y in yaws]
    home = [se3(tx=0.1 * np.sin(0.9 * i + 2), ty=0.1 * np.sin(1.1 * i),
                tz=z0 - 0.15 * (i + 1), ry=0.04 * np.sin(1.3 * i)) for i in range(14)]
    return np.stack(settle + pan + home)


def pan_drift() -> np.ndarray:
    """The drift the loop must undo: larger than every search window."""
    return se3(tx=0.5, ty=0.2, ry=-0.08)


def pan_sequence():
    """Main path 5's sequence and config: tests/test_loop_e2e.py's pan loop at
    640x480 (corner scene, seed 41, 60 frames, 1000 features, 8 levels) with
    camera_fps=3 (a small frame gap keeps the keyframe cadence up)."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD

    seq = SyntheticRGBD(seed=41, trajectory=pan_trajectory())
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=3)
    return seq, cfg


def pan_vocabulary(seq, cfg, device):
    """The scene vocabulary of main path 5: build_vocabulary(k=8, levels=3,
    seed=3) over the port's extract_fused descriptors of PAN_VOC_FRAMES (the
    reference's test builds it from its host OrbExtractor, not ported)."""
    from vo_slam_test_tpu_torch.bow.vocabulary import build_vocabulary
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
    from vo_slam_test_tpu_torch.pipeline import tracking

    tr = tracking.FusedTracker(cfg, device=device)
    descs = []
    for i in PAN_VOC_FRAMES:
        g, d, _ = seq[i]
        f = extract_fused(torch.as_tensor(g).to(device), torch.as_tensor(d).to(device),
                          tr.camera, tr.spec, tr.budgets)
        descs.append(f.desc[f.valid].cpu().numpy())
    return build_vocabulary(np.concatenate(descs), k=8, levels=3, seed=3, device=device)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def pan_sever_old(m, kf_cut: int) -> dict:
    """Main path 5's second sever, applied to the map after ``inject_drift``
    (either package's): old keyframes' bindings to island points and their
    observer entries on those points cleared, the observer counts lowered to
    match. ``inject_drift`` severs the island side only; the old side's links
    are points that the first island keyframes triangulated with old ones,
    and through them a later keyframe becomes covisible with old keyframes,
    so that local BA pulls the island back before any loop is detected
    (PERF.md §6). Island membership is ``inject_drift``'s, which leaves
    kf_seq, kf_valid, pt_ref_kf and pt_valid as they were. -> the new
    kf_mp, pt_obs_kf, pt_obs_kp, pt_obs_cnt as numpy arrays, for the
    caller's ``m.replace``."""
    K, P = m.kf_valid.shape[0], m.pt_valid.shape[0]
    seq, valid = _host(m.kf_seq), _host(m.kf_valid)
    kf_sel = (seq >= seq[min(max(int(kf_cut), 0), K - 1)]) & valid
    ref = _host(m.pt_ref_kf)
    pt_sel = (ref >= 0) & kf_sel[np.clip(ref, 0, K - 1)] & _host(m.pt_valid)
    kf_mp = _host(m.kf_mp)
    cut = ~kf_sel[:, None] & (kf_mp >= 0) & pt_sel[np.clip(kf_mp, 0, P - 1)]
    obs = _host(m.pt_obs_kf)
    cross = (obs >= 0) & ~kf_sel[np.clip(obs, 0, K - 1)] & pt_sel[:, None]
    cnt = _host(m.pt_obs_cnt)
    return dict(kf_mp=np.where(cut, -1, kf_mp).astype(kf_mp.dtype),
                pt_obs_kf=np.where(cross, -1, obs).astype(obs.dtype),
                pt_obs_kp=np.where(cross, -1, _host(m.pt_obs_kp)).astype(obs.dtype),
                pt_obs_cnt=np.maximum(cnt - cross.sum(1), 0).astype(cnt.dtype))


def island_residual(pre_poses, pre_valid, kf_cut, final_poses) -> np.ndarray:
    """Per island keyframe (live before the drift, slot >= kf_cut): the
    distance between its final translation and its pre-drift one."""
    island = pre_valid.copy()
    island[:kf_cut] = False
    return np.linalg.norm(final_poses[island][:, :3, 3] - pre_poses[island][:, :3, 3], axis=1)


def gba_scene(caps, device, n_kf=6, n_pt=400, noise_px=0.3, pose_noise=0.03, pt_noise=0.05,
              seed=3):
    """tests/test_local_ba.py::fabricate_map with the arguments of
    tests/test_global_ba.py::test_recovers_geometry, in a port MapState of
    ``caps``: n_pt points seen by n_kf keyframes (half of the observations
    stereo), every pose but keyframe 0's and every point perturbed -> (map,
    ground-truth poses [n_kf,4,4], camera)."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.slam_map.map_state import empty_map

    def exp(xi):
        return lie.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()

    rng = np.random.default_rng(seed)
    cam = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                        camera_k3=0), device)
    fx, fy, cx, cy, bf = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                          float(cam.bf))
    gt_pts = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 6.0], size=(n_pt, 3)).astype(np.float32)
    gt_poses = []
    for _ in range(n_kf):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.uniform(-0.3, 0.3, 3)
        xi[3:] = rng.uniform(-0.05, 0.05, 3)
        gt_poses.append(exp(xi))
    gt_poses = np.stack(gt_poses)
    m = empty_map(caps, "cpu")
    md = {f: getattr(m, f).numpy().copy() for f in (
        "kf_pose kf_valid kf_uv_und kf_octave kf_u_right kf_depth kf_kp_valid kf_mp "
        "pt_pos pt_valid pt_obs_kf pt_obs_kp pt_obs_cnt covis".split())}
    for k in range(n_kf):
        T = gt_poses[k]
        pc = gt_pts @ T[:3, :3].T + T[:3, 3]
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, noise_px, n_pt)
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, noise_px, n_pt)
        vis = (pc[:, 2] > 0.2) & (u > 5) & (u < 635) & (v > 5) & (v < 475)
        md["kf_pose"][k] = T
        md["kf_valid"][k] = True
        for slot, p in enumerate(np.nonzero(vis)[0][:caps.n_feat]):
            md["kf_uv_und"][k, slot] = (u[p], v[p])
            md["kf_octave"][k, slot] = 0
            stereo = rng.uniform() < 0.5
            md["kf_u_right"][k, slot] = ((u[p] - bf / pc[p, 2] + rng.normal(0, noise_px))
                                         if stereo else -1.0)
            md["kf_depth"][k, slot] = pc[p, 2] if stereo else -1.0
            md["kf_kp_valid"][k, slot] = True
            md["kf_mp"][k, slot] = p
            cnt = md["pt_obs_cnt"][p]
            if cnt < caps.max_obs:
                md["pt_obs_kf"][p, cnt] = k
                md["pt_obs_kp"][p, cnt] = slot
            md["pt_obs_cnt"][p] += 1
    md["pt_pos"][:n_pt] = gt_pts + rng.normal(0, pt_noise, (n_pt, 3))
    md["pt_valid"][:n_pt] = True
    md["covis"][:n_kf, :n_kf] = 200
    np.fill_diagonal(md["covis"], 0)
    for k in range(1, n_kf):
        xi = np.concatenate([rng.normal(0, pose_noise, 3),
                             rng.normal(0, pose_noise / 2, 3)]).astype(np.float32)
        md["kf_pose"][k] = exp(xi) @ md["kf_pose"][k]
    m = m.replace(n_kf=torch.tensor(n_kf, dtype=torch.int32),
                  n_pt=torch.tensor(n_pt, dtype=torch.int32),
                  **{f: torch.as_tensor(v) for f, v in md.items()})
    m = m.replace(**{f.name: getattr(m, f.name).to(device)
                     for f in dataclasses.fields(m)})
    return m, gt_poses, cam


def gba_cost(m, cam, inv_level_sigma2=None):
    """The robust cost global BA minimises (solvers/global_ba.py), in
    float64, over the map's bound observations -> (cost, observations)."""
    from vo_slam_test_tpu_torch.solvers import global_ba as G
    from vo_slam_test_tpu_torch.solvers.pose_only import CHI2_MONO, CHI2_STEREO

    o_kf, o_pt, o_valid, uv, ur, inv2 = G._prep_obs(m, inv_level_sigma2)
    e, _, _, st = G._residuals_jacs(m.kf_pose.double(), m.pt_pos.double(), o_kf, o_pt,
                                    uv.double(), ur.double(), cam)
    s2 = ((e * torch.sqrt(inv2.double())[:, None]) ** 2).sum(-1)
    d = torch.where(st, CHI2_STEREO ** 0.5, CHI2_MONO ** 0.5)
    ss = torch.sqrt(s2 + 1e-12)
    rho = torch.where(ss <= d, s2, 2 * d * ss - d * d)
    return float(torch.where(o_valid, rho, 0.0).sum()), int(o_valid.sum())


def run_gba_scene(label, caps, device, cpu_check: bool) -> dict:
    """Global BA on ``gba_scene(caps)`` on the card, twice, timed with CUDA
    events, with the host syncs of the second call counted. Fails unless the
    two maps are identical, steps were taken (the robust cost fell), keyframe
    0 (the gauge) kept its pose and every keyframe lands within 1 cm of its
    ground truth (tests/test_global_ba.py's bound); with ``cpu_check`` the
    card's poses and points must also agree with the same call on the CPU
    within 1e-5."""
    from vo_slam_test_tpu_torch.solvers import global_ba

    m, gt, cam = gba_scene(caps, device)
    outs, ms, syncs = [], [], 0
    for k in range(2):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if k:
                torch.cuda.set_sync_debug_mode("warn")
            e0.record()
            outs.append(global_ba.global_bundle_adjust(m, caps, cam, 0))
            e1.record()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        syncs = len([w for w in caught if "synchroniz" in str(w.message)])
    out = outs[0]
    c0, n_obs = gba_cost(m, cam)
    c1, _ = gba_cost(out, cam)
    n_kf = gt.shape[0]
    terr = np.linalg.norm(out.kf_pose[:n_kf, :3, 3].cpu().numpy() - gt[:, :3, 3], axis=1)
    row = dict(caps=[caps.max_kf, caps.max_pt, caps.max_obs, caps.n_feat], observations=n_obs,
               table=caps.max_kf * caps.n_feat, ms=ms, host_syncs=syncs, cost=[c0, c1],
               max_kf_err_m=float(terr.max()))
    same = all(torch.equal(getattr(outs[0], f), getattr(outs[1], f)) for f in ("kf_pose", "pt_pos"))
    if cpu_check:
        mc = m.replace(**{f.name: getattr(m, f.name).cpu() for f in dataclasses.fields(m)})
        cam_c = gba_scene(caps, "cpu")[2]
        oc = global_ba.global_bundle_adjust(mc, caps, cam_c, 0)
        row["cpu_max_abs"] = max(float((out.kf_pose.cpu() - oc.kf_pose).abs().max()),
                                 float((out.pt_pos.cpu() - oc.pt_pos).abs().max()))
    print(f"  {label} (MapCaps{tuple(row['caps'])}, {n_obs} bound observations of "
          f"{row['table']} table slots): ms per call (CUDA events) {[round(x, 3) for x in ms]}; "
          f"host syncs {syncs}; robust cost {c0:.6f} -> {c1:.6f}; largest keyframe error "
          f"{row['max_kf_err_m']:.6f} m; two calls identical {same}"
          + (f"; against the CPU {row['cpu_max_abs']:.3e}" if cpu_check else ""))
    if not (same and c1 < c0 and terr.max() < 0.01
            and torch.equal(out.kf_pose[0], m.kf_pose[0])
            and row.get("cpu_max_abs", 0.0) < 1e-5):
        raise AssertionError(f"global BA on the fabricated scene ({label}) failed: {row}")
    return row


def cuda_ms(fn):
    """(result, ms) of one call of ``fn`` between CUDA events (its host syncs
    included)."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def map_copy(m):
    return m.replace(**{f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)})


def reproj_rmse(m, cam, kfs) -> float:
    """tests/test_local_ba.py::reproj_rmse on a port map: the monocular
    reprojection RMSE (px) of the keyframes ``kfs``' bound keypoints."""
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    kf_pose, pt = m.kf_pose.cpu().numpy(), m.pt_pos.cpu().numpy()
    kf_mp, uv = m.kf_mp.cpu().numpy(), m.kf_uv_und.cpu().numpy()
    errs = []
    for k in kfs:
        sel = kf_mp[k] >= 0
        pc = pt[kf_mp[k][sel]] @ kf_pose[k][:3, :3].T + kf_pose[k][:3, 3]
        errs.append(np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
                    - uv[k][sel])
    e = np.concatenate(errs)
    return float(np.sqrt((e ** 2).sum(-1).mean()))


MESH_FX, MESH_FY, MESH_CX, MESH_CY, MESH_BF = 517.3, 516.5, 318.6, 255.3, 40.0


def pose_obs_instance(n=64, seed=0):
    """tests/test_parallel.py::make_obs with the port's types: n points seen
    exactly from a pose T_gt -> (T_gt, PoseObs on the CPU)."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.solvers.pose_only import PoseObs

    rng = np.random.default_rng(seed)
    pw = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], size=(n, 3)).astype(np.float32)
    xi = np.array([0.05, -0.08, 0.12, 0.03, -0.02, 0.04], np.float32)
    T_gt = lie.se3_exp(torch.as_tensor(xi)).numpy()
    pc = pw @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([MESH_FX * pc[:, 0] / pc[:, 2] + MESH_CX,
                   MESH_FY * pc[:, 1] / pc[:, 2] + MESH_CY], -1).astype(np.float32)
    return T_gt, PoseObs(torch.as_tensor(pw), torch.as_tensor(uv), torch.full((n,), -1.0),
                         torch.ones((n,)), torch.ones((n,), dtype=torch.bool))


def ba_obs_instance(W=4, L=32, M=64, seed=1):
    """tests/test_parallel.py::test_ba_normal_equations_reduce's instance:
    (poses, points, o_kf, o_pt, o_uv, o_w) as numpy."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    points = rng.uniform([-1, -1, 2], [1, 1, 5], (L, 3)).astype(np.float32)
    o_kf = rng.integers(0, W, M).astype(np.int32)
    o_pt = rng.integers(0, L, M).astype(np.int32)
    pc = points[o_pt]
    u = MESH_FX * pc[:, 0] / pc[:, 2] + MESH_CX + rng.normal(0, 1, M)
    v = MESH_FY * pc[:, 1] / pc[:, 2] + MESH_CY + rng.normal(0, 1, M)
    return poses, points, o_kf, o_pt, np.stack([u, v], -1).astype(np.float32), \
        np.ones((M,), np.float32)


def schur_instance(W=4, L=32, seed=2):
    """A well-posed BA window for ``sharded_ba_schur_step``: W keyframes 0.2 m
    apart, every point seen by every keyframe with 0.5 px noise, the poses but
    the first and the points perturbed -> numpy arrays as ``ba_obs_instance``."""
    from vo_slam_test_tpu_torch import lie

    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    gt[:, 0, 3] = -0.2 * np.arange(W)
    points = rng.uniform([-1, -1, 2], [1, 1, 5], (L, 3)).astype(np.float32)
    o_kf = np.repeat(np.arange(W), L).astype(np.int32)
    o_pt = np.tile(np.arange(L), W).astype(np.int32)
    pc = points[o_pt] + gt[o_kf, :3, 3]
    u = MESH_FX * pc[:, 0] / pc[:, 2] + MESH_CX + rng.normal(0, 0.5, W * L)
    v = MESH_FY * pc[:, 1] / pc[:, 2] + MESH_CY + rng.normal(0, 0.5, W * L)
    poses = gt.copy()
    for w in range(1, W):
        poses[w] = lie.se3_exp(torch.as_tensor(
            rng.normal(0, 0.01, 6).astype(np.float32))).numpy() @ gt[w]
    points = (points + rng.normal(0, 0.02, points.shape)).astype(np.float32)
    return (poses, points, o_kf, o_pt, np.stack([u, v], -1).astype(np.float32),
            np.ones((W * L,), np.float32))


def check_dead_shard(m, kf, caps, cam, inv, mesh, live):
    """The kernels of local BA on a shard with no live point (n_pts = 0), with
    the scratch filled with NaN and the mask words with -1: every sum, the
    cost, bl, Wc, the mask words, the point step and the cost kernel's cost
    must be exactly zero, and Hinv finite (the damping's inverse), so a dead
    shard adds nothing stale to the psum."""
    from vo_slam_test_tpu_torch.ops import ba_cuda
    from vo_slam_test_tpu_torch.solvers import local_ba

    s = max(i for i, n in enumerate(live) if n == 0)
    prob = local_ba.build_problem_ol(m, kf, caps, inv)
    sp = local_ba._shard_problem(prob, mesh)[s]
    wk = min(local_ba.W_KF, m.kf_valid.shape[0])
    WF = prob.kf_ids.shape[0]
    Ls = sp.pt_ids.shape[0]
    posesT = m.kf_pose[prob.kf_ids.clamp(min=0).long()].reshape(WF, 16).T.contiguous()
    X = m.pt_pos[sp.pt_ids.clamp(min=0).long()].T.contiguous()
    obs = (sp.o_slot, sp.o_uv[0].contiguous(), sp.o_uv[1].contiguous(), sp.o_ur,
           sp.o_inv_sigma2, sp.o_valid.to(torch.float32))
    n0 = torch.zeros((), dtype=torch.int32, device=m.device)
    scratch = torch.full((wk, Ls, ba_cuda.REC), float("nan"), device=m.device)
    mask = torch.full((Ls,), -1, dtype=torch.int32, device=m.device)
    cam5 = local_ba._cam5(cam)
    lam = torch.full((), 1e-4, device=m.device)
    Hpp36, bp, S_red, rhs_red, cost, Hinv, bl, Wc = ba_cuda.ba_accumulate(
        lam, posesT, X, *obs, sp.o_povar, cam5, wk, True, n_pts=n0, scratch=scratch, mask=mask)
    dx_pose = torch.as_tensor(np.random.default_rng(5).normal(0, 0.01, (wk, 6)).astype(
        np.float32), device=m.device)
    dx = ba_cuda.ba_backsub(Wc, Hinv, bl, dx_pose, n_pts=n0, mask=mask)
    c2 = ba_cuda.ba_cost(posesT, X, *obs, cam5, True, n_pts=n0)
    zeros = {"Hpp": Hpp36, "bp": bp, "S_red": S_red, "rhs_red": rhs_red, "cost": cost, "bl": bl,
             "Wc": Wc, "dx_pt": dx, "cost kernel": c2}
    if mask.is_cuda:  # the plain versions take no mask buffer
        zeros["mask"] = mask
    bad = [k for k, t in zeros.items() if not bool((t == 0).all())]
    if bad or not bool(torch.isfinite(Hinv).all()):
        raise AssertionError(f"local BA kernels on dead shard {s}: non-zero {bad}, "
                             f"Hinv finite {bool(torch.isfinite(Hinv).all())}")
    return s


def run_mesh_phase(s1, dev) -> dict:
    """The analogue of __graft_entry__.dryrun_multichip at real size, with 8
    shards on the one card (``parallel.make_obs_mesh(8)`` over every CUDA
    device: one here). Local BA on main path 2's final map at the default
    MapCaps (L = 8192: 1024 points a shard) against the one-device solver
    (tests/test_parallel.py's tolerances: pt_obs_cnt equal, poses within
    5e-4, live points within 5e-3), each of rows 7-9 launched once per LM
    iteration on each shard, and a dead shard's launches zero; global BA on
    ``gba_scene`` at the default MapCaps against the one-device solver
    under tests/test_global_ba.py:49-80's contract; the three ``sharded_*``
    functions against the same calls on an 8-shard CPU mesh. Mesh and
    one-device ms side by side; one card holds every shard, so no scaling is
    measured."""
    from vo_slam_test_tpu_torch import parallel
    from vo_slam_test_tpu_torch.ops import ba_cuda
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import global_ba, local_ba

    mesh = parallel.make_obs_mesh(8)
    cpu = parallel.make_obs_mesh(8, ["cpu"])
    print(f"phase mesh (8 shards on one card): {mesh.n_shards} shards on {mesh.n_devices} "
          f"device(s) {[str(d) for d in mesh.devices]}")
    row = dict(n_shards=mesh.n_shards, n_devices=mesh.n_devices,
               devices=[str(d) for d in mesh.devices])

    # local BA on main path 2's final map, around its newest keyframe
    m, caps, cam = s1.map, s1.caps, s1.camera
    inv = 1.0 / (s1.scale_factors * s1.scale_factors)
    kf = int(torch.argmax(torch.where(m.kf_valid, m.kf_seq, -1)))
    prob = local_ba.build_problem_ol(m, kf, caps, inv)
    live = [int(x.sum()) for x in mesh.split(prob.pt_ids >= 0)]
    acc = (ba_cuda.KERNEL_ACC, ba_cuda.KERNEL_COST, ba_cuda.KERNEL_BACKSUB)
    mc = map_copy(m)
    for k in acc:
        k.reset()
    (m_single, n1, n2), ms_single = cuda_ms(
        lambda: local_ba.local_bundle_adjust_iters(mc, kf, caps, cam, inv))
    single_launches = [k.launches for k in acc]
    mc = map_copy(m)
    for k in acc:
        k.reset()
    (m_mesh, k1, k2), ms_mesh = cuda_ms(
        lambda: local_ba.local_bundle_adjust_mesh_iters(mc, kf, caps, cam, mesh, inv))
    mesh_launches = [k.launches for k in acc]
    both = (m_single.pt_valid & m_mesh.pt_valid).cpu().numpy()
    pose_err = float((m_mesh.kf_pose - m_single.kf_pose).abs().max())
    pt_err = float(np.abs(m_mesh.pt_pos.cpu().numpy() - m_single.pt_pos.cpu().numpy())[both].max())
    cnt_equal = torch.equal(m_mesh.pt_obs_cnt, m_single.pt_obs_cnt)
    dead = check_dead_shard(m, kf, caps, cam, inv, mesh, live) if 0 in live else None
    row["local_ba"] = dict(
        keyframe=kf, L=prob.pt_ids.shape[0], live_points_per_shard=live,
        lm_iterations_single=[n1, n2], lm_iterations_mesh=[k1, k2],
        launches_single=single_launches, launches_mesh=mesh_launches,
        launches_per_shard=[k1 + k2] * mesh.n_shards, ms_single=ms_single, ms_mesh=ms_mesh,
        max_pose_err=pose_err, max_point_err=pt_err, pt_obs_cnt_equal=cnt_equal,
        dead_shard_checked=dead)
    print(f"  local BA on main path 2's final map around keyframe {kf} (L = "
          f"{prob.pt_ids.shape[0]}, live points per shard {live}): LM iterations one device "
          f"{(n1, n2)}, mesh {(k1, k2)}; rows 7-9 launched {mesh_launches} on the mesh = "
          f"{k1 + k2} on each of {mesh.n_shards} shards ({single_launches} on one device); "
          f"ms one device {ms_single:.3f}, 8 shards on one card {ms_mesh:.3f}; largest pose "
          f"difference {pose_err:.3e}, point {pt_err:.3e}; pt_obs_cnt equal {cnt_equal}; "
          f"dead shard {dead}'s launches all zero")
    on_card = torch.device(dev).type == "cuda"  # a CPU rehearsal launches no kernel
    if not (cnt_equal and pose_err <= 5e-4 and pt_err <= 5e-3 and (not on_card or (
            single_launches == [n1 + n2] * 3
            and mesh_launches == [mesh.n_shards * (k1 + k2)] * 3))):
        raise AssertionError(f"mesh local BA: {row['local_ba']}")

    # global BA on the fabricated scene at the default MapCaps
    gcaps = MapCaps()
    gm, gt, gcam = gba_scene(gcaps, dev)
    g1, gms1 = cuda_ms(lambda: global_ba.global_bundle_adjust(gm, gcaps, gcam, 0))
    g2, gms2 = cuda_ms(lambda: global_ba.global_bundle_adjust_mesh(gm, gcaps, gcam, 0, mesh))
    n_kf = gt.shape[0]
    terr = np.linalg.norm(g2.kf_pose[:n_kf, :3, 3].cpu().numpy() - gt[:, :3, 3], axis=1)
    r1, r2 = reproj_rmse(g1, gcam, range(n_kf)), reproj_rmse(g2, gcam, range(n_kf))
    gpose = float((g2.kf_pose - g1.kf_pose).abs().max())
    anchor = float(np.abs(g2.kf_pose[0].cpu().numpy() - gt[0]).max())
    row["global_ba"] = dict(ms_single=gms1, ms_mesh=gms2, max_pose_diff=gpose,
                            anchor_err=anchor, max_kf_err_m=float(terr.max()),
                            reproj_rmse_single=r1, reproj_rmse_mesh=r2)
    print(f"  global BA on the fabricated scene (MapCaps{tuple(dataclasses.astuple(gcaps))}, "
          f"K*N = {gcaps.max_kf * gcaps.n_feat}): ms one device {gms1:.3f}, 8 shards on one card "
          f"{gms2:.3f}; poses against one device {gpose:.3e}; anchor {anchor:.1e}; largest "
          f"keyframe error {terr.max():.6f} m; reprojection RMSE {r1:.6f} / {r2:.6f} px")
    if not (gpose <= 1e-2 and anchor <= 1e-6 and terr.max() < 0.01 and r2 < 1.0
            and r2 < r1 * 1.1):
        raise AssertionError(f"mesh global BA: {row['global_ba']}")

    # the three sharded_* functions against the same calls on the CPU's mesh
    T_gt, obs = pose_obs_instance()
    fns = [parallel.sharded_pose_gn_step(msh) for msh in (mesh, cpu)]
    Ts = []
    for fn, d in zip(fns, (dev, "cpu")):
        T = torch.eye(4, device=d)
        o = type(obs)(*[f.to(d) for f in obs])
        for _ in range(8):
            T = fn(T, o, MESH_FX, MESH_FY, MESH_CX, MESH_CY, MESH_BF)
        Ts.append(T.cpu())
    gn_err = float((Ts[0] - Ts[1]).abs().max())
    gn_truth = float(np.abs(Ts[0].numpy() - T_gt).max())
    ne = [parallel.sharded_ba_normal_equations(msh, 4, 32)(
        *[torch.as_tensor(a).to(d) for a in ba_obs_instance()], MESH_FX, MESH_FY, MESH_CX,
        MESH_CY) for msh, d in ((mesh, dev), (cpu, "cpu"))]
    ne_err = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1.0)
                 for a, b in zip(*ne))
    sc = [parallel.sharded_ba_schur_step(msh, 4, 32, 100.0)(
        *[torch.as_tensor(a).to(d) for a in schur_instance()], MESH_FX, MESH_FY, MESH_CX,
        MESH_CY) for msh, d in ((mesh, dev), (cpu, "cpu"))]
    sc_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(*sc))
    row["sharded"] = dict(pose_gn_card_vs_cpu=gn_err, pose_gn_vs_truth=gn_truth,
                          normal_equations_rel=ne_err, schur_step=sc_err)
    print(f"  sharded_pose_gn_step (8 steps): card against CPU {gn_err:.2e}, against the truth "
          f"{gn_truth:.2e}; sharded_ba_normal_equations: {ne_err:.2e} of the largest entry; "
          f"sharded_ba_schur_step: {sc_err:.2e}")
    if not (gn_err <= 1e-5 and gn_truth < 1e-3 and ne_err <= 1e-4 and sc_err <= 5e-5):
        raise AssertionError(f"sharded functions on the card: {row['sharded']}")
    return row


def run_pan(system, cfg, voc, frames, chunk: int, gba: bool, recorder=None, sever_old=True,
            profile_frames=(), diag: bool = False):
    """One main-path-5 run: ``SlamSystem(vocabulary=voc, chunk=chunk,
    enable_global_ba=gba)`` with MapCaps(max_kf=32, max_pt=8192) over the pan
    loop, the drift injected after frame PAN_DRIFT_FRAME with the cut at the
    keyframe count after frame PAN_CUT_FRAME by ``inject_drift``, then (with
    ``sever_old``) ``pan_sever_old``.
    CUDA events around each track call (per frame, or per chunk where the
    chunk's work runs), around each keyframe event's background step and
    each global BA; host syncs per track call (sync debug mode). ``recorder``
    (a LaunchRecorder) learns the frame and, as its tag, whether the loop
    correction runs; a torch.profiler window over the track calls of
    ``profile_frames`` (consecutive) -> rec["profile"] = (profiler, host wall
    ms per frame). ``diag``: the system is made with ``VO_LOOP_DIAG=1`` and
    ``drain_chunk=1`` (the host-drained Sim3 attempts with their gate values;
    a closure then runs in the next frame's track call, not in a background
    step)."""
    from torch.profiler import ProfilerActivity, profile

    from vo_slam_test_tpu_torch.pipeline import loop_closing
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import global_ba
    from vo_slam_test_tpu_torch.utils.drift import inject_drift

    D = torch.as_tensor(pan_drift()).to("cuda")
    saved = os.environ.get("VO_LOOP_DIAG")
    os.environ["VO_LOOP_DIAG"] = "1" if diag else "0"
    try:
        s = system.SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc,
                              chunk=chunk, enable_global_ba=gba,
                              drain_chunk=1 if diag else system.DRAIN_CHUNK)
    finally:
        if saved is None:
            del os.environ["VO_LOOP_DIAG"]
        else:
            os.environ["VO_LOOP_DIAG"] = saved
    rec = dict(call_ms=[], syncs=[], sync_sites={}, events=[], gba=[])
    orig_bg, orig_gba, orig_corr = (system.background_step, global_ba.global_bundle_adjust,
                                    loop_closing._correct)

    def timed_bg(*a, **k):
        if not (a[2] and a[3] >= 0):  # no keyframe event
            return orig_bg(*a, **k)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_bg(*a, **k)
        e1.record()
        rec["events"].append((e0, e1, out[2]))
        return out

    def timed_gba(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig_gba(*a, **k)
        e1.record()
        rec["gba"].append((e0, e1))
        return out

    def tagged_correct(*a, **k):
        if recorder is not None:
            recorder.tag = "loop_fuse"
        try:
            return orig_corr(*a, **k)
        finally:
            if recorder is not None:
                recorder.tag = None

    system.background_step, global_ba.global_bundle_adjust = timed_bg, timed_gba
    loop_closing._correct = tagged_correct
    kf_cut = pre_poses = pre_valid = prof = None
    rec["profile"] = None
    try:
        for i, (gray, depth, ts) in enumerate(frames):
            if recorder is not None:
                recorder.frame = i
            if profile_frames and i == profile_frames[0]:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                s.track(gray, depth, ts)
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            torch.cuda.synchronize()
            rec["call_ms"].append(start.elapsed_time(end))
            sync_ws = [w for w in caught if "synchroniz" in str(w.message)]
            rec["syncs"].append(len(sync_ws))
            for w in sync_ws:
                site = f"{w.filename.split('vo_slam_test_tpu_torch/')[-1]}:{w.lineno}"
                rec["sync_sites"][site] = rec["sync_sites"].get(site, 0) + 1
            if prof is not None and i == profile_frames[-1]:
                wall = (time.perf_counter() - t_prof) * 1e3 / len(profile_frames)
                prof.__exit__(None, None, None)
                rec["profile"], prof = (prof, wall), None
            if i == PAN_CUT_FRAME:
                assert not s._chunk_buf
                kf_cut = max(int(s.map.n_kf), 1)
            if i == PAN_DRIFT_FRAME:
                assert not s._chunk_buf
                pre_poses = s.map.kf_pose.cpu().numpy()
                pre_valid = s.map.kf_valid.cpu().numpy()
                s.map, s.state.assign_real = inject_drift(s.map, s.state.assign_real, kf_cut, D)
                if sever_old:
                    s.map = s.map.replace(**{k: torch.as_tensor(v, device=s.map.device)
                                             for k, v in pan_sever_old(s.map, kf_cut).items()})
        torch.cuda.synchronize()
    finally:
        system.background_step, global_ba.global_bundle_adjust = orig_bg, orig_gba
        loop_closing._correct = orig_corr
        if prof is not None:
            prof.__exit__(None, None, None)
    # keyframe events run in frame order, one background step each
    kf_frames = [i for i, o in enumerate(s._outs) if o.made_kf]
    assert len(kf_frames) == len(rec["events"])
    rec.update(kf_cut=kf_cut, pre_poses=pre_poses, pre_valid=pre_valid,
               map_ms={f: e0.elapsed_time(e1) for f, (e0, e1, _) in zip(kf_frames, rec["events"])},
               closing_ms=[e0.elapsed_time(e1) for e0, e1, out in rec.pop("events") if out.closed],
               gba_ms=[e0.elapsed_time(e1) for e0, e1 in rec.pop("gba")])
    return s, rec


def pan_report(label, s, rec, gt):
    """Print one main-path-5 variant and hold it to tests/test_loop_e2e.py's
    gates: > 90% of frames tracked, exactly one loop closure, loop edges set,
    the island keyframes' median residual against their pre-drift poses
    under 0.35 |t_D|."""
    from vo_slam_test_tpu_torch.datasets import ate_rmse

    traj, stats, _ = s.results()
    oks = [st.ok for st in stats]
    D = pan_drift()
    res = island_residual(rec["pre_poses"], rec["pre_valid"], rec["kf_cut"],
                          s.map.kf_pose.cpu().numpy())
    gate = 0.35 * float(np.linalg.norm(D[:3, 3]))
    ate = ate_rmse(s.timestamps, gt, s.timestamps, traj)
    kf_frames = [i for i, o in enumerate(s._outs) if o.made_kf]
    closing = s.loop_closures[0] if s.loop_closures else None
    cm = np.array(rec["call_ms"])
    print(f"  {label}: tracked {sum(oks)}/{len(oks)}; kf_cut {rec['kf_cut']}; loop closures at "
          f"frames {s.loop_closures}; attempts (frame, winner, accepted) {s.loop_attempts}; "
          f"loop edges {torch.nonzero(s.map.loop_edges).tolist()}")
    print(f"    Sim3 gates per attempt (frame, candidate, accepted, gates): {s.loop_gates}")
    print(f"    island residual median {float(np.median(res)) if res.size else float('nan'):.6f} m "
          f"(gate {gate:.4f}) per keyframe {res.round(6).tolist()}; ATE {ate * 100:.4f} cm; "
          f"keyframe events at {kf_frames}; live keyframes {s.n_keyframes}, points {s.n_points}; "
          f"LM iterations {s.ba_iters}")
    chunk = s.chunk
    work = [i for i in range(len(cm)) if chunk == 1 or (i + 1) % chunk == 0]
    plain_ev = [v for i, v in sorted(rec["map_ms"].items()) if i != closing]
    close_ms = rec["closing_ms"][0] if rec["closing_ms"] else None
    kf_calls = {i for i in work if any(i - chunk < f <= i for f in kf_frames)}
    print(f"    ms per track call (CUDA events; {'frame' if chunk == 1 else f'chunk of {chunk}'}): "
          f"without a keyframe event median "
          f"{np.median([cm[i] for i in work if i not in kf_calls and i > 0]):.3f}, with one "
          f"median {np.median([cm[i] for i in kf_calls if i > 0]):.3f}; keyframe events' "
          f"background step ms median {np.median(plain_ev):.3f} over {len(plain_ev)}, the closing "
          f"event's {close_ms if close_ms is None else round(close_ms, 3)}; global BA ms "
          f"{[round(x, 3) for x in rec['gba_ms']]}")
    print(f"    host syncs per track call: {rec['syncs']}; by the line that synced: "
          f"{rec['sync_sites']}")
    print(f"    kernel launches: {rec.get('launches')}")
    if not (sum(oks) > 0.9 * len(oks) and len(s.loop_closures) == 1
            and bool(s.map.loop_edges.any()) and res.size and np.median(res) < gate):
        raise AssertionError(f"main path 5 ({label}) failed: {sum(oks)}/{len(oks)} tracked, "
                             f"closures {s.loop_closures}, residual {res.tolist()} m (gate {gate})")
    return dict(oks=sum(oks), closing_frame=closing, attempts=s.loop_attempts,
                gates=[(f, c, a, g) for f, c, a, g in s.loop_gates], residual_m=res.tolist(),
                ate_m=float(ate), call_ms=rec["call_ms"], map_ms=rec["map_ms"],
                closing_event_ms=close_ms, gba_ms=rec["gba_ms"], syncs=rec["syncs"],
                launches=rec.get("launches"))


class LaunchRecorder:
    """Wraps kernel wrappers and keeps a copy of the arguments of every call
    that ``keep(index of the call on its frame, args)`` accepts, tagged with
    the frame being tracked."""

    def __init__(self, targets):
        self.targets = targets  # (module, attribute, keep)
        self.frame = -1
        self.tag = None  # set by the caller around the calls a keep looks for
        self.got = {attr: [] for _, attr, _ in targets}
        self.saved = []

    def __enter__(self):
        for mod, attr, keep in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def wrapped(*args, _fn=fn, _attr=attr, _keep=keep, **kw):
                if _keep(self.frame, args):
                    self.got[_attr].append((self.frame, [a.clone() for a in args], dict(kw)))
                return _fn(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []


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


def png_bytes(img: np.ndarray) -> bytes:
    """A non-interlaced PNG of ``img``, rows unfiltered: u8 [H, W, 3] as 8-bit
    RGB, u16 [H, W] as 16-bit gray (big-endian samples, as PNG stores them)."""
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, bits, rows = 2, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, bits, rows = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"png_bytes writes u8 RGB or u16 gray, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    body = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], axis=1)  # filter type 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def write_tum(d: Path, frames, cfg) -> list:
    """``frames`` (gray u8, depth f32 meters, t) as a TUM RGB-D directory:
    ``rgb/`` (gray as R=G=B, so BT.601 luma gives it back exactly),
    ``depth/`` (round(d * 5000) as u16), ``associate.txt``, and ``cfg.yaml``
    with ``configs/tum_fr1.yaml``'s key set filled from ``cfg`` (the dataset
    directory is ``d``). Returns the u16 depth images written."""
    from vo_slam_test_tpu_torch.config import _load_opencv_yaml

    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    lines, raw = [], []
    for gray, depth, t in frames:
        name = f"{t:.6f}.png"
        scaled = np.round(depth.astype(np.float64) * 5000.0)
        if scaled.max() > 65535:
            raise AssertionError("depth beyond the u16 range of a TUM depth image")
        raw.append(scaled.astype(np.uint16))
        (d / "rgb" / name).write_bytes(png_bytes(np.repeat(gray[..., None], 3, axis=2)))
        (d / "depth" / name).write_bytes(png_bytes(raw[-1]))
        lines.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
    (d / "associate.txt").write_text("\n".join(lines) + "\n")
    keys = _load_opencv_yaml(str(Path(__file__).resolve().parent / "configs" / "tum_fr1.yaml"))
    vals = dict(dataclasses.asdict(cfg), dataset_dir=str(d))
    (d / "cfg.yaml").write_text("%YAML:1.0\n" + "".join(
        f"{k}: {json.dumps(vals[k]) if isinstance(vals[k], str) else repr(vals[k])}\n"
        for k in keys))
    return raw


def read_tum_trajectory(path):
    """(times, [N,4,4] T_w_c with the translations; rotation left identity)
    from a TUM trajectory file: enough for ``ate_rmse``."""
    rows = np.loadtxt(path, ndmin=2)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, 3] = rows[:, 1:4]
    return rows[:, 0], T


class CliProbe:
    """Instruments ``run_slam.main`` calls: each tracker ``track`` call's
    CUDA-event ms and host syncs (sync debug mode; the frame is synchronized
    after its call), the host ms of each TUM frame read and the reader that
    served it, the host ms of each host quad-tree pass; keeps the last
    tracker. ``reset()`` starts a new run's record."""

    def __init__(self):
        from vo_slam_test_tpu_torch.datasets import tum
        from vo_slam_test_tpu_torch.frontend import extractor
        from vo_slam_test_tpu_torch.pipeline import system, tracking

        self.targets = [(tum.TumDataset, "__getitem__", self._read),
                        (extractor.OrbExtractor, "_distribute", self._distribute),
                        (system.SlamSystem, "track", self._track),
                        (tracking.FusedTracker, "track", self._track),
                        (tracking.FrameToFrameTracker, "track", self._track)]
        self.saved = []
        self.reset()

    def reset(self):
        self.tracker = None
        self.frame_ms, self.syncs, self.read_ms, self.dist_ms, self.readers = [], [], [], [], set()

    def _read(self, orig):
        def read(ds, i):
            t0 = time.perf_counter()
            out = orig(ds, i)
            self.read_ms.append((time.perf_counter() - t0) * 1e3)
            self.readers.add(ds.reader if ds.reader == "native"
                             else f"{ds.reader} (native: {ds.native_error})")
            return out
        return read

    def _distribute(self, orig):
        def distribute(ext, cands):
            t0 = time.perf_counter()
            out = orig(ext, cands)
            self.dist_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return distribute

    def _track(self, orig):
        def track(tracker, gray, depth, ts):
            self.tracker = tracker
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = orig(tracker, gray, depth, ts)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            end.record()
            torch.cuda.synchronize()
            self.frame_ms.append(start.elapsed_time(end))
            self.syncs.append(sum("synchroniz" in str(w.message) for w in caught))
            return out
        return track

    def __enter__(self):
        for cls, attr, make in self.targets:
            orig = getattr(cls, attr)
            self.saved.append((cls, attr, orig))
            setattr(cls, attr, make(orig))
        return self

    def __exit__(self, *exc):
        for cls, attr, orig in self.saved:
            setattr(cls, attr, orig)
        self.saved = []

    def run(self, label, argv):
        """One ``run_slam.main(argv)`` on the card; its output is kept apart and
        its summary lines printed with this run's per-frame record -> dict."""
        from vo_slam_test_tpu_torch import run_slam

        self.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_slam.main(argv)
        wall = time.perf_counter() - t0
        out = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"path 6 {label}: run_slam exited {rc}:\n{out[-2000:]}")
        n = len(self.frame_ms)
        rec = dict(frames=n, frame_ms_median=float(np.median(self.frame_ms)),
                   frame_ms_mean=float(np.mean(self.frame_ms)),
                   decode_ms_per_frame=float(np.mean(self.read_ms)) if self.read_ms else None,
                   distribute_ms_per_frame=sum(self.dist_ms) / n if self.dist_ms else None,
                   host_syncs_per_frame=float(np.mean(self.syncs)), syncs=list(self.syncs),
                   readers=sorted(self.readers) or ["none (rendered in memory)"], wall_s=wall)
        print(f"  {label}: run_slam {' '.join(argv)}")
        for line in out.splitlines():
            if not line.startswith("frame ") and "saved to" not in line:
                print(f"    | {line}")
        print(f"    frame ms (CUDA events around each track call) median "
              f"{rec['frame_ms_median']:.3f}, mean {rec['frame_ms_mean']:.3f}; decode ms a frame "
              f"{rec['decode_ms_per_frame']}; host quad-tree ms a frame "
              f"{rec['distribute_ms_per_frame']}; host syncs a frame {rec['host_syncs_per_frame']:.2f} "
              f"{self.syncs}; reader {rec['readers']}; {wall:.1f} s in all")
        rec["stdout"] = out
        return rec


def main_path6(room, room_frames, room_cfg, frames, cfg, gt, all_kernels, plains, dev):
    """Main path 6: ``run_slam.main`` in this process on TUM files written
    here from path 2's frames (``--slam`` with every output, then with the
    scene vocabulary it wrote and ``--chunk 4``), a save/load/resume of the
    first run's map, then path 1's sequence through ``--sync``
    (FrameToFrameTracker) and the default mode; the launches of those runs
    are counted. Then the host-path extractor on ``dev`` against the CPU.
    Raises on any failed check -> (per-run records, launches)."""
    import importlib.util

    from vo_slam_test_tpu_torch.bow.vocabulary import Vocabulary
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.datasets import TumDataset, ate_rmse
    from vo_slam_test_tpu_torch.frontend.extractor import OrbExtractor
    from vo_slam_test_tpu_torch.pipeline import system
    from vo_slam_test_tpu_torch.slam_map.serialize import load_map, save_map

    t_path = time.perf_counter()
    n_room = len(room_frames)
    renderers = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib")}
    cli = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tum_") as tmp, PlainGuard(plains) as guard6, \
            CliProbe() as probe:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        written = write_tum(tmp / "room", room_frames, room_cfg)
        print(f"main path 6 data: path 2's {len(room_frames)} frames written as a TUM directory "
              f"(zlib PNGs, gray as R=G=B, depth round(d*5000) u16) and cfg.yaml in "
              f"{time.perf_counter() - t0:.1f} s; renderers on this machine: {renderers}")
        ds = TumDataset(str(tmp / "room"), width=room_cfg.camera_width,
                        height=room_cfg.camera_height)
        inv = np.float32(1.0) / np.float32(5000.0)
        for i in range(len(ds)):
            g, d, t = ds[i]
            want_d = (written[i].astype(np.float32) * inv if ds.reader == "native"
                      else written[i].astype(np.float32) / 5000.0)
            if not (np.array_equal(g, room_frames[i][0]) and np.array_equal(d, want_d)
                    and t == float(f"{room_frames[i][2]:.6f}")):
                raise AssertionError(f"path 6: frame {i} decoded by {ds.reader} differs from the "
                                     f"written one")
        print(f"  decoded frames equal the written ones (gray exactly, depth = the u16 / 5000) "
              f"through the {ds.reader} reader; native: {ds.native_error or 'served'}")

        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        out = {k: str(tmp / v) for k, v in dict(
            cam="cam.txt", kf="kf.txt", voc="voc.npz", metrics="m.csv", events="ev.json",
            viewer="v.html", hud="hud", map="map.png", cam3="cam3.txt", ev3="ev3.json",
            cam5="cam5.txt", cam7="cam7.txt").items()}
        argv = [str(tmp / "room" / "cfg.yaml"), "--slam", "--camera-out", out["cam"],
                "--keyframe-out", out["kf"], "--vocabulary-out", out["voc"],
                "--metrics-out", out["metrics"], "--events-out", out["events"],
                "--viewer-out", out["viewer"]]
        for mod, flag in (("PIL", "--hud-out"), ("matplotlib", "--map-out")):
            if renderers[mod]:
                argv += [flag, out[flag[2:-4]]]
            else:
                print(f"  {flag} left out: {mod} is not installed on this machine")
        cli["slam"] = probe.run("--slam, every output", argv)
        s6 = probe.tracker
        gt_t = [float(f"{t:.6f}") for _, _, t in room_frames]
        gt6 = np.stack([room.poses[i] for i in range(n_room)])
        t6, T6 = read_tum_trajectory(out["cam"])
        ate6 = ate_rmse(gt_t, gt6, t6, T6)
        ev = json.load(open(out["events"]))
        kf_rows = np.loadtxt(out["kf"], ndmin=2)
        html = Path(out["viewer"]).read_text()
        data = json.loads(html.split("const DATA = ", 1)[1].split(";\n", 1)[0])
        voc6 = Vocabulary.load(out["voc"])
        metrics = Path(out["metrics"]).read_text().strip().splitlines()
        kf_events6 = [i for i, o in enumerate(s6._outs) if o.made_kf]
        n_hud = len(list(Path(out["hud"]).glob("hud_*.png"))) if renderers["PIL"] else None
        cli["slam"].update(ate_m=float(ate6), keyframe_frames=kf_events6, events=ev)
        print(f"  --slam: tracked {ev['n_tracked']}/{ev['n_frames']}, ATE {ate6 * 100:.4f} cm "
              f"(the written camera trajectory against the render's poses), keyframe events at "
              f"{kf_events6}, {ev['n_keyframes']} live keyframes = {len(kf_rows)} keyframe rows = "
              f"{len(data['kf'])} in the viewer; vocabulary k={voc6.k} levels={voc6.levels} "
              f"{voc6.n_words} words; metrics rows {len(metrics) - 1}; HUD frames {n_hud}")
        if (ev["n_tracked"] != n_room or len(kf_events6) < 5 or not ate6 < 0.01
                or not ev["n_keyframes"] == len(kf_rows) == len(data["kf"])
                or len(metrics) != n_room + 1 or voc6.n_words < 1
                or len(data["traj"]) != n_room
                or n_hud not in (None, n_room)
                or (renderers["matplotlib"] and not Path(out["map"]).stat().st_size > 1000)):
            raise AssertionError(f"path 6 --slam failed: {ev}, ATE {ate6} m, keyframe events "
                                 f"{kf_events6}, {len(kf_rows)} keyframe rows, {len(data['kf'])} "
                                 f"viewer keyframes, {len(metrics)} metrics lines, {n_hud} HUD")

        cli["slam_voc"] = probe.run("--slam --vocabulary (the scene vocabulary) --chunk 4", [
            str(tmp / "room" / "cfg.yaml"), "--slam", "--vocabulary", out["voc"], "--chunk", "4",
            "--camera-out", out["cam3"], "--events-out", out["ev3"]])
        ev3 = json.load(open(out["ev3"]))
        ate3b = ate_rmse(gt_t, gt6, *read_tum_trajectory(out["cam3"]))
        cli["slam_voc"].update(ate_m=float(ate3b), events=ev3)
        print(f"  --slam --vocabulary --chunk 4: tracked {ev3['n_tracked']}/{ev3['n_frames']}, ATE "
              f"{ate3b * 100:.4f} cm, relocalizations at {ev3['reloc_frames']}, loop closures at "
              f"{ev3['loop_frames']}, {ev3['n_keyframes']} keyframes")
        if ev3["n_tracked"] != n_room:
            raise AssertionError(f"path 6 --slam --vocabulary --chunk 4 failed: {ev3}")

        # save, load and resume the first run's map (tests/test_serialize.py)
        map_path = str(tmp / "map.npz")
        save_map(map_path, s6.map, s6.caps)
        m_loaded, caps_loaded = load_map(map_path)
        differ = [f for f in s6.map.__dataclass_fields__
                  if not torch.equal(getattr(m_loaded, f), getattr(s6.map, f))]
        s_res = system.SlamSystem(s6.cfg, caps=caps_loaded)
        s_res.map, s_res.state, s_res._frame_id = m_loaded, s6.state, s6._frame_id
        s_res.track(*room[n_room])
        st_res = s_res.results()[1][-1]
        print(f"  save_map / load_map ({Path(map_path).stat().st_size / 1e6:.2f} MB): "
              f"{len(s6.map.__dataclass_fields__)} fields, differing {differ}; resumed frame "
              f"{n_room}: ok={st_res.ok} matches {st_res.n_matches} inliers "
              f"{st_res.n_inliers}")
        if differ or caps_loaded != s6.caps or not st_res.ok:
            raise AssertionError(f"path 6 resume failed: fields {differ}, caps {caps_loaded}, "
                                 f"{st_res}")

        cli["sync"] = probe.run("--synthetic --frames 30 --sync (FrameToFrameTracker)", [
            "--synthetic", "--frames", "30", "--sync", "--camera-out", out["cam5"]])
        f2f = probe.tracker
        ate5 = ate_rmse(f2f.timestamps, gt, f2f.timestamps, np.stack(f2f.trajectory))
        bad5 = [(i, s) for i, s in enumerate(f2f.stats)
                if not s.ok or (i > 0 and (s.n_matches < 100 or s.n_inliers < 50))]
        cli["sync"].update(ate_m=float(ate5), counts=[(s.n_features, s.n_matches, s.n_inliers)
                                                      for s in f2f.stats])
        print(f"  --sync: {sum(s.ok for s in f2f.stats)}/{len(f2f.stats)} ok, ATE "
              f"{ate5 * 100:.4f} cm; (features, matches, inliers) {cli['sync']['counts']}")
        if len(f2f.stats) != 30 or bad5 or not ate5 < 0.03:
            raise AssertionError(f"path 6 --sync failed: ATE {ate5} m, frames off the gates {bad5}")

        cli["fused"] = probe.run("--synthetic --frames 30 (FusedTracker)", [
            "--synthetic", "--frames", "30", "--camera-out", out["cam7"]])
        _, stats7 = probe.tracker.results()
        n_ok7 = sum(s.ok for s in stats7)
        print(f"  default mode: tracked {n_ok7}/{len(stats7)}")
        if n_ok7 != 30:
            raise AssertionError(f"path 6 default mode tracked {n_ok7}/30")
        launches6 = {k: v.launches for k, v in all_kernels.items()}
    print(f"  kernel launches: {launches6}; plain versions on CUDA: {guard6.cuda_calls}")
    if guard6.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard6.cuda_calls}")

    # the host-path extractor on the card against the same class on the CPU
    ext_d = OrbExtractor(Camera.from_config(cfg, dev))
    ext_c = OrbExtractor(Camera.from_config(cfg, "cpu"))
    f_d, f_c = ext_d(*frames[0][:2]), ext_c(*frames[0][:2])
    same = {k: torch.equal(getattr(f_d, k).cpu(), getattr(f_c, k))
            for k in ("uv", "uv_und", "octave", "valid", "desc", "response", "depth", "u_right")}
    dang = (f_d.angle.cpu() - f_c.angle).abs()
    ang6 = float(torch.minimum(dang, 360 - dang).max())
    print(f"  host-path OrbExtractor, frame 0 of path 1 on the card against the CPU: fields equal "
          f"{same}, {int(f_d.valid.sum())} keypoints, max angle difference {ang6} deg")
    if not all(same.values()) or not ang6 <= 1e-3:
        raise AssertionError(f"path 6: the host-path extractor on the card differs from the CPU: "
                             f"{same}, angle {ang6}")
    print(f"  main path 6 in {time.perf_counter() - t_path:.1f} s")
    return cli, launches6


SCENE_CAPS = dict(max_kf=32, max_pt=8192)
SAT_CAPS = (64, 4096, 24, 256)   # tests/test_local_ba_saturation.py:32
SAT_CENTER = 20


def scene_sequences():
    """Main path 7a's sequences at 640x480, the JAX package's off-nominal
    scenes: the moving object and sparse texture of tests/test_scenarios.py
    (fr3_sit_halfsph and fr3_nstr_tex_near analogues) and Milestone B of
    tests/test_system.py -> {label: (sequence, config)}."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD

    seqs = {"moving object": SyntheticRGBD(n_frames=12, seed=41, motion_scale=0.5,
                                           moving_patch=(0.9, 0.06)),
            "sparse texture": SyntheticRGBD(n_frames=12, seed=43, motion_scale=0.4,
                                            texture_corners=0.06),
            "Milestone B": SyntheticRGBD(n_frames=10, seed=21, motion_scale=0.5)}
    return {k: (q, SlamConfig(camera_fx=q.fx, camera_fy=q.fy, camera_cx=q.cx, camera_cy=q.cy,
                              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0))
            for k, q in seqs.items()}


def scene_gates(label, s, stats, ate) -> dict:
    """The JAX tests' gates on one run -> {gate: (value, held)}: every frame
    ok, and tests/test_scenarios.py:53-83 (moving object), :87-105 (sparse
    texture) or tests/test_system.py:20-33 (Milestone B)."""
    tail = stats[1:]
    inl = float(np.median([x.n_inliers for x in tail]))
    g = {"frames ok": (sum(x.ok for x in stats), all(x.ok for x in stats))}
    if label == "moving object":
        rej = max(x.n_matches - x.n_inliers for x in tail)
        g.update({"ATE < 4 cm": (ate, ate < 0.04), "median inliers > 80": (inl, inl > 80),
                  "max rejection > 20": (rej, rej > 20)})
    elif label == "sparse texture":
        med = float(np.median([x.n_matches for x in tail]))
        g.update({"ATE < 4 cm": (ate, ate < 0.04),
                  "keyframes >= 1": (s.n_keyframes, s.n_keyframes >= 1),
                  "median matches < 600": (med, med < 600)})
    else:
        g.update({"ATE < 2 cm": (ate, ate < 0.02),
                  "keyframes >= 1": (s.n_keyframes, s.n_keyframes >= 1),
                  "points > 300": (s.n_points, s.n_points > 300),
                  "median inliers > 100": (inl, inl > 100)})
    return g


def scene_report(label, s, rec, seq, launches) -> dict:
    """Print one path-7a run and hold it to its gates, its launches to its
    frames and keyframe events, and its BA launches to its LM iterations."""
    from vo_slam_test_tpu_torch.datasets import ate_rmse

    traj, stats, _ = s.results()
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    ate = float(ate_rmse(s.timestamps, gt, s.timestamps, traj))
    kf_frames = [i for i, o in enumerate(s._outs) if o.made_kf]
    gates = scene_gates(label, s, stats, ate)
    fm = np.array(rec["frame_ms"])
    print(f"  {label}: ATE {ate * 100:.4f} cm; keyframe events at {kf_frames}; live keyframes "
          f"{s.n_keyframes}, points {s.n_points}; gates {gates}")
    print(f"    per frame (n_features, n_matches, n_inliers): "
          f"{[(x.n_features, x.n_matches, x.n_inliers) for x in stats]}; LM iterations "
          f"{s.ba_iters}")
    print(f"    frame ms (CUDA events): median {np.median(fm[1:]):.3f} over frames "
          f"1..{len(fm) - 1}, frame 0 {fm[0]:.3f}; host syncs per frame {rec['syncs']}; by the "
          f"line that synced {rec['sync_sites']}")
    print(f"    kernel launches: {launches}")
    failed = [g for g, (_, ok) in gates.items() if not ok]
    if failed:
        raise AssertionError(f"main path 7a ({label}) failed its gates {failed}: {gates}")
    n, n_ev = len(stats), len(kf_frames)
    if (launches["fast"] != n or launches["orb"] != n or launches["top2_chi2"] != n_ev
            or launches["top2_nb"] != n_ev):
        raise AssertionError(f"kernel launch counts off on main path 7a ({label}): {launches}, "
                             f"{n} frames, {n_ev} keyframe events")
    check_ba_launches(f"main path 7a ({label})", s, kf_frames, launches, set())
    return dict(ate_m=ate, keyframe_frames=kf_frames, n_keyframes=s.n_keyframes,
                n_points=s.n_points, gates={g: v for g, (v, _) in gates.items()},
                counts=[(x.n_features, x.n_matches, x.n_inliers) for x in stats],
                ba_iters=s.ba_iters, frame_ms_median=float(np.median(fm[1:])),
                frame_ms=rec["frame_ms"], syncs=rec["syncs"], launches=launches)


def main_path7a(system, all_kernels, plains) -> tuple:
    """The three scenes through ``SlamSystem`` on the card (MapCaps(max_kf=32,
    max_pt=8192), no vocabulary), their launches counted together; a second
    run of the moving object giving identical maps; every top-2 launch of the
    moving-object run held bit for bit against the plain version -> (report,
    launches)."""
    from vo_slam_test_tpu_torch.ops import match_cuda, match_pallas
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    t0 = time.perf_counter()
    scenes = scene_sequences()
    frames = {k: [q[i] for i in range(len(q))] for k, (q, _) in scenes.items()}
    print(f"main path 7a data: the moving object (SyntheticRGBD(n_frames=12, seed=41, "
          f"motion_scale=0.5, moving_patch=(0.9, 0.06))), sparse texture (n_frames=12, seed=43, "
          f"motion_scale=0.4, texture_corners=0.06) and Milestone B (n_frames=10, seed=21, "
          f"motion_scale=0.5) rendered in {time.perf_counter() - t0:.1f} s")
    on_moving = lambda f, args: lrec.tag == "moving object"  # noqa: E731
    report, runs = {}, {}
    with PlainGuard(plains) as guard:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        with LaunchRecorder([(match_cuda, "masked_top2", on_moving)]) as lrec:
            for label, (seq, cfg) in scenes.items():
                before = {k: v.launches for k, v in all_kernels.items()}
                lrec.tag = label
                s = system.SlamSystem(cfg, caps=MapCaps(**SCENE_CAPS))
                rec = run_timed(s, frames[label], lrec)
                lrec.tag = None
                report[label] = scene_report(label, s, rec, seq, {
                    k: v.launches - before[k] for k, v in all_kernels.items()})
                runs[label] = s
        launches = {k: v.launches for k, v in all_kernels.items()}
        # the determinism check: the moving object again (the most
        # rounding-sensitive of the three: its patch's matches sit near the gates)
        again = system.SlamSystem(scenes["moving object"][1], caps=MapCaps(**SCENE_CAPS))
        for f in frames["moving object"]:
            again.track(*f)
    check_same_maps("main path 7a (moving object)", runs["moving object"], again)
    print(f"  kernel launches (the three scenes): {launches}; plain versions on CUDA: "
          f"{guard.cuda_calls}")
    if guard.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard.cuda_calls}")
    if min(v for k, v in launches.items() if k not in OFF_PATH) < 1:
        raise AssertionError(f"main path 7a launched no "
                             f"{[k for k, v in launches.items() if not v and k not in OFF_PATH]}")
    # the moving-object run's own top-2 launches against the plain version
    sites = {"frame pair": [], "local map": [], "chi2 fuse": []}
    for f, args, kw in lrec.got["masked_top2"]:
        site = ("chi2 fuse" if kw.get("chi2_gate") else
                "local map" if kw.get("kernel") is match_cuda.KERNEL_LOCAL else "frame pair")
        check_equal(f"masked_top2 ({site}) at frame {f} of the moving-object run",
                    match_cuda.masked_top2(*args, **kw),
                    match_pallas.masked_top2_plain(*args, **{k: v for k, v in kw.items()
                                                             if k != "kernel"}), TOP2_OUTS)
        sites[site].append(f)
    if not (sites["frame pair"] and sites["local map"]):
        raise AssertionError(f"main path 7a: top-2 launches recorded on the moving object {sites}")
    print(f"  moving object: every top-2 launch of the run bit-equal to the plain version, by "
          f"site (frames): {sites}")
    report["moving_object_top2_bit_equal"] = {k: len(v) for k, v in sites.items()}
    return report, launches


def main_path7b(ba_cuda, ba_pallas, all_kernels, dev) -> tuple:
    """Local BA past every cap: tests/test_local_ba_saturation.py's seed-3
    dense map (``datasets/synth_map.build`` on the card: 40 keyframes, 3500
    points, spans up to 24 keyframes, MapCaps(64, 4096, 24, 256)) around
    keyframe 20. The window keeps the strongest covisibles, observers enter
    valid-first; one ``local_bundle_adjust`` on the local points moved by
    N(0, 2 cm) at least halves the window's reprojection error and moves
    nothing outside the problem; rows 7-9 on its first LM iteration within
    ``check_ba``'s tolerances of their plain versions, timed -> (report,
    {row key: its saturated-window numbers})."""
    from vo_slam_test_tpu_torch.datasets import synth_map
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import local_ba

    caps = MapCaps(*SAT_CAPS)
    t0 = time.perf_counter()
    m, cam = synth_map.build(caps, n_kf=40, n_pt=3500, seed=3, span_max=24, device=dev)
    build_s = time.perf_counter() - t0
    covis = (m.covis[SAT_CENTER] * m.kf_valid).cpu().numpy()
    prob = local_ba.build_problem_ol(m, SAT_CENTER, caps)
    kf_ids, pids = prob.kf_ids.cpu().numpy(), prob.pt_ids.cpu().numpy()
    win = kf_ids[:local_ba.W_KF]
    unsel = np.setdiff1d(np.nonzero(covis > 0)[0], win)
    o_valid = prob.o_valid.cpu().numpy()
    most_obs = int(m.pt_obs_cnt.max())
    window = dict(connected=int((covis > 0).sum()), window=win.tolist(),
                  fixed=int((kf_ids[local_ba.W_KF:] >= 0).sum()),
                  live_points=int((pids >= 0).sum()), most_observers=most_obs, weakest_selected=int(covis[win[1:]].min()),
                  strongest_left_out=int(covis[unsel].max()))
    print(f"main path 7b (local BA past its caps; the map built on the card in {build_s:.1f} s): "
          f"{window}")
    if not (window["connected"] > local_ba.W_KF and (win >= 0).all() and win[0] == SAT_CENTER
            and window["weakest_selected"] >= window["strongest_left_out"]
            and most_obs > local_ba.O_BA):
        raise AssertionError(f"main path 7b: the window is not saturated or not the strongest "
                             f"covisibles: {window}")
    if (o_valid[1:] & ~o_valid[:-1]).any():
        raise AssertionError("main path 7b: an observer slot is valid after an invalid one")

    sel = np.sort(pids[pids >= 0])
    pt = m.pt_pos.cpu().numpy().copy()
    pt[sel] += np.random.default_rng(0).normal(0, 0.02, (len(sel), 3)).astype(np.float32)
    m = m.replace(pt_pos=torch.as_tensor(pt).to(dev))
    before = reproj_rmse(m, cam, win)
    torch.cuda.synchronize()
    for k in all_kernels.values():
        k.reset()
    with BaCapture(ba_cuda) as cap:
        (m2, n1, n2), ba_ms = cuda_ms(lambda: local_ba.local_bundle_adjust_iters(
            m, SAT_CENTER, caps, cam))
    launches = {k: v.launches for k, v in all_kernels.items()}
    after = reproj_rmse(m2, cam, win)
    kf_out = np.ones(caps.max_kf, bool)
    kf_out[kf_ids[kf_ids >= 0]] = False
    pt_out = np.ones(caps.max_pt, bool)
    pt_out[sel] = False
    moved_out = (int((m2.kf_pose.cpu().numpy()[kf_out] != m.kf_pose.cpu().numpy()[kf_out]).sum()),
                 int((m2.pt_pos.cpu().numpy()[pt_out] != pt[pt_out]).sum()))
    print(f"  local_bundle_adjust: LM iterations ({n1}, {n2}) in {ba_ms:.3f} ms; window "
          f"reprojection RMSE {before:.4f} -> {after:.4f} px; entries moved outside the problem "
          f"(poses, points) {moved_out}; launches {launches}")
    if not after < 0.5 * before or moved_out != (0, 0):
        raise AssertionError(f"main path 7b: reprojection {before} -> {after} px, moved outside "
                             f"the problem {moved_out}")
    if any(launches[k] != n1 + n2 for k in ("ba_acc", "ba_cost", "ba_backsub")):
        raise AssertionError(f"main path 7b: BA launches {launches} != {n1 + n2} LM iterations")

    inst, sub = cap.instance()
    rows = {}
    where = "the saturated window's first LM iteration"
    for key, spec in ba_kernel_specs(ba_cuda, ba_pallas).items():
        kname, kfn, pfn, kind, _ = spec
        err = hold_ba(ba_cuda, spec, where, inst, sub)
        timed = (ba_carried_acc(ba_cuda, ba_pallas, inst, kfn(inst, sub), dev, where)
                 if key == "ba_acc" else (lambda: kfn(inst, sub)))
        kb, kby, counted = ba_bound(kind, inst)
        O, L = inst["slot"].shape
        rows[key] = dict(shape=f"WF={inst['posesT'].shape[1]} wk={inst['wk']} O={O} L={L}",
                         launches=launches[key], max_abs_err=err, ms=time_graph_ms(timed),
                         plain_ms=time_eager_ms(lambda: pfn(inst, sub)), bound_ms=kb,
                         bound_by=kby, counted=counted)
        print(f"  {kname} on {where}: within tolerance of the plain version, two launches "
              f"bit-equal; counted {counted}; kernel {rows[key]['ms']:.4f} ms, plain "
              f"{rows[key]['plain_ms']:.4f} ms, bound {kb:.6f} ms ({kby})")
        if rows[key]["ms"] < kb:
            raise AssertionError(f"{kname} on {where} timed under its bound: {rows[key]}")
    report = dict(window, lm_iterations=[n1, n2], ba_ms=ba_ms, reproj_px=[before, after],
                  launches=launches, build_s=build_s)
    return report, rows


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
    all_kernels, plains = kernel_counters(), plain_versions()
    ba_keys = ("ba_acc", "ba_cost", "ba_backsub")

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

    # -- phase 1b: FAST with 3x3 NMS (fast_score(..., with_nms=True)) --------
    # the main path's pyramid, and random integers in [0, 255] (many ties);
    # each equal to the plain version on every pixel and to the first design
    # (perf/fast_nms_v1.cu) bit for bit
    rand_levels = fast_nms_random_levels(dev)
    nms_v1 = fast_nms_v1_launcher(_build)
    fast_cuda.KERNEL_NMS.reset()
    for label, lv in (("the main path's pyramid", levels), ("random integers", rand_levels)):
        got = fast_cuda.fast_score(lv, with_nms=True)
        want = fast.fast_score_nms(lv)
        if not torch.equal(got, want):
            raise AssertionError(f"FAST NMS kernel differs from the plain version on {label}: "
                                 f"{int((got != want).sum())} pixels")
        if not bits_equal(got, fast_call(nms_v1, lv)):
            raise AssertionError(f"FAST NMS kernel differs from its first design "
                                 f"(perf/fast_nms_v1.cu) on {label}")
        kept = int((got > 0).sum())
        print(f"phase fast NMS on {label} {list(lv.shape)}: equal on every pixel, bit-equal to "
              f"the first design; {kept} kept, {int((fast.fast_score(lv) > 0).sum())} with a "
              f"score")
    nms_phase_launches = fast_cuda.KERNEL_NMS.launches
    nb, nby, counted = fast_bound(levels, nms=True)

    def in_turns(lv):
        """(kernel ms, first design ms) on ``lv``, timed in turns: kernel,
        first design, first design, kernel; each the mean of its two turns."""
        new = lambda: fast_cuda.fast_score(lv, with_nms=True)  # noqa: E731
        old = lambda: fast_call(nms_v1, lv)  # noqa: E731
        t = [time_graph_ms(fn) for fn in (new, old, old, new)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    ms, v1_ms = in_turns(levels)
    random_ms, random_v1_ms = in_turns(rand_levels)
    kernels["fast_nms"] = dict(
        name="fast_score_nms", shape=f"{L}x{H}x{W}", route="cuda",
        source="vo_slam_test_tpu_torch/csrc/fast.cu",
        replaces="vo_slam_test_tpu/ops/fast_pallas.py:131", max_abs_err=0.0,
        ms=ms, v1_ms=v1_ms, plain_ms=time_eager_ms(lambda: fast.fast_score_nms(levels)),
        bound_ms=nb, bound_by=nby, library_ms=None, counted=counted,
        phase_launches=nms_phase_launches, random_ms=random_ms, random_v1_ms=random_v1_ms,
        random_bound_ms=fast_bound(rand_levels, nms=True)[0])
    print(f"  kernel {ms:.4f} ms (first design {v1_ms:.4f} ms, raw mode "
          f"{kernels['fast']['ms']:.4f}), plain {kernels['fast_nms']['plain_ms']:.4f} ms, bound "
          f"{nb:.4f} ms ({nby}); on the random batch {random_ms:.4f} ms (first design "
          f"{random_v1_ms:.4f} ms), bound {kernels['fast_nms']['random_bound_ms']:.4f} ms; "
          f"{nms_phase_launches} checked launches")

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
    ba_seeded = random_ba_instance(np.random.default_rng(2), 64, 24, 12, 8192, 1500, dev)
    sub_rng = np.random.default_rng(3)
    ba_insts = {}
    for label, inst in (("captured", captured["ba"]), ("seeded", ba_seeded)):
        mask = ba_cuda.ba_mask(inst["slot"].shape[1], dev)
        acc = ba_cuda.ba_accumulate(*ba_acc_args(inst), n_pts=inst["n_pts"], mask=mask)
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
    ba_specs = ba_kernel_specs(ba_cuda, ba_pallas)
    for key, (kname, kfn, pfn, kind, replaces) in ba_specs.items():
        err = 0.0
        for label, (inst, sub) in ba_insts.items():
            err = max(err, hold_ba(ba_cuda, ba_specs[key], f"the {label} instance", inst, sub))
            print(f"phase {kname} {label}: within tolerance of the plain version, two launches "
                  f"bit-equal{', cost bit-equal to ba_cost' if kind == 'acc' else ''}; "
                  f"{ba_counts(inst)}")
        inst, sub = ba_insts["captured"]
        kb, kby, counted = ba_bound(kind, inst)
        O, L = inst["slot"].shape
        timed, note = (lambda: kfn(inst, sub)), ""
        if key == "ba_acc":
            timed = ba_carried_acc(ba_cuda, ba_pallas, inst, kfn(inst, sub), dev,
                                   "the captured instance")
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

    # -- main path 4: the kidnap, SlamSystem with a vocabulary ------------------
    t0 = time.perf_counter()
    kseq, kcfg = kidnap_sequence()
    voc = kidnap_vocabulary(kseq, kcfg, dev)
    kframes, kframes_poor = kidnap_frames(kseq, False), kidnap_frames(kseq, True)
    print(f"main path 4 data: the kidnap sequence (SyntheticRGBD(n_frames=12, seed=31, "
          f"motion_scale=0.3) frames 0-7, three black frames, frames 2-5) and its vocabulary "
          f"(k={voc.k}, levels={voc.levels}, {int(sum(v.sum() for v in voc.node_valid[-1:]))} "
          f"words, from the port's extract_fused descriptors of frames 0-2) in "
          f"{time.perf_counter() - t0:.1f} s")
    on_black = lambda f, args: 8 <= f <= 10  # noqa: E731
    recorded = [(fast_cuda, "fast_score", on_black), (match_cuda, "masked_top2", on_black),
                (match_cuda, "masked_top1_epi", lambda f, args: True)]
    # the path is its three variants; their launches are counted together
    with PlainGuard(plains) as guard4:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        with LaunchRecorder(recorded) as lrec:
            s4, r4 = run_kidnap(system, kcfg, voc, kframes, False, lrec)
            s4p, r4p = run_kidnap(system, kcfg, voc, kframes_poor, False, lrec)
            s4q, r4q = run_kidnap(system, kcfg, voc, kframes, True, lrec)
        launches4 = {k: v.launches for k, v in all_kernels.items()}
        s4b, r4b = run_kidnap(system, kcfg, voc, kframes, False, profile_frames=(10, 11, 12))
    print("main path 4 (SlamSystem(vocabulary=...), the kidnap at 640x480, "
          "MapCaps(max_kf=32, max_pt=8192)):")
    kid = {"default": kidnap_report("default", s4, r4)}
    kidnap_report("default, second run", s4b, r4b)
    check_same_maps("main path 4 (default)", s4, s4b)
    print("  the second run's frames 10 (lost), 11 (relocalized) and 12 (tracked), events "
          "and the profiler's wall ms include its overhead:")
    prof4, wall4 = r4b["profile"]
    busy4, nl4 = device_profile(prof4, 3, wall4)
    kid["profile_frames_10_12"] = dict(device_busy_ms=busy4, kernels_per_frame=nl4,
                                       wall_ms=wall4)
    kid["depth_poor"] = kidnap_report("depth-poor return frames (EPnP)", s4p, r4p)
    kid["reloc_parity"] = kidnap_report("reloc_parity=True", s4q, r4q)
    print(f"  kernel launches (the three variants): {launches4}; plain versions on CUDA: "
          f"{guard4.cuda_calls}")
    if kid["reloc_parity"]["reloc"][0] != kid["default"]["reloc"][0]:
        raise AssertionError(f"main path 4: parity mode relocalized at "
                             f"{kid['reloc_parity']['reloc']}, the default at "
                             f"{kid['default']['reloc']}")
    if min(v for k, v in launches4.items() if k not in OFF_PATH) < 1:
        raise AssertionError(f"main path 4 launched no "
                             f"{[k for k, v in launches4.items() if not v and k not in OFF_PATH]}")
    if guard4.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard4.cuda_calls}")

    # the path's own launches against the plain versions: every epipolar
    # search (featVec groups live: a 3-level vocabulary puts every word in
    # bucket 0), and FAST and the top-2 on the black frames of each variant
    epi_calls = lrec.got["masked_top1_epi"]
    epi_err, epi_rows = 0.0, []
    for f, args, _ in epi_calls:
        if not bool((args[4] >= 0).any() and (args[10] >= 0).any()):
            raise AssertionError(f"main path 4: an epipolar search at frame {f} had no live group")
        epi_err = max(epi_err, check_equal(
            f"masked_top1_epi at frame {f} of main path 4", match_cuda.masked_top1_epi(*args),
            match_pallas.masked_top1_epi_plain(*args), ("best_i", "best_d")))
        epi_rows.append(int(args[5].sum()))
    dead_epi = sum(r == 0 for r in epi_rows)
    kernels["top1_epi"]["max_abs_err"] = max(kernels["top1_epi"]["max_abs_err"], epi_err)
    kernels["top1_epi"]["kidnap_instances"] = dict(launches=len(epi_calls), live_rows=epi_rows,
                                                   bit_equal=True)
    print(f"  masked_top1_epi: all {len(epi_calls)} launches of the path (live rows "
          f"{epi_rows}, featVec groups live) bit-equal to the plain version; {dead_epi} with no "
          f"live row")
    black = {"fast_score": [], "masked_top2": []}
    for f, (levels,), _ in lrec.got["fast_score"]:
        if bool(levels.any()):
            raise AssertionError(f"main path 4: black frame {f}'s pyramid is not all zero")
        check_equal(f"fast_score on black frame {f}", (fast_cuda.fast_score(levels),),
                    (fast.fast_score(levels),), ("score",))
        black["fast_score"].append(f)
    for f, args, kw in lrec.got["masked_top2"]:
        if bool(args[14].any()):
            raise AssertionError(f"main path 4: a top-2 search on black frame {f} had a target")
        check_equal(f"masked_top2 on black frame {f}", match_cuda.masked_top2(*args, **kw),
                    match_pallas.masked_top2_plain(*args, **{k: v for k, v in kw.items()
                                                             if k != "kernel"}), TOP2_OUTS)
        black["masked_top2"].append((f, args[0].shape[0], int(args[9].sum())))
    if len(black["fast_score"]) != 9 or len(black["masked_top2"]) < 9:
        raise AssertionError(f"main path 4: black-frame launches {black}")
    print(f"  black frames 8-10 of the three variants: FAST on the all-zero pyramids of frames "
          f"{black['fast_score']}, "
          f"top-2 searches with no target (frame, M, live source rows) {black['masked_top2']}; "
          f"each bit-equal to its plain version")

    # -- main path 5: the pan loop; loop closing and global BA -----------------
    t0 = time.perf_counter()
    pseq, pcfg = pan_sequence()
    pframes = [pseq[i] for i in range(len(pseq))]
    pgt = np.stack([pseq.poses[i] for i in range(len(pseq))])
    pvoc = pan_vocabulary(pseq, pcfg, dev)
    print(f"main path 5 data: the pan loop of tests/test_loop_e2e.py ({len(pframes)} frames, "
          f"SyntheticRGBD(seed=41), camera_fps=3) and its vocabulary (k={pvoc.k}, "
          f"levels={pvoc.levels}, from the port's extract_fused descriptors of frames "
          f"{PAN_VOC_FRAMES}; centroid sum "
          f"{sum(int(c.cpu().numpy().view(np.uint32).astype(np.uint64).sum()) for c in pvoc.centroids)}) "
          f"in {time.perf_counter() - t0:.1f} s")
    on_loop_fuse = lambda f, args: lrec5.tag == "loop_fuse"  # noqa: E731
    with PlainGuard(plains) as guard5:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        by_variant = {}
        with LaunchRecorder([(match_cuda, "masked_top2", on_loop_fuse)]) as lrec5:
            for label, chunk_v, gba in ((f"chunk={PAN_CHUNK}", PAN_CHUNK, False),
                                        ("chunk=1", 1, False),
                                        (f"chunk={PAN_CHUNK}, global BA", PAN_CHUNK, True)):
                before = {k: v.launches for k, v in all_kernels.items()}
                by_variant[label] = run_pan(system, pcfg, pvoc, pframes, chunk_v, gba, lrec5)
                by_variant[label][1]["launches"] = {k: v.launches - before[k]
                                                    for k, v in all_kernels.items()}
        launches5 = {k: v.launches for k, v in all_kernels.items()}
        (s5, r5), (s5f, r5f), (s5g, r5g) = by_variant.values()
        # the determinism run (global BA included) carries the profiler window
        # over the closing chunk
        s5gb, r5gb = run_pan(system, pcfg, pvoc, pframes, PAN_CHUNK, True,
                             profile_frames=(40, 41, 42, 43))
        s5o, r5o = run_pan(system, pcfg, pvoc, pframes, PAN_CHUNK, False, sever_old=False)
    print("main path 5 (SlamSystem(vocabulary=...), the pan loop at 640x480 with the drift "
          "injected by inject_drift + pan_sever_old, MapCaps(max_kf=32, max_pt=8192)):")
    pan = {f"chunk={PAN_CHUNK}": pan_report(f"chunk={PAN_CHUNK}", s5, r5, pgt),
           "chunk=1": pan_report("chunk=1", s5f, r5f, pgt),
           f"chunk={PAN_CHUNK}, global BA": pan_report(f"chunk={PAN_CHUNK}, global BA", s5g, r5g,
                                                       pgt)}
    # the JAX package's own instrument (old keyframes keep their island
    # points): local BA pulls the island back at frame 36 and no loop closes,
    # as in the JAX package's run on the CPU (perf/loop_path5_jax_cpu.py)
    one_sided = dict(closures=s5o.loop_closures, attempts=s5o.loop_attempts,
                     residual_m=island_residual(r5o["pre_poses"], r5o["pre_valid"], r5o["kf_cut"],
                                                s5o.map.kf_pose.cpu().numpy()).tolist())
    print(f"  chunk={PAN_CHUNK} with the JAX package's one-sided sever: {one_sided}; the JAX "
          f"package on the CPU: {JAX_CPU_PAN_ONE_SIDED}")
    if (s5o.loop_closures, s5o.loop_attempts) != (JAX_CPU_PAN_ONE_SIDED["closures"],
                                                  JAX_CPU_PAN_ONE_SIDED["attempts"]):
        raise AssertionError(f"main path 5 with the one-sided sever: {one_sided}, the JAX "
                             f"package on the CPU: {JAX_CPU_PAN_ONE_SIDED}")
    pan["one_sided_sever"] = one_sided
    check_same_maps(f"main path 5 (chunk={PAN_CHUNK}, global BA)", s5g, s5gb)
    print(f"  the second chunk={PAN_CHUNK} global-BA run's chunk of frames 40-43 (the closing "
          f"event and the global BA), events and the profiler's wall ms include its overhead:")
    prof5, wall5 = r5gb["profile"]
    busy5, nl5 = device_profile(prof5, 4, wall5)
    pan["profile_frames_40_43"] = dict(device_busy_ms=busy5, kernels_per_frame=nl5, wall_ms=wall5)
    if len(r5g["gba_ms"]) != 1 or r5["gba_ms"] or r5f["gba_ms"]:
        raise AssertionError(f"main path 5: global BA ran {len(r5g['gba_ms'])} times with it on, "
                             f"{len(r5['gba_ms']) + len(r5f['gba_ms'])} with it off")
    # the loop fuse (row 4 at its new site): every launch of the three
    # variants' corrections held bit for bit against the plain version
    fuse_calls = lrec5.got["masked_top2"]
    for f, args, kw in fuse_calls:
        check_equal(f"masked_top2 (chi2) of the loop fuse at frame {f}",
                    match_cuda.masked_top2(*args, **kw),
                    match_pallas.masked_top2_plain(*args, **kw), TOP2_OUTS)
    if not fuse_calls or not all(kw.get("chi2_gate") for _, _, kw in fuse_calls):
        raise AssertionError(f"main path 5: {len(fuse_calls)} loop-fuse launches recorded")
    fuse_rows = [(f, int(args[9].sum()), int((match_cuda.masked_top2(*args, **kw)[1] <= 50).sum()))
                 for f, args, kw in fuse_calls]
    kernels["top2_chi2"]["loop_fuse_instances"] = dict(launches=len(fuse_calls), bit_equal=True,
                                                       frame_live_matched=fuse_rows)
    print(f"  loop fuse: {len(fuse_calls)} chi2 top-2 launches over the three variants' "
          f"corrections (frame, live rows, rows matched <= TH_LOW): {fuse_rows}; each bit-equal "
          f"to the plain version")
    print(f"  kernel launches (the three variants): {launches5}; plain versions on CUDA: "
          f"{guard5.cuda_calls}")
    if min(v for k, v in launches5.items() if k not in OFF_PATH) < 1:
        raise AssertionError(f"main path 5 launched no "
                             f"{[k for k, v in launches5.items() if not v and k not in OFF_PATH]}")
    if guard5.cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {guard5.cuda_calls}")

    # -- main path 5 through the VO_LOOP_DIAG drain path (chunk=1, drain_chunk=1)
    with PlainGuard(plains) as guard5d:
        torch.cuda.synchronize()
        for k in all_kernels.values():
            k.reset()
        s5d, r5d = run_pan(system, pcfg, pvoc, pframes, 1, False, diag=True)
        launches5d = {k: v.launches for k, v in all_kernels.items()}
    r5d["launches"] = launches5d
    diag_label = "chunk=1, VO_LOOP_DIAG=1, drain_chunk=1"
    pan[diag_label] = pan_report(diag_label, s5d, r5d, pgt)
    no_gates = [a for a in s5d.loop_attempts if len(a) != 4 or not a[3]]
    med_1, med_d = float(np.median(r5f["call_ms"][1:])), float(np.median(r5d["call_ms"][1:]))
    pan[diag_label]["frame_ms_median"] = med_d
    pan["chunk=1"]["frame_ms_median"] = med_1
    print(f"  {diag_label}: every attempt with its gate values {not no_gates}; frame median "
          f"{med_d:.3f} ms against chunk=1's {med_1:.3f} ms in this call; plain versions on CUDA: "
          f"{guard5d.cuda_calls}")
    if no_gates or guard5d.cuda_calls or min(v for k, v in launches5d.items()
                                             if k not in OFF_PATH) < 1:
        raise AssertionError(f"main path 5 ({diag_label}): attempts without gate values "
                             f"{no_gates}, launches {launches5d}, plain versions on CUDA "
                             f"{guard5d.cuda_calls}")

    # -- global BA on a scene where it takes its steps -----------------------
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    print("phase global BA on tests/test_global_ba.py's fabricated scene (6 keyframes, 400 "
          "points, poses and points perturbed; float64 solve):")
    gba_rows = {"tests' caps": run_gba_scene("the tests' caps", MapCaps(16, 2048, 12, 256), dev,
                                             True),
                "default MapCaps": run_gba_scene("the default MapCaps", MapCaps(), dev, False)}

    # -- the multi-device solvers: 8 shards on the one card ------------------
    mesh_rows = run_mesh_phase(s1, dev)

    # -- BoW at ORBvoc scale: transform, bow_vector, scores_vs_keyframes -------
    from vo_slam_test_tpu_torch.bow import retrieval as bow_ret
    from vo_slam_test_tpu_torch.bow import vocabulary as bow_voc
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused

    big = bow_voc.synth_vocabulary(k=10, levels=6, seed=0, device=dev)
    cent_mb = sum(c.numel() * 4 for c in big.centroids) / 1e6
    feats_b = [extract_fused(torch.as_tensor(g).to(dev), torch.as_tensor(d).to(dev), s4.camera,
                             s4.spec, s4.budgets) for g, d, _ in kframes[:8] + kframes[11:12]]
    kf_vecs = [bow_ret.bow_vector(bow_voc.transform(big, f.desc, f.valid), big.idf)
               for f in feats_b[:8]]
    K = 32
    kf_word = torch.full((K, feats_b[0].valid.shape[0]), bow_ret.PAD_WORD, dtype=torch.int32,
                         device=dev)
    kf_weight = torch.zeros(kf_word.shape, device=dev)
    kf_word[:8] = torch.stack([u for u, _ in kf_vecs])
    kf_weight[:8] = torch.stack([w for _, w in kf_vecs])
    kf_on = (torch.arange(K, device=dev) < 8).to(torch.float32)
    q = feats_b[8]
    words = bow_voc.transform(big, q.desc, q.valid)
    uniq, wgt = bow_ret.bow_vector(words, big.idf)
    score, shared = bow_ret.scores_vs_keyframes(uniq, wgt, kf_word, kf_weight, kf_on)
    big_cpu = big.to("cpu")
    words_c = bow_voc.transform(big_cpu, q.desc.cpu(), q.valid.cpu())
    uniq_c, wgt_c = bow_ret.bow_vector(words_c, big_cpu.idf)
    score_c, shared_c = bow_ret.scores_vs_keyframes(uniq_c, wgt_c, kf_word.cpu(), kf_weight.cpu(),
                                                    kf_on.cpu())
    self_score = bow_ret.scores_vs_keyframes(uniq, wgt, uniq[None], wgt[None], kf_on[:1])[0]
    if not (torch.equal(words.cpu(), words_c) and torch.equal(uniq.cpu(), uniq_c)
            and torch.equal(shared.cpu(), shared_c)
            and torch.allclose(wgt.cpu(), wgt_c, rtol=1e-6, atol=0)
            and torch.allclose(score.cpu(), score_c, rtol=1e-6, atol=1e-7)
            and abs(float(self_score[0]) - 1.0) < 1e-4):
        raise AssertionError("BoW at ORBvoc scale: the card's words, weights or scores differ "
                             "from the same calls on the CPU")
    bow_ms = dict(transform=time_eager_ms(lambda: bow_voc.transform(big, q.desc, q.valid)),
                  bow_vector=time_eager_ms(lambda: bow_ret.bow_vector(words, big.idf)),
                  scores_vs_keyframes=time_eager_ms(lambda: bow_ret.scores_vs_keyframes(
                      uniq, wgt, kf_word, kf_weight, kf_on)))
    print(f"phase BoW at ORBvoc scale (synth_vocabulary k=10 levels=6: {big.n_words} words, "
          f"{cent_mb:.1f} MB of centroids and {big.idf.numel() * 4 / 1e6:.1f} MB of idf on the "
          f"card): frame 11's {int(q.valid.sum())} descriptors -> {int((uniq < bow_ret.PAD_WORD).sum())} "
          f"words, scored against {int(kf_on.sum())} keyframes of {K} slots (shared words "
          f"{shared[:8].tolist()}, best score {float(score.max()):.6f}); words, weights and scores "
          f"equal to the CPU's; ms per call (CUDA events, launches included): {bow_ms}")

    # -- main path 6: the CLI on files ---------------------------------------
    cli, launches6 = main_path6(room, room_frames, room_cfg, frames, cfg, gt, all_kernels,
                                plains, dev)
    if min(launches6[k] for k in ("fast", "orb", "top2")) < 1:
        raise AssertionError(f"path 6 launched no FAST, ORB or frame-pair top-2: {launches6}")

    # -- main path 7: the off-nominal scenes, and local BA past its caps -------
    t7 = time.perf_counter()
    scenes7, launches7 = main_path7a(system, all_kernels, plains)
    saturated, sat_rows = main_path7b(ba_cuda, ba_pallas, all_kernels, dev)
    for k in ba_keys:
        kernels[k]["saturated_window"] = sat_rows[k]
    print(f"  main path 7 in {time.perf_counter() - t7:.1f} s")

    for k in ("fast", "orb", "top2") + OFF_PATH:
        kernels[k]["launches"] = launches1[k]
    for k in ("top2_m4096", "top2_chi2", "top2_nb", "top1_epi") + ba_keys:
        kernels[k]["launches"] = launches2[k]
    for k in kernels:
        kernels[k]["launches_by_path"] = {"1": launches1[k], "2": launches2[k],
                                          "3": launches3[k], "4": launches4[k],
                                          "5": launches5[k], "5 VO_LOOP_DIAG": launches5d[k],
                                          "6": launches6[k], "7": launches7[k]}
    on_paths = {k: kernels[k]["launches_by_path"] for k in OFF_PATH
                if any(kernels[k]["launches_by_path"].values())}
    if on_paths:
        raise AssertionError(f"a path launched a kernel that no path calls: {on_paths}")
    # ba_accumulate is two launches in a row, the others one
    for k, v in kernels.items():
        v["launch_floor_x"] = v["ms"] / floor["launches_2" if k == "ba_acc" else "launches_1"]
    under = {k: (v["ms"], v["bound_ms"]) for k, v in kernels.items() if v["ms"] < v["bound_ms"]}
    if under:
        raise AssertionError(f"kernels timed under their bounds, so the bounds are wrong: {under}")
    keys = ("name", "shape", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "v1_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launch_floor_x", "counted", "kidnap_instances", "loop_fuse_instances",
            "phase_launches", "random_ms", "random_v1_ms", "random_bound_ms", "saturated_window")
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
        "kidnap": dict(kid, launches=launches4, bow_orbvoc_ms=bow_ms),
        "pan_loop": dict(pan, launches=launches5),
        "global_ba_scene": gba_rows,
        "mesh_8_shards_one_card": mesh_rows,
        "cli_on_files": {k: {kk: vv for kk, vv in v.items() if kk != "stdout"}
                         for k, v in cli.items()},
        "off_nominal_scenes": scenes7, "saturated_local_ba": saturated,
        "card": smi}}))
    order = ("fast", "orb", "top2", "top2_m4096", "top2_chi2", "top2_nb", "top1_epi") + ba_keys \
        + OFF_PATH
    print(json.dumps({"kernels": [{key: kernels[k][key] for key in keys if key in kernels[k]}
                                  for k in order]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
