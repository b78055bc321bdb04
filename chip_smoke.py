#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vo_slam_test_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card and its power limit;
2. builds the three CUDA kernels from ``vo_slam_test_tpu_torch/csrc`` with nvcc
   (sm_90a, one nvcc per source, all started together);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (FAST on a frame's [8,480,640] pyramid, IC angle +
   rBRIEF on its 1024 selected keypoints, Hamming top-2 at 1024x1024 on a real
   frame pair and on a seeded instance with ties and empty rows) and times
   both with CUDA events;
4. drives the main path: the port's FusedTracker over the synthetic 640x480
   sequence (30 frames, 1000 features, 8 levels: the fr1 extraction
   settings, as ``run_slam --synthetic`` uses) and checks 30/30 tracked frames,
   ATE < 1 cm, that every kernel's launch count rose, and that no plain
   version saw a CUDA tensor;
5. prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line. Any failed check raises: the exit code is then non-zero and no result
   line is printed. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# published H100 SXM peaks (dense): HBM bandwidth and scalar f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the f32 rate (32-bit integer work counted at that rate)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
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


def random_top2_instance(rng, M, N, device):
    """Seeded instance with clustered windows, duplicated target descriptors
    (distance ties) and 16 rows with nothing allowed."""
    a = rng.integers(0, 2**32, size=(M, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(N, 8), dtype=np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]
    row_ok = rng.random(M) < 0.85
    row_ok[:16] = False
    lo = rng.integers(-1, 4, M).astype(np.int32)
    arrs = [
        a.view(np.int32), b.view(np.int32),
        rng.uniform(0, 640, M).astype(np.float32), rng.uniform(0, 480, M).astype(np.float32),
        rng.uniform(0.5, 120, M).astype(np.float32), rng.uniform(-10, 640, M).astype(np.float32),
        rng.uniform(5, 120, M).astype(np.float32), lo,
        (lo + rng.integers(0, 3, M)).astype(np.int32), row_ok,
        rng.uniform(0, 640, N).astype(np.float32), rng.uniform(0, 480, N).astype(np.float32),
        np.where(rng.random(N) < 0.4, -1.0, rng.uniform(0, 640, N)).astype(np.float32),
        rng.integers(0, 8, N).astype(np.int32), rng.random(N) < 0.9,
    ]
    return [torch.as_tensor(np.ascontiguousarray(x)).to(device) for x in arrs]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused, select_keypoints
    from vo_slam_test_tpu_torch.ops import (
        _build, brief, fast, fast_cuda, match_cuda, match_pallas, orb_cuda, orientation, pattern)
    from vo_slam_test_tpu_torch.ops.pyramid import build_pyramid, interior
    from vo_slam_test_tpu_torch.matching import matcher
    from vo_slam_test_tpu_torch.pipeline import tracking

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)} "
          + " ".join(f"{k}={v['seconds']:.2f}s" for k, v in built.items()))
    for k, v in built.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k}.cu: {line.strip()}")

    # -- data: the main path's sequence -------------------------------------
    t0 = time.perf_counter()
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    frames = [seq[i] for i in range(len(seq))]
    print(f"rendered {len(frames)} frames {frames[0][0].shape} in {time.perf_counter() - t0:.1f} s")
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    tracker = tracking.FusedTracker(cfg)
    spec, cam = tracker.spec, tracker.camera
    gray0 = torch.as_tensor(frames[0][0]).to(dev)
    pyr = build_pyramid(gray0, spec)
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
    fb, fby = bound_ms(2 * L * H * W * 4, L * H * W * (16 + 2 * (4 * 16 + 15) + 2))
    kernels["fast"] = dict(
        name="fast_score", route="cuda", source="vo_slam_test_tpu_torch/csrc/fast.cu",
        replaces="vo_slam_test_tpu/ops/fast_pallas.py:131", max_abs_err=err,
        ms=time_graph_ms(lambda: fast_cuda.fast_score(levels)),
        plain_ms=time_eager_ms(lambda: fast.fast_score(levels)),
        bound_ms=fb, bound_by=fby, library_ms=None)
    print(f"phase fast [{L},{H},{W}]: equal on every pixel, candidates equal; "
          f"kernel {kernels['fast']['ms']:.4f} ms, plain {kernels['fast']['plain_ms']:.4f} ms, "
          f"bound {fb:.4f} ms ({fby})")

    # -- phase 2: IC angle + rBRIEF -----------------------------------------
    sel = select_keypoints(pyr, spec, tracker.budgets)
    n_valid = int(sel.valid.sum())
    ang, desc = orb_cuda.orb_angle_desc(pyr.raw, pyr.blur, sel.level, sel.ys, sel.xs)
    ang_ref = orientation.ic_angle(pyr.raw, sel.level, sel.ys, sel.xs)
    desc_ref = brief.compute_descriptors(pyr.blur, sel.level, sel.ys, sel.xs, ang_ref)
    d = (ang - ang_ref).abs()
    ang_err = float(torch.minimum(d, 360.0 - d).max())
    flips = np.unpackbits((desc ^ desc_ref).cpu().numpy().view(np.uint8), axis=1).sum(1)
    print(f"phase orb N={sel.level.shape[0]} ({n_valid} valid): max angle err {ang_err} deg, "
          f"flipped bits: max {int(flips.max())} per descriptor, {int(flips.sum())} in all")
    if ang_err > 1e-3 or flips.max() > 2:
        raise AssertionError("ORB kernel differs from the plain version beyond tolerance")
    N = sel.level.shape[0]
    n_disc = int(pattern.circular_patch_mask().sum())
    ob, oby = bound_ms(N * (n_disc + 512) * 4 + N * 12 + 256 * 16 + N * 36,
                       N * (4 * n_disc + 256 * 9 + 30))
    kernels["orb"] = dict(
        name="orb_angle_desc", route="cuda", source="vo_slam_test_tpu_torch/csrc/orb.cu",
        replaces="vo_slam_test_tpu/ops/orb_pallas.py:137", max_abs_err=ang_err,
        flipped_bits=int(flips.sum()),
        ms=time_graph_ms(lambda: orb_cuda.orb_angle_desc(
            pyr.raw, pyr.blur, sel.level, sel.ys, sel.xs)),
        plain_ms=time_eager_ms(lambda: brief.compute_descriptors(
            pyr.blur, sel.level, sel.ys, sel.xs,
            orientation.ic_angle(pyr.raw, sel.level, sel.ys, sel.xs))),
        bound_ms=ob, bound_by=oby, library_ms=None)
    print(f"  kernel {kernels['orb']['ms']:.4f} ms, plain {kernels['orb']['plain_ms']:.4f} ms, "
          f"bound {ob:.4f} ms ({oby})")

    # -- phase 3: masked Hamming top-2 --------------------------------------
    depth0 = torch.as_tensor(frames[0][1]).to(dev)
    depth1 = torch.as_tensor(frames[1][1]).to(dev)
    f0 = extract_fused(gray0, depth0, cam, spec, tracker.budgets)
    f1 = extract_fused(torch.as_tensor(frames[1][0]).to(dev), depth1, cam, spec, tracker.budgets)
    eye = torch.eye(4, device=dev)
    pts, pts_ok = tracking._spawn_temp_points(f0, eye, cam)
    real_args = matcher.projection_top2_args(
        pts, f0.desc, f0.octave, pts_ok, f1.uv_und, f1.u_right, f1.octave, f1.desc, f1.valid,
        torch.zeros_like(f1.valid), eye, eye, tracker.scale_factors,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.b, float(cam.width), float(cam.height), 15.0)
    rand_args = random_top2_instance(np.random.default_rng(0), 1024, 1024, dev)
    top2_err = 0.0
    for label, args in (("frame pair", real_args), ("random ties/empty rows", rand_args)):
        got = match_cuda.masked_top2(*args)
        want = match_pallas.masked_top2_plain(*args)
        for g, w, what in zip(got, want, ("best_i", "best_d", "second_i", "second_d")):
            top2_err = max(top2_err, float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"top-2 kernel differs on {label}: {what}")
        n_match = int((got[1] <= matcher.TH_HIGH).sum())
        print(f"phase top2 {label} {tuple(args[0].shape)}x{tuple(args[1].shape)}: "
              f"all four outputs equal; {n_match} rows with best <= {matcher.TH_HIGH}")
    # operations: the gate (~12) on every pair, XOR + popcount + sum + top-2
    # compare (~25) only on the pairs this frame pair allows
    Mr, Nr = real_args[0].shape[0], real_args[1].shape[0]
    n_allowed = int(match_pallas.allowed_mask(*real_args[2:]).sum())
    mb, mby = bound_ms((Mr + Nr) * 32 + Mr * 29 + Nr * 17 + Mr * 16,
                       Mr * Nr * 12 + n_allowed * 25)
    kernels["top2"] = dict(
        name="masked_top2", route="cuda", source="vo_slam_test_tpu_torch/csrc/match.cu",
        replaces="vo_slam_test_tpu/ops/match_pallas.py:121", max_abs_err=top2_err,
        ms=time_graph_ms(lambda: match_cuda.masked_top2(*real_args)),
        plain_ms=time_eager_ms(lambda: match_pallas.masked_top2_plain(*real_args)),
        bound_ms=mb, bound_by=mby, library_ms=None)
    print(f"  frame pair: {n_allowed} allowed pairs; kernel "
          f"{kernels['top2']['ms']:.4f} ms, plain {kernels['top2']['plain_ms']:.4f} ms, "
          f"bound {mb:.5f} ms ({mby})")

    # -- main path -----------------------------------------------------------
    plains = [(fast, "fast_score"), (orientation, "ic_angle"), (brief, "compute_descriptors"),
              (match_pallas, "masked_top2_plain")]
    plain_cuda_calls = []

    def guard(mod, attr):
        fn = getattr(mod, attr)

        def guarded(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                plain_cuda_calls.append(attr)
            return fn(*args, **kw)
        return fn, guarded

    saved = []
    for mod, attr in plains:
        fn, guarded = guard(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, guarded)
    wrappers = {"fast": fast_cuda, "orb": orb_cuda, "top2": match_cuda}
    tracker = tracking.FusedTracker(cfg)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.KERNEL.launches = 0
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
    launches = {k: w.KERNEL.launches for k, w in wrappers.items()}
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)
    traj, stats = tracker.results()
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    ate = ate_rmse(tracker.timestamps, gt, tracker.timestamps, traj)
    n_ok = sum(s.ok for s in stats)
    steady = np.array(frame_ms[1:])
    print(f"main path: tracked {n_ok}/{len(stats)} frames, ATE {ate * 100:.4f} cm; "
          f"matches/frame {[s.n_matches for s in stats]}")
    print(f"  per-frame ms (CUDA events, frames 1..29): median {np.median(steady):.3f}, "
          f"mean {steady.mean():.3f}, min {steady.min():.3f}, max {steady.max():.3f}; "
          f"frame 0 {frame_ms[0]:.3f}; host wall median {np.median(wall_ms[1:]):.3f}")
    print(f"  host syncs per frame (sync debug mode): {syncs}")
    print(f"  kernel launches on the main path: {launches}; plain versions on CUDA: {plain_cuda_calls}")
    if n_ok != len(frames) or not ate < 0.01:
        raise AssertionError(f"main path failed: {n_ok}/{len(frames)} tracked, ATE {ate} m")
    if launches["fast"] != 30 or launches["orb"] != 30 or launches["top2"] < 29:
        raise AssertionError(f"kernel launch counts off on the main path: {launches}")
    if plain_cuda_calls:
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda_calls}")

    # -- where a steady frame's device time goes ----------------------------
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    prof_tracker = tracking.FusedTracker(cfg)
    prof_tracker.track(*frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for gray, depth, ts in frames[1:1 + n_prof]:
            prof_tracker.track(gray, depth, ts)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / n_prof
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel.setdefault(e.name, [0.0, 0])
            by_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / n_prof
            by_kernel[e.name][1] += 1
    busy = sum(v[0] for v in by_kernel.values())
    n_launch = sum(v[1] for v in by_kernel.values()) / n_prof
    print(f"profile of {n_prof} frames: wall {prof_wall:.3f} ms/frame (profiler on), device busy "
          f"{busy:.3f} ms/frame in {n_launch:.0f} kernels/frame, idle share {1 - busy / prof_wall:.3f}")
    for k, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:8.3f} ms/frame {cnt / n_prof:6.0f}/frame  {k[:90]}")

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

    for k, w in wrappers.items():
        kernels[k]["launches"] = launches[k]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"main_path": {"frame_ms_median": float(np.median(steady)),
                                    "ate_m": float(ate), "host_syncs": syncs, "card": smi}}))
    print(json.dumps({"kernels": [{key: kernels[k][key] for key in keys} for k in wrappers]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
