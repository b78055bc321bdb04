#!/usr/bin/env python3
"""Times the parts of the first designs of ``ba_accumulate`` and the FAST score
beside the current kernels, on the same inputs, in one run on the card.

    python3 perf/kernel_split.py            # from the repository root

Prints, after the card's name and power limit:

- the throughput of three-input minima (``perf/dpx_bench.cu``): the packed
  16-bit DPX intrinsic against ``min(min(a, b), c)`` on int, the 32-bit DPX
  form, the packed two-input form and f32, and the min/max instructions the
  compiler chose for each (``cuobjdump -sass``);
- the launch floor (``csrc/noop.cu``): one empty launch and two in a row;
- FAST on a frame's [8,480,640] pyramid: the first design
  (``perf/fast_v1.cu``) and the current kernel, in turns, both equal to the
  plain version, and the current kernel on an all-zero batch (staging and
  stores alone);
- ``ba_accumulate`` on the first LM iteration of the local BA with the most
  live points among frames 0-12 of the room orbit: the first design
  (``perf/ba_v1.cu``) whole, launch 1 alone, launch 1 cut to the live
  points, launch 2 alone, its S_red blocks alone, its pose-block blocks alone,
  the newest keyframe's pose block alone and S_red block (0, 0) alone; then
  the current kernel whole and by launch (profiler kernel events), and with
  no live point (what its blocks cost before any work).

All times are CUDA-graph replays (``chip_smoke.time_graph_ms``) unless a
line says otherwise. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = _I

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: cudaError {rc}")
    return call


def stream():
    return torch.cuda.current_stream().cuda_stream


def dpx_phase(_build, dev):
    lib = ctypes.CDLL(str(_build.library_path("dpx_bench", ROOT / "perf")))
    launch = bind(lib, "dpx_bench_launch", [_P, _P, _I, _I, _I, _I, _P])
    rng = np.random.default_rng(0)
    # two 16-bit lanes, each in [0, 512)
    words = rng.integers(0, 512, 4096).astype(np.uint32) | (
        rng.integers(0, 512, 4096).astype(np.uint32) << 16)
    src = torch.as_tensor(words.view(np.int32)).to(dev)
    blocks, threads, n = 132 * 8, 256, 1024
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    names = ["__vimin3_s16x2 / __vimax3_s16x2", "min(min(a,b),c) on int", "__vimin3_s32",
             "__vmins2 twice", "fminf twice"]
    ops = blocks * threads * n * 12  # three-input minima or maxima per launch
    for which, label in enumerate(names):
        ms = chip_smoke.time_graph_ms(
            lambda: launch(src.data_ptr(), out.data_ptr(), which, blocks, threads, n, stream()),
            n_per_graph=4, reps=3)
        # each round of three minima/maxima also holds two XORs on the same pipe
        per_s = ops / (ms * 1e-3)
        print(f"  three-input min/max, {label}: {ms:.4f} ms for {ops:.3e} -> "
              f"{per_s / 1e9:.0f} G/s; with the XORs {per_s * 5 / 3 / 132 / 1.98e9:.1f} "
              f"instructions per SM per clock at 1.98 GHz")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if cuobjdump.is_file():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path("dpx_bench", ROOT / "perf"))],
                              capture_output=True, text=True).stdout
        fn, counts = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {}
            elif fn and ("MNMX" in line or "VIM" in line or "VMNMX" in line):
                op = [t for t in line.replace(";", " ").split() if "MNMX" in t or "VIM" in t][0]
                counts[fn][op] = counts[fn].get(op, 0) + 1
        for fn, c in counts.items():
            print(f"  sass {fn}: {c}")


def fast_phase(_build, dev):
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.ops import fast, fast_cuda
    from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior

    lib = ctypes.CDLL(str(_build.library_path("fast_v1", ROOT / "perf")))
    v1 = bind(lib, "fast_v1_launch", [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _I, _I, _I,
                                      _P])
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    spec = PyramidSpec(640, 480, 8, 1.2)
    levels = interior(build_pyramid(torch.as_tensor(seq[0][0]).to(dev), spec).raw, spec)
    L, H, W = levels.shape
    out = torch.empty((L, H, W), dtype=torch.float32, device=dev)

    def run_v1():
        v1(levels.data_ptr(), levels.stride(0), levels.stride(1), out.data_ptr(), L, H, W,
           stream())

    run_v1()
    want = fast.fast_score(levels)
    got = fast_cuda.fast_score(levels)
    torch.cuda.synchronize()
    print(f"  fast [{L},{H},{W}]: first design equal to plain {torch.equal(out, want)}, current "
          f"equal to plain {torch.equal(got, want)}; live pixels "
          f"{chip_smoke.fast_live_pixels(levels)} of {L * H * W}, level pixels "
          f"{sum(h * w for h, w in spec.sizes)}")
    order = [("first design", run_v1), ("current", lambda: fast_cuda.fast_score(levels)),
             ("current", lambda: fast_cuda.fast_score(levels)), ("first design", run_v1)]
    for label, fn in order:
        print(f"  fast {label}: {chip_smoke.time_graph_ms(fn):.4f} ms")
    # every tile takes the zero exit: staging and stores without the arithmetic
    zeros = torch.zeros_like(levels)
    print(f"  fast current, all-zero batch of the same shape and strides: "
          f"{chip_smoke.time_graph_ms(lambda: fast_cuda.fast_score(zeros)):.4f} ms")


def ba_phase(_build, dev):
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import ba_cuda, match_cuda
    from vo_slam_test_tpu_torch.pipeline import system

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30)
    inst = chip_smoke.capture_instances(match_cuda, ba_cuda, system, cfg,
                                        [room[i] for i in range(13)])["ba"]
    counts = chip_smoke.ba_counts(inst)
    O, L = inst["slot"].shape
    WF, wk = inst["posesT"].shape[1], inst["wk"]
    n = counts["live_points"]
    print(f"  captured BA instance: WF={WF} wk={wk} O={O} L={L}; {counts}")
    slot, povar = inst["slot"][:, :n], inst["povar"][:, :n] > 0
    per_slot = [int(((slot == a) & povar).any(0).sum()) for a in range(wk)]
    print(f"  points per window slot: {per_slot}")
    has = torch.stack([((slot == a) & povar).any(0) for a in range(wk)]).float()
    both = (has @ has.T).long()
    off = both - torch.diag(torch.diag(both))
    print(f"  points per S_red block: {int((both > 0).sum())} of {wk * wk} blocks non-empty, "
          f"largest off-diagonal {sorted(off.flatten().tolist())[-6:]}")

    lib = ctypes.CDLL(str(_build.library_path("ba_v1", ROOT / "perf")))
    v1 = bind(lib, "ba_v1_launch", [_P] * 12 + [_I] * 5 + [_P] * 10 + [_I, _I, _P])
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty(s, **f32) for s in
            ((wk, 36), (wk, 6), (wk * 6, wk * 6), (wk * 6, 1), (1, 1), (9, L), (3, L))]
    wc = torch.zeros((wk, 18, L), **f32)
    cost_pt = torch.empty((L,), **f32)
    mask = torch.empty((L,), dtype=torch.int32, device=dev)
    ins = [inst[k] for k in ("lam", "cam5", "posesT", "X", "slot", "u", "v", "ur", "isig2",
                             "act", "povar", "n_pts")]

    def run_v1(mode):
        v1(*[t.data_ptr() for t in ins], WF, wk, O, L, int(inst["huber"]),
           *[t.data_ptr() for t in outs], wc.data_ptr(), cost_pt.data_ptr(), mask.data_ptr(),
           mode, n, stream())

    wc_cur = torch.zeros((wk, 18, L), **f32)  # carried over a BA call's iterations, as the
    scratch = ba_cuda.ba_scratch(wk, L, dev)   # solver carries them

    def run_cur():
        return ba_cuda.ba_accumulate(
            inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"],
            inst["ur"], inst["isig2"], inst["act"], inst["povar"], inst["cam5"], wk,
            inst["huber"], n_pts=inst["n_pts"], wc=wc_cur, scratch=scratch)

    run_v1(0)
    cur = run_cur()
    torch.cuda.synchronize()
    diffs = [float((a - b.reshape(a.shape)).abs().max()) for a, b in zip(outs, cur[:7])]
    print(f"  max |first design - current| on (Hpp, bp, S_red, rhs_red, cost, Hinv, bl): {diffs}")
    labels = {0: "whole (launches 1 + 2)", 1: "launch 1", 5: f"launch 1 cut to {n} points",
              2: "launch 2", 3: "launch 2, S_red blocks alone (col < wk)",
              4: "launch 2, pose-block blocks alone (col == wk)",
              6: "launch 2, pose block of slot 0 alone", 7: "launch 2, S_red block (0,0) alone"}
    for mode in (0, 1, 5, 2, 3, 4, 6, 7, 0):
        ms = chip_smoke.time_graph_ms(lambda: run_v1(mode))
        print(f"  ba_accumulate first design, {labels[mode]}: {ms:.4f} ms")
    for _ in range(2):
        print(f"  ba_accumulate current, whole: {chip_smoke.time_graph_ms(run_cur):.4f} ms; "
              f"by launch (profiler): {chip_smoke.launch_times_ms(run_cur)}")
    # no live point: every block of both launches leaves at once
    inst = dict(inst, n_pts=torch.zeros((), dtype=torch.int32, device=dev))
    print(f"  ba_accumulate current with n_pts = 0, whole: "
          f"{chip_smoke.time_graph_ms(run_cur):.4f} ms; by launch (profiler): "
          f"{chip_smoke.launch_times_ms(run_cur)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    built = dict(_build.build())
    built.update(_build.build(("dpx_bench", "fast_v1", "ba_v1"), ROOT / "perf"))
    for k, v in built.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {k}.cu: {line.strip()}")
    noop = bind(_build.load("noop"), "noop_launch", [_I, _P])
    for n in (1, 2):
        print(f"  launch floor, {n} empty launch(es) in a row: "
              f"{chip_smoke.time_graph_ms(lambda: noop(n, stream())):.4f} ms")
    dpx_phase(_build, dev)
    fast_phase(_build, dev)
    ba_phase(_build, dev)
    print("kernel_split: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
