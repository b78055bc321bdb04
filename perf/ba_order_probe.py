#!/usr/bin/env python3
"""Which of ``ba_accumulate``'s sums moves local BA's LM decisions when its f32
order changes.

    python3 perf/ba_order_probe.py          # from the repository root, on the card

Local BA's reduced camera system is indefinite in f32 at small damping, so
whether a Cholesky succeeds or an LM step is accepted follows the rounding of
the sums that feed it. The first design of the kernel (``perf/ba_v1.cu``: a
point's observers added one after the other, every cross-point sum walked by
128 threads and a 7-step tree) and the current one (``csrc/ba.cu``: an xor
tree over a point's lanes, records summed by groups and another tree) compute
the same sums in different orders. This script drives ``SlamSystem`` over the
first 40 frames of the room orbit (``chip_smoke.py``'s main path 2) with the
accumulate call replaced by a mix of the two designs' outputs on the same
inputs, and prints the LM iterations per keyframe event and the ATE for each
mix: all from the first design, all from the current one, and the first
design with only the per-point sums (Hinv, bl), only the pose-block sums
(Hpp, bp) or only the Schur sums (S_red, rhs_red, which contain the current
Hinv) taken from the current one.
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

NAMES = ("Hpp", "bp", "S_red", "rhs_red", "cost", "Hinv", "bl", "Wc")
MIXES = {
    "all from the first design": (),
    "all from the current design": NAMES,
    "first design, per-point sums (Hinv, bl) from the current": ("Hinv", "bl"),
    "first design, pose-block sums (Hpp, bp) from the current": ("Hpp", "bp"),
    "first design, Schur sums (S_red, rhs_red) from the current": ("S_red", "rhs_red"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("ba_order_probe: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import _build, ba_cuda
    from vo_slam_test_tpu_torch.pipeline import system

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build()
    _build.build(("ba_v1",), ROOT / "perf")
    v1 = ctypes.CDLL(str(_build.library_path("ba_v1", ROOT / "perf"))).ba_v1_launch
    _P, _I = ctypes.c_void_p, ctypes.c_int
    v1.argtypes = [_P] * 12 + [_I] * 5 + [_P] * 10 + [_I, _I, _P]
    v1.restype = _I
    current = ba_cuda.ba_accumulate

    def first_design(lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk, huber, n_pts):
        dev = posesT.device
        O, L = slot.shape
        f32 = dict(dtype=torch.float32, device=dev)
        outs = [torch.empty(s, **f32) for s in
                ((wk, 36), (wk, 6), (wk * 6, wk * 6), (wk * 6, 1), (1, 1), (9, L), (3, L))]
        wc = torch.zeros((wk, 18, L), **f32)
        cost_pt = torch.empty((L,), **f32)
        mask = torch.empty((L,), dtype=torch.int32, device=dev)
        ins = (lam, cam5, posesT, X, slot, u, v, ur, isig2, act, povar, n_pts)
        rc = v1(*[t.data_ptr() for t in ins], posesT.shape[1], wk, O, L, int(huber),
                *[t.data_ptr() for t in outs], wc.data_ptr(), cost_pt.data_ptr(),
                mask.data_ptr(), 0, L, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ba_v1_launch: cudaError {rc}")
        return (*outs, wc)

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    frames = [room[i] for i in range(chip_smoke.SLICE_FRAMES)]
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30)
    gt = np.stack([room.poses[i] for i in range(len(frames))])
    try:
        for label, take in MIXES.items():
            def mixed(*args, n_pts=None, wc=None, scratch=None, mask=None, _take=take):
                # both designs' Wc rows are zero outside the mask words that
                # the current kernel writes for the back-substitution
                old = first_design(*args, n_pts)
                new = current(*args, n_pts=n_pts, mask=mask)
                return tuple(n if name in _take else o for name, o, n in zip(NAMES, old, new))

            ba_cuda.ba_accumulate = mixed
            s = system.SlamSystem(cfg)
            for f in frames:
                s.track(*f)
            torch.cuda.synchronize()
            traj, stats, _ = s.results()
            ate = ate_rmse(s.timestamps, gt, s.timestamps, traj)
            kf = [i for i, o in enumerate(s._outs) if o.made_kf]
            n_iter = sum(a + b for _, a, b in s.ba_iters)
            print(f"{label}: {sum(st.ok for st in stats)}/{len(stats)} tracked, keyframes at {kf}, "
                  f"ATE {ate * 100:.4f} cm, {n_iter} LM iterations {s.ba_iters}")
    finally:
        ba_cuda.ba_accumulate = current
    return 0


if __name__ == "__main__":
    sys.exit(main())
