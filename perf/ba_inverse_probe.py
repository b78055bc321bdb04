#!/usr/bin/env python3
"""What the f64 point-block inverse of ``ba_accumulate`` changes against the
reference's f32 one, on main path 2.

    python3 perf/ba_inverse_probe.py          # from the repository root, on the card

``csrc/ba.cu``'s ``inv3x3_sym`` inverts each live point's damped 3x3 block in
f64; the reference does it in f32 (``vo_slam_test_tpu/ops/ba_pallas.py``, the
closed form after "symmetric completion"). This script builds a copy of
``csrc/ba.cu`` whose ``inv3x3_sym`` is the reference's f32 form, op by op, into
``_build/variants`` and drives ``SlamSystem`` over the first 40 frames of the
room orbit (``chip_smoke.py``'s main path 2) twice: with the kernel as it
stands and with the f32 copy behind the same wrapper. In the first run, each
``ba_accumulate`` call (one per LM iteration) also runs the f32 copy on the
same inputs; the script counts the live points whose damped block has a
condition number above 1e7 (from the f64 inverse) and how far the f32
inverse lands from the f64 one on them and on the rest. It prints each run's
keyframes, LM iterations per event and ATE, and which map fields differ
between the two runs and by how much.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "perf"))

import chip_smoke  # noqa: E402
import kernel_split  # noqa: E402

COND_LIMIT = 1e7
# the reference's damped closed-form inverse in f32, each op rounded on its own
F32_INVERSE = """__device__ __forceinline__ void inv3x3_sym(const double h[6], float lam, double hv[9]) {
  const float a_ = __fadd_rn(__fadd_rn((float)h[0], lam), 1e-8f), b_ = (float)h[1];
  const float c_ = (float)h[2], f_ = (float)h[4];
  const float e_ = __fadd_rn(__fadd_rn((float)h[3], lam), 1e-8f);
  const float i_ = __fadd_rn(__fadd_rn((float)h[5], lam), 1e-8f);
  const float A = __fsub_rn(__fmul_rn(e_, i_), __fmul_rn(f_, f_));
  const float B = -__fsub_rn(__fmul_rn(b_, i_), __fmul_rn(f_, c_));
  const float C3 = __fsub_rn(__fmul_rn(b_, f_), __fmul_rn(e_, c_));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(a_, A), __fmul_rn(b_, B)), __fmul_rn(c_, C3));
  const float idet = __fdiv_rn(1.0f, fabsf(det) < 1e-20f ? 1e-20f : det);
  hv[0] = __fmul_rn(A, idet), hv[1] = __fmul_rn(B, idet), hv[2] = __fmul_rn(C3, idet);
  hv[3] = __fmul_rn(B, idet);
  hv[4] = __fmul_rn(__fsub_rn(__fmul_rn(a_, i_), __fmul_rn(c_, c_)), idet);
  hv[5] = __fmul_rn(-__fsub_rn(__fmul_rn(a_, f_), __fmul_rn(c_, b_)), idet);
  hv[6] = __fmul_rn(C3, idet);
  hv[7] = __fmul_rn(-__fsub_rn(__fmul_rn(a_, f_), __fmul_rn(b_, c_)), idet);
  hv[8] = __fmul_rn(__fsub_rn(__fmul_rn(a_, e_), __fmul_rn(b_, b_)), idet);
}
"""


def f32_source(_build) -> str:
    src = (_build.CSRC / "ba.cu").read_text()
    text, n = re.subn(r"__device__ __forceinline__ void inv3x3_sym\(.*?\n}\n", F32_INVERSE, src,
                      count=1, flags=re.S)
    assert n == 1
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("ba_inverse_probe: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import _build, ba_cuda
    from vo_slam_test_tpu_torch.pipeline import system

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build()
    lib = kernel_split.source_variants(_build, {"ba_f32_inverse": f32_source(_build)})
    f32_fn = lib["ba_f32_inverse"].ba_accumulate_launch
    f32_fn.argtypes = ba_cuda.KERNEL_ACC.argtypes
    f32_fn.restype = ctypes.c_int
    f64_fn = ba_cuda.KERNEL_ACC._fn
    current = ba_cuda.ba_accumulate

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    frames = [room[i] for i in range(chip_smoke.SLICE_FRAMES)]
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30)
    gt = np.stack([room.poses[i] for i in range(len(frames))])
    per_iter = []

    def probed(*args, n_pts=None, **kw):
        out = current(*args, n_pts=n_pts, **kw)
        ba_cuda.KERNEL_ACC.__dict__["_fn"] = f32_fn
        try:
            out32 = current(*args, n_pts=n_pts)  # fresh Wc, scratch and mask buffers
        finally:
            ba_cuda.KERNEL_ACC.__dict__["_fn"] = f64_fn
        n = int(n_pts)
        H64 = out[5][:, :n].T.reshape(n, 3, 3).double()
        H32 = out32[5][:, :n].T.reshape(n, 3, 3).double()
        cond = torch.linalg.cond(H64)
        ill = cond > COND_LIMIT
        rel = ((H32 - H64).abs().amax((1, 2)) / H64.abs().amax((1, 2))).nan_to_num(float("inf"))
        per_iter.append((n, int(ill.sum()), float(rel[ill].max()) if bool(ill.any()) else 0.0,
                         float(rel[~ill].max()) if bool((~ill).any()) else 0.0,
                         float(cond.max()) if n else 0.0))
        return out

    def drive(label):
        s = system.SlamSystem(cfg)
        for f in frames:
            s.track(*f)
        torch.cuda.synchronize()
        traj, stats, _ = s.results()
        ate = ate_rmse(s.timestamps, gt, s.timestamps, traj)
        kf = [i for i, o in enumerate(s._outs) if o.made_kf]
        n_iter = sum(a + b for _, a, b in s.ba_iters)
        print(f"{label}: {sum(st.ok for st in stats)}/{len(stats)} tracked, keyframes at {kf}, "
              f"{s.n_points} points, ATE {ate * 100:.4f} cm, {n_iter} LM iterations "
              f"{s.ba_iters}")
        return s

    try:
        ba_cuda.ba_accumulate = probed
        s64 = drive("f64 inverse (the kernel as it stands)")
    finally:
        ba_cuda.ba_accumulate = current
    n_ill = [x[1] for x in per_iter]
    print(f"per LM iteration (live points, points with cond > {COND_LIMIT:g}, max relative "
          f"|Hinv f32 - f64| on those, on the rest, largest cond): {per_iter}")
    print(f"points with cond > {COND_LIMIT:g}: {sum(n_ill)} over {len(per_iter)} iterations, "
          f"at most {max(n_ill)} in one, in {sum(x > 0 for x in n_ill)} iterations")
    ba_cuda.KERNEL_ACC.__dict__["_fn"] = f32_fn
    try:
        s32 = drive("f32 inverse (the reference's form)")
    finally:
        ba_cuda.KERNEL_ACC.__dict__["_fn"] = f64_fn
    # the two maps: integer fields that differ, and how far the poses and points moved
    a, b = s64.map, s32.map
    diff = [f for f in a.__dataclass_fields__ if not torch.equal(getattr(a, f), getattr(b, f))]
    int_fields = [f for f in diff if not getattr(a, f).is_floating_point()]
    kf = a.kf_valid & b.kf_valid
    pt = a.pt_valid & b.pt_valid
    print(f"maps: fields that differ {diff}; integer or flag fields among them {int_fields}; "
          f"max |kf_pose f32 - f64| {float((a.kf_pose - b.kf_pose)[kf].abs().max()):.3e}, "
          f"max |pt_pos f32 - f64| {float((a.pt_pos - b.pt_pos)[pt].abs().max()):.3e} m over "
          f"{int(pt.sum())} points live in both")
    return 0


if __name__ == "__main__":
    sys.exit(main())
