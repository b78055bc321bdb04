"""Which change moved main paths 5 and 8a when Horn's alignment changed form:
Horn's alignment from a unit quaternion (``solvers/ransac.py::horn_align``, the
port's small symmetric eigensolver) against the SVD form it replaced
(``U diag(1, 1, det(U V^T)) V^T`` from ``torch.linalg.svd``), every run
eager, in one process on the card. On those paths Horn's alignment is the one
numeric change (neither relocalizes; the Sim3 RANSAC of every loop attempt
calls it), so the two forms' runs split the move.

    python3 perf/horn_split.py [--no-kfdense] [--no-pan]

Per form: kfdense (``bench.build_scenario``, frames staged on the card, one
eager pass through ``chip_smoke.run_path8a``): bench.py's gates, n_kf_ever,
ATE, LM iterations, closures and each Sim3 attempt's gate values; main path
5's ``chunk=4`` run (``chip_smoke.run_pan``): closures, island residual, ATE,
LM iterations. Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (the parent's, verbatim)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def horn_align_svd(p_src: torch.Tensor, p_dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Horn's alignment by the SVD of the cross-covariance, the port's form
    before the quaternion one, op for op (eager only: ``torch.linalg.svd``
    reads its status back to the host); NaN for a non-finite input."""
    from vo_slam_test_tpu_torch import lie

    wn = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    c_src = (p_src * wn[..., None]).sum(-2)
    c_dst = (p_dst * wn[..., None]).sum(-2)
    src_c = p_src - c_src[..., None, :]
    dst_c = p_dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", dst_c, src_c, wn)
    bad = ~torch.isfinite(H).all(-1).all(-1)
    H = torch.where(bad[..., None, None], 0.0, H)
    U, _, Vt = torch.linalg.svd(H)
    det = det3(U @ Vt)
    ones = torch.ones_like(det)
    D = torch.diag_embed(torch.stack([ones, ones, det], -1))
    R = torch.where(bad[..., None, None], torch.nan, U @ D @ Vt)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return lie.rt_to_mat(R, t)


def use_form(form: str) -> None:
    """Point every caller of ``horn_align`` at one form."""
    from vo_slam_test_tpu_torch.solvers import epnp, ransac, sim3

    fn = horn_align_svd if form == "svd" else QUATERNION[0]
    for mod in (ransac, sim3, epnp):
        mod.horn_align = fn


QUATERNION: list = []


def main() -> int:
    if not torch.cuda.is_available():
        print("horn_split: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-kfdense", action="store_true")
    ap.add_argument("--no-pan", action="store_true")
    args = ap.parse_args()

    import chip_smoke
    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.ops import _build
    from vo_slam_test_tpu_torch.pipeline import system
    from vo_slam_test_tpu_torch.solvers import ransac

    QUATERNION.append(ransac.horn_align)
    dev = torch.device("cuda")
    _build.build()
    if not args.no_pan:
        pseq, pcfg = chip_smoke.pan_sequence()
        pframes = [pseq[i] for i in range(len(pseq))]
        pgt = np.stack([pseq.poses[i] for i in range(len(pseq))])
        pvoc = chip_smoke.pan_vocabulary(pseq, pcfg, dev)
        for form in ("svd", "quaternion"):
            use_form(form)
            s, rec = chip_smoke.run_pan(system, pcfg, pvoc, pframes, chip_smoke.PAN_CHUNK, False)
            row = chip_smoke.pan_report(f"path 5 chunk={chip_smoke.PAN_CHUNK}, Horn by {form}",
                                        s, rec, pgt)
            print(f"path 5, Horn by {form}: closure at {row['closing_frame']}, island residual "
                  f"{row['residual_m']}, ATE {row['ate_m'] * 100:.4f} cm, LM iterations "
                  f"{s.ba_iters}", flush=True)
    if not args.no_kfdense:
        sc = bench.build_scenario("kfdense", dev)
        frames_dev = bench.stage_frames(sc.frames, dev)
        for form in ("svd", "quaternion"):
            use_form(form)
            s, _ = chip_smoke.run_path8a(system, sc, frames_dev, None)
            diag = bench.check(sc, s, len(frames_dev))
            print(f"kfdense, Horn by {form}: tracked {diag['tracked']}/{diag['frames']}, "
                  f"n_kf_ever {diag['n_kf_ever']}, ATE {diag['ate_m'] * 100:.4f} cm, LM "
                  f"iterations {diag['ba_iters_total']}, closures {diag['closures']}, attempts "
                  f"{diag['attempts']}; Sim3 gates per attempt {s.loop_gates}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
