"""Main path 7 of chip_smoke.py alone, on the card: the off-nominal scenes
(7a: the moving object, sparse texture and Milestone B through SlamSystem)
and local BA past its caps (7b: rows 7-9 on the saturated window's first LM
iteration), with every check of the smoke run, without the other paths.

    python3 perf/path7_probe.py [7a] [7b]     # both when none is named
    python3 perf/path7_probe.py --extract     # the moving object's frames 0-1, card vs CPU

Builds the kernels first (one nvcc per source, in parallel) and prints the
card's name and power limit, then each phase's lines as the smoke run
prints them and one JSON line of the numbers. Exits 1 without a CUDA
device. ``--extract`` runs the port's ORB front end on the moving object's
frames 0 and 1 on the card and on the CPU and prints, stage by stage (pyramid,
FAST scores, cell candidates, quad-tree keep masks, features), what differs.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import chip_smoke as cs


def extract_diff() -> None:
    """The front end's stages on the card against the CPU, frames 0-1 of
    the moving object."""
    import numpy as np

    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
    from vo_slam_test_tpu_torch.ops import fast
    from vo_slam_test_tpu_torch.ops.distribute_device import distribute_level
    from vo_slam_test_tpu_torch.ops.pyramid import build_pyramid, interior
    from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker

    seq, cfg = cs.scene_sequences()["moving object"]
    tr = {d: FusedTracker(cfg, device=d) for d in ("cuda", "cpu")}
    for i in (0, 1):
        g, dep, _ = seq[i]
        st = {}
        for d, t in tr.items():
            gt, dt = torch.as_tensor(g).to(d), torch.as_tensor(dep).to(d)
            pyr = build_pyramid(gt, t.spec)
            lv = interior(pyr.raw, t.spec)
            score = fast.fast_score(lv) if d == "cpu" else fast.fast_cuda.fast_score(lv)
            c = fast.select_candidates(score, t.spec)
            L = t.spec.n_levels
            M = c.ys.shape[1] * c.ys.shape[2]
            b = float(fast.DETECT_BORDER)
            keeps = []
            for lvl in range(L):
                h, w = t.spec.sizes[lvl]
                n_ini = max(int(round((w - 2 * b) / (h - 2 * b))), 1)
                keeps.append(distribute_level(
                    c.xs.reshape(L, M)[lvl], c.ys.reshape(L, M)[lvl],
                    c.response.reshape(L, M)[lvl], c.valid.reshape(L, M)[lvl],
                    (b, w - b, b, h - b), t.budgets[lvl], n_ini=n_ini))
            f = extract_fused(gt, dt, t.camera, t.spec, t.budgets)
            st[d] = dict(raw=pyr.raw, blur=pyr.blur, score=score, ys=c.ys, xs=c.xs,
                         response=c.response, valid=c.valid, keep=torch.stack(keeps),
                         uv=f.uv, octave=f.octave, desc=f.desc, angle=f.angle)
        for k in st["cpu"]:
            a, b_ = st["cuda"][k].cpu().numpy(), st["cpu"][k].numpy()
            n = int((a != b_).sum())
            where = np.argwhere(a != b_)[:4].tolist() if n else []
            print(f"frame {i} {k}: {n} entries differ {where}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("path7_probe: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch.ops import _build, ba_cuda, ba_pallas
    from vo_slam_test_tpu_torch.pipeline import system

    phases = [a for a in argv if a in ("7a", "7b")] or ["7a", "7b"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    if "--extract" in argv:
        extract_diff()
        return 0
    all_kernels, plains = cs.kernel_counters(), cs.plain_versions()
    out = {}
    if "7a" in phases:
        t0 = time.perf_counter()
        out["scenes"], out["launches_7a"] = cs.main_path7a(system, all_kernels, plains)
        print(f"  7a in {time.perf_counter() - t0:.1f} s")
    if "7b" in phases:
        t0 = time.perf_counter()
        out["saturated"], out["rows"] = cs.main_path7b(ba_cuda, ba_pallas, all_kernels, "cuda")
        print(f"  7b in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
