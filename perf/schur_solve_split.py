"""Which of two numeric changes moves the card's results: local BA's Schur
solve as two ``solve_triangular`` calls (``local_ba.schur_solve``) in place of
``torch.cholesky_solve``, and the triangulation's DLT null vector
(``triangulate.null_vector_4x4``) in place of ``torch.linalg.svd``. On the
card, every run eager (``graphs=False``: the SVD cannot be captured):

1. main path 2's ``SlamSystem`` (no vocabulary, the room orbit's first 40
   frames at 640x480) and main path 3 (``chunk=8``) under the four
   combinations: keyframe frames, LM iterations, points, ATE;
2. every Schur system the path-2 run with both changes solves, captured and
   solved both ways: how many solutions are bit-equal, the largest absolute
   difference and the largest difference relative to the solution's max;
3. kfdense (the bench's 240-frame orbit with its scene vocabulary,
   ``chunk=8``) under the four combinations: ``n_kf_ever``, keyframe frames,
   closures, ATE, LM iterations in all (``--no-kfdense`` leaves it out).

    python3 perf/schur_solve_split.py [--no-kfdense]

Prints the card's name and power limit, one line per run and one JSON line.
Exits 1 without a CUDA device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from vo_slam_test_tpu_torch.slam_map import triangulate
from vo_slam_test_tpu_torch.solvers import local_ba

NEW_SOLVE, NEW_NULL = local_ba.schur_solve, triangulate.null_vector_4x4


def old_solve(chol, rhs):
    return torch.cholesky_solve(rhs, chol)


def old_null(A):
    return torch.linalg.svd(A).Vh[:, 3, :]


COMBOS = {"cholesky_solve + svd": (old_solve, old_null),
          "cholesky_solve + null_vector_4x4": (old_solve, NEW_NULL),
          "solve_triangular + svd": (NEW_SOLVE, old_null),
          "solve_triangular + null_vector_4x4": (NEW_SOLVE, NEW_NULL)}


def use(combo):
    local_ba.schur_solve, triangulate.null_vector_4x4 = COMBOS[combo]


def room_run(frames, cfg, gt, chunk, record=None):
    from vo_slam_test_tpu_torch.datasets import ate_rmse
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    if record is not None:
        solve = local_ba.schur_solve

        def recording(chol, rhs):
            record.append((chol.clone(), rhs.clone()))
            return solve(chol, rhs)

        local_ba.schur_solve = recording
    s = SlamSystem(cfg, chunk=chunk, graphs=False)
    for f in frames:
        s.track(*f)
    traj, stats, _ = s.results()
    ate = ate_rmse(s.timestamps, gt, s.timestamps, traj)
    return dict(tracked=sum(x.ok for x in stats),
                keyframe_frames=[i for i, o in enumerate(s._outs) if o.made_kf],
                ba_iters=s.ba_iters, lm_total=sum(a + b for _, a, b in s.ba_iters),
                points=s.n_points, ate_cm=float(ate * 100))


def compare_solves(systems):
    """Each captured (chol, rhs) solved by both forms."""
    n_equal, max_abs, max_rel = 0, 0.0, 0.0
    for chol, rhs in systems:
        a, b = old_solve(chol, rhs), NEW_SOLVE(chol, rhs)
        na, nb = torch.isnan(a), torch.isnan(b)
        if torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a), torch.where(nb, 0.0, b)):
            n_equal += 1
            continue
        d = (a - b).abs()
        if torch.isnan(d).any():
            max_abs = float("nan")
            continue
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float(d.max() / a.abs().max().clamp(min=1e-30)))
    return dict(systems=len(systems), bit_equal=n_equal, max_abs_diff=max_abs,
                max_rel_diff=max_rel)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("schur_solve_split: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    frames = [(torch.as_tensor(g).to("cuda"), torch.as_tensor(d).to("cuda"), t)
              for g, d, t in (room[i] for i in range(40))]
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30)
    gt = np.stack([room.poses[i] for i in range(40)])
    out = dict(paths={}, kfdense={})
    captured = []
    for combo in COMBOS:
        for path, chunk in ((2, 1), (3, 8)):
            use(combo)
            rec = captured if (path == 2 and combo == "solve_triangular + null_vector_4x4") \
                else None
            r = room_run(frames, cfg, gt, chunk, rec)
            out["paths"][f"{path} {combo}"] = r
            print(f"path {path}, {combo}: keyframes {r['keyframe_frames']}, LM {r['ba_iters']} "
                  f"({r['lm_total']} in all), points {r['points']}, ATE {r['ate_cm']:.4f} cm, "
                  f"tracked {r['tracked']}/40")
    use("solve_triangular + null_vector_4x4")
    out["schur_systems"] = compare_solves(captured)
    print(f"path 2's Schur systems solved both ways: {out['schur_systems']}")

    if "--no-kfdense" not in argv:
        sc = bench.build_scenario("kfdense", "cuda")
        staged = bench.stage_frames(sc.frames, "cuda")
        for combo in COMBOS:
            use(combo)
            s, wall = bench.track_all(sc, staged, "cuda")
            try:
                d = bench.check(sc, s, len(staged))
                d["gates"] = "pass"
            except AssertionError as e:
                d = dict(gates=f"fail: {e}", n_kf_ever=int(s.map.n_kf_ever))
            d["wall_s"] = wall
            out["kfdense"][combo] = d
            print(f"kfdense, {combo}: n_kf_ever {d.get('n_kf_ever')}, closures "
                  f"{d.get('closures')}, ATE {d.get('ate_m', float('nan')) * 100:.4f} cm, LM "
                  f"iterations {d.get('ba_iters_total')}, gates {d['gates']}, {wall:.1f} s")
    use("solve_triangular + null_vector_4x4")
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
