"""Main path 8a (kfdense) on the card against the JAX package on the CPU,
from their records: the smoke's log (its ``main_path`` JSON line, whose
``bench_configuration.8a`` holds the per-frame counts and positions) and the
JSON that ``perf/kfdense_jax_cpu.py --out`` writes.

    python perf/kfdense_compare.py SMOKE_LOG JAX_JSON

Prints the keyframe frames and where they part, the first frame whose counts
(features, matches, inliers) differ, the first keyframe event whose LM
iterations differ, the closures, and the ATE of each side's recovered and raw
tracked trajectories, over the whole run and over the frames before the first
closure.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from vo_slam_test_tpu_torch.datasets import ate_rmse


def positions_ate(pos, gt) -> float:
    """ATE (m) of positions against ground-truth positions, frame for frame."""
    T = np.tile(np.eye(4), (len(pos), 1, 1))
    G = np.tile(np.eye(4), (len(gt), 1, 1))
    T[:, :3, 3], G[:, :3, 3] = pos, gt
    t = np.arange(len(pos), dtype=np.float64)
    return ate_rmse(t, G, t, T)


def main() -> int:
    lines = open(sys.argv[1]).read().splitlines()
    card = json.loads([x for x in lines if x.startswith('{"main_path"')][0])
    card = card["main_path"]["bench_configuration"]["8a"]
    jax = json.load(open(sys.argv[2]))
    gt = np.asarray(jax["gt_position_m"])
    ck, jk = card["keyframe_frames"], jax["keyframe_frames"]
    part = next(((a, b) for a, b in zip(ck, jk) if a != b), None)
    print(f"keyframe frames: card {len(ck)}, JAX {len(jk)}; equal up to "
          f"{ck[ck.index(part[0]) - 1] if part else ck[-1]}, then card {part and part[0]}, "
          f"JAX {part and part[1]}")
    jc = [(r["n_features"], r["n_matches"], r["n_inliers"]) for r in jax["per_frame"]]
    diff = [i for i, (a, b) in enumerate(zip(card["per_frame"], jc)) if tuple(a) != tuple(b)]
    if diff:
        print(f"counts (features, matches, inliers) part first at frame {diff[0]}: card "
              f"{tuple(card['per_frame'][diff[0]])}, JAX {jc[diff[0]]}; {len(diff)} frames "
              f"differ")
    lm = next(((a, b) for a, b in zip(card["ba_iters"], jax["ba_iters"])
               if tuple(a) != tuple(b)), None)
    print(f"first keyframe event with other LM iterations (frame, pass 1, pass 2): card "
          f"{lm and tuple(lm[0])}, JAX {lm and tuple(lm[1])}")
    print(f"closures: card {card['closures']}, JAX {jax['closures']}")
    first = min(card["closures"] + jax["closures"] + [len(gt)])
    for label, rec in (("card", card), ("JAX", jax)):
        est, raw = np.asarray(rec["position_m"]), np.asarray(rec["raw_position_m"])
        print(f"{label}: ATE recovered {positions_ate(est, gt) * 100:.4f} cm, raw tracked "
              f"{positions_ate(raw, gt) * 100:.4f} cm; raw over frames 0-{first - 1} "
              f"{positions_ate(raw[:first], gt[:first]) * 100:.4f} cm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
