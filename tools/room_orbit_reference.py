#!/usr/bin/env python3
"""SlamSystem on the first frames of the room orbit, on the CPU: the JAX
package (the reference) or the PyTorch port.

    JAX_PLATFORMS=cpu python tools/room_orbit_reference.py --impl jax --frames 40
    python tools/room_orbit_reference.py --impl torch --frames 40

The sequence is bench.py's: ``room_orbit_trajectory(240, loops=1.5)``, scene
"room", seed 7, and the first ``--frames`` frames of it. Without ``--half``
it runs at 640x480 with 8 levels, 1000 features and the default MapCaps
(the port's chip_smoke.py main path 2); with ``--half`` at 320x240 with 4
levels, 500 features and MapCaps(max_kf=16, max_pt=4096) (the CPU parity
tests). interruptBA is forced: local BA is skipped at its entry. Prints per
frame (n_features, n_matches, n_inliers, ok, made_kf), then the keyframe
frames, live keyframes and points, ATE and the wall time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--half", action="store_true")
    args = ap.parse_args()

    if args.impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from vo_slam_test_tpu.config import SlamConfig
        from vo_slam_test_tpu.datasets import SyntheticRGBD
        from vo_slam_test_tpu.datasets.synthetic import room_orbit_trajectory
        from vo_slam_test_tpu.datasets.tum import ate_rmse
        from vo_slam_test_tpu.pipeline.system import SlamSystem
        from vo_slam_test_tpu.slam_map.map_state import MapCaps
        extra = {}
    else:
        from vo_slam_test_tpu_torch.config import SlamConfig
        from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, ate_rmse
        from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
        from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
        from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
        extra = {"device": "cpu"}

    traj = room_orbit_trajectory(240, loops=1.5)
    if args.half:
        seq = SyntheticRGBD(width=320, height=240, fx=517.3 * 0.5, fy=516.5 * 0.5,
                            cx=318.6 * 0.5, cy=255.3 * 0.5, trajectory=traj, scene="room", seed=7)
        kw = dict(camera_width=320, camera_height=240, level_pyramid=4, num_of_features=500)
        caps = MapCaps(max_kf=16, max_pt=4096)
    else:
        seq = SyntheticRGBD(trajectory=traj, scene="room", seed=7)
        kw, caps = {}, MapCaps()
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30, **kw)
    t0 = time.time()
    s = SlamSystem(cfg, caps=caps, **extra)
    s._force_interrupt_ba = True
    kf_frames = []
    for i in range(args.frames):
        s.track(*seq[i])
        o = s._outs[-1]
        made = bool(o.made_kf)
        kf_frames += [i] if made else []
        print(i, int(o.n_features), int(o.n_matches), int(o.n_inliers), bool(o.ok), made,
              flush=True)
    est, stats, _ = s.results()
    gt = np.stack([seq.poses[i] for i in range(args.frames)])
    ate = ate_rmse(s.timestamps, gt, s.timestamps, est)
    print(f"impl {args.impl}: {sum(st.ok for st in stats)}/{len(stats)} tracked, keyframe frames "
          f"{kf_frames}, live keyframes {s.n_keyframes}, points {s.n_points}, "
          f"ATE {ate * 100:.4f} cm, wall {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
