"""Command-line entry point: the vo_run equivalent (reference: test/vo_run.cpp); port of
``vo_slam_test_tpu/run_slam.py`` with the same flags, output files and lines.

Usage:
  python -m vo_slam_test_tpu_torch.run_slam config.yaml          # TUM dataset run
  python -m vo_slam_test_tpu_torch.run_slam --synthetic [--frames N] [--motion S]

Prints per-frame tracking state and timing stats (median/mean like
vo_run.cpp:151-159), saves TUM-format trajectories, and reports ATE against
ground truth when available (synthetic always has it). Runs on the card;
``main(argv, device="cpu")`` runs the plain versions on the CPU. On the card
the CUDA kernels are built (nvcc) before the first frame: the wall line
includes that build, whose seconds are printed on a line of their own.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", help="OpenCV-style YAML (reference key set)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--motion", type=float, default=0.5)
    ap.add_argument("--camera-out", default="camera_trajectory.txt")
    ap.add_argument(
        "--sync", action="store_true",
        help="use the host-synchronous tracker (per-frame stats printed live)",
    )
    ap.add_argument("--slam", action="store_true",
                    help="full SLAM (map + local BA) instead of frame-to-frame VO")
    ap.add_argument("--vocabulary", default=None,
                    help="vocabulary .npz for BoW relocalization / loop closing")
    ap.add_argument("--hud-out", default=None,
                    help="directory for per-frame HUD renders (keypoint "
                         "boxes: green=map-tracked, blue=VO-tracked; "
                         "status bar), like the reference's frame viewer")
    ap.add_argument("--hud-every", type=int, default=1,
                    help="render every Nth frame to --hud-out")
    ap.add_argument("--chunk", type=int, default=1,
                    help="track frames in scanned chunks of this size (one "
                         "device dispatch per chunk; throughput mode)")
    ap.add_argument("--reloc-parity", action="store_true",
                    help="reference-semantics relocalization: iterate all BoW "
                         "candidates first-success with always-EPnP "
                         "(visualOdometry.cpp:313-395); default mode batches "
                         "the top 3 and picks the best")
    ap.add_argument("--global-ba", action="store_true",
                    help="run global bundle adjustment after accepted loop closures "
                         "(upstream-ORB-SLAM2 behavior; the reference stops at the essential graph)")
    ap.add_argument("--vocabulary-out", default=None,
                    help="build a scene vocabulary from tracked keyframes and save it here (implies --slam)")
    ap.add_argument("--keyframe-out", default=None,
                    help="save the keyframe trajectory (TUM format) here (implies --slam)")
    ap.add_argument("--map-out", default=None,
                    help="render the final map (points + keyframes + graph edges) to this PNG (implies --slam)")
    ap.add_argument("--viewer-live", type=int, default=0, metavar="N",
                    help="with --viewer-out: re-export the viewer every N "
                         "frames DURING the run (auto-reloading page) — the "
                         "reference Drawer thread's live rendering")
    ap.add_argument("--viewer-out", default=None,
                    help="export an interactive 3D map viewer (single "
                         "self-contained HTML: orbit/zoom, frusta, "
                         "covis/tree/loop edges, trajectory playback with "
                         "follow-cam) to this path (implies --slam)")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-frame tracking metrics CSV here")
    ap.add_argument("--events-out", default=None,
                    help="write a run-events JSON (reloc/loop trigger frames, "
                         "ATE, timing) for tools/parity_check.py (implies --slam)")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .config import SlamConfig
    from .datasets import SyntheticRGBD, TumDataset, write_trajectory_tum
    from .datasets.tum import ate_rmse
    from .pipeline.tracking import FrameToFrameTracker, FusedTracker

    gt = None
    if args.synthetic:
        seq = SyntheticRGBD(n_frames=args.frames, seed=0, motion_scale=args.motion)
        cfg = SlamConfig(
            camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
            camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
        )
        gt = np.stack([seq.poses[i] for i in range(len(seq))])
    else:
        if not args.config:
            ap.error("either a config yaml or --synthetic is required")
        cfg = SlamConfig.from_yaml(args.config)
        seq = TumDataset(
            cfg.dataset_dir, depth_scale=cfg.camera_depthScale, limit=cfg.data_num,
            width=cfg.camera_width, height=cfg.camera_height,
        )

    if (args.vocabulary_out or args.keyframe_out or args.map_out
            or args.events_out or args.viewer_out):
        args.slam = True

    dev = resolve_device(device)

    def build_kernels():
        """Build the CUDA kernels (on the card only) -> seconds."""
        if dev.type != "cuda":
            return None
        from .ops import _build

        t = time.perf_counter()
        _build.build()
        return time.perf_counter() - t

    def print_build(build_s):
        print("kernel build: none (plain versions on the CPU)" if build_s is None
              else f"kernel build: {build_s:.2f} s (nvcc, before the first frame)")

    if args.slam:
        from .bow.vocabulary import Vocabulary, load_dbow_text
        from .pipeline.system import SlamSystem

        voc = None
        if args.vocabulary:
            if args.vocabulary.endswith((".txt", ".txt.gz")):
                voc = load_dbow_text(args.vocabulary, dev)  # DBoW2/3 ORBvoc.txt
            else:
                voc = Vocabulary.load(args.vocabulary, dev)
        tracker = SlamSystem(cfg, device=dev, vocabulary=voc, enable_global_ba=args.global_ba,
                             chunk=args.chunk, reloc_parity=args.reloc_parity)
        hud_grays = []
        t0 = time.perf_counter()
        build_s = build_kernels()
        for i in range(len(seq)):
            gray, depth, ts = seq[i]
            tracker.track(gray, depth, ts)
            if args.hud_out and i % args.hud_every == 0:
                hud_grays.append((i, gray))
            if args.viewer_live and args.viewer_out and i > 0 \
                    and i % args.viewer_live == 0:
                # live drawer analogue (reference Drawer thread,
                # drawer.cpp:55-366, renders concurrently from shared
                # state): re-export the interactive viewer from the
                # CURRENT map every N frames. The snapshot reads device
                # state (a pipeline stall, like the reference's map
                # mutexes); the page auto-reloads while the run is live.
                # no flush: the map as of the last completed chunk is at
                # most chunk-1 frames stale (flushing would compile the
                # per-frame program just for the live view)
                from .viz import snapshot_map
                from .viz.webviewer import export_html

                export_html(snapshot_map(tracker.map), args.viewer_out,
                            autorefresh_s=2.0)
        trajectory, stats, kf_traj = tracker.results()
        wall = time.perf_counter() - t0
        print(f"wall time: {wall/len(seq)*1000:.2f} ms/frame (incl. first-frame kernel build)")
        print_build(build_s)
        print(f"keyframes: {tracker.n_keyframes}  map points: {tracker.n_points}")
        if tracker.reloc_frames:
            print(f"relocalizations at frames: {tracker.reloc_frames}")
        if tracker.loop_closures:
            print(f"loop closures at frames: {tracker.loop_closures}")
        if args.keyframe_out:
            write_trajectory_tum(
                args.keyframe_out, [t for t, _ in kf_traj], np.stack([T for _, T in kf_traj])
            )
            print(f"keyframe trajectory saved to {args.keyframe_out}")
        if args.vocabulary_out:
            tracker.create_vocabulary().save(args.vocabulary_out)
            print(f"scene vocabulary saved to {args.vocabulary_out}")
        if args.hud_out:
            from .viz.drawer import save_hud_frames

            n = save_hud_frames(
                args.hud_out,
                (g for _, g in hud_grays),
                tracker.hud_outputs([i for i, _ in hud_grays]),
                every=1,
            )
            print(f"{n} HUD frames saved to {args.hud_out}")
        if args.map_out:
            from .viz import plot_map, snapshot_map

            plot_map(snapshot_map(tracker.map), args.map_out)
            print(f"map render saved to {args.map_out}")
        if args.viewer_out:
            from .viz import snapshot_map
            from .viz.webviewer import export_html

            export_html(
                snapshot_map(tracker.map), args.viewer_out,
                traj_T_w_c=np.stack(trajectory) if len(trajectory) else None,
            )
            print(f"interactive viewer saved to {args.viewer_out}")
    elif args.sync:
        tracker = FrameToFrameTracker(cfg, device=dev)
        build_s = build_kernels()
        print_build(build_s)
        times = []
        stats = []
        for i in range(len(seq)):
            gray, depth, ts = seq[i]
            t0 = time.perf_counter()
            st = tracker.track(gray, depth, ts)
            dt = time.perf_counter() - t0
            if i > 0:  # skip compile
                times.append(dt)
            stats.append(st)
            print(
                f"frame {i:4d} t={ts:9.3f} ok={int(st.ok)} feats={st.n_features:4d} "
                f"matches={st.n_matches:4d} inliers={st.n_inliers:4d} {dt*1000:7.2f} ms"
            )
        trajectory = np.stack(tracker.trajectory)
        times = np.array(times) if times else np.array([0.0])
        print(f"tracking time: median {np.median(times)*1000:.2f} ms  mean {times.mean()*1000:.2f} ms")
    else:
        tracker = FusedTracker(cfg, device=dev)
        t0 = time.perf_counter()
        build_s = build_kernels()
        for i in range(len(seq)):
            gray, depth, ts = seq[i]
            tracker.track(gray, depth, ts)
        trajectory, stats = tracker.results()
        wall = time.perf_counter() - t0
        for i, st in enumerate(stats):
            print(
                f"frame {i:4d} ok={int(st.ok)} feats={st.n_features:4d} "
                f"matches={st.n_matches:4d} inliers={st.n_inliers:4d}"
            )
        print(f"wall time: {wall/len(seq)*1000:.2f} ms/frame (incl. first-frame kernel build)")
        print_build(build_s)

    n_ok = sum(s.ok for s in stats)
    print(f"tracked {n_ok}/{len(seq)} frames")
    write_trajectory_tum(args.camera_out, tracker.timestamps, trajectory)
    print(f"camera trajectory saved to {args.camera_out}")

    if args.metrics_out:
        from .viz import save_metrics_csv

        save_metrics_csv(args.metrics_out, tracker.timestamps, stats)
        print(f"metrics saved to {args.metrics_out}")

    rmse = None
    if gt is not None:
        rmse = ate_rmse(tracker.timestamps, gt, tracker.timestamps, trajectory)
        print(f"ATE RMSE vs ground truth: {rmse*100:.2f} cm")

    if args.events_out:
        import json

        events = {
            "n_frames": len(seq),
            "n_tracked": int(n_ok),
            "reloc_frames": list(getattr(tracker, "reloc_frames", [])),
            "loop_frames": list(getattr(tracker, "loop_closures", [])),
            "n_keyframes": int(getattr(tracker, "n_keyframes", 0)),
            "ate_rmse_m": None if rmse is None else float(rmse),
            # per-frame wall incl. the kernel build before the first frame
            # (the 5-run protocol drops min/max across runs, which absorbs
            # the one cold run)
            "wall_ms_per_frame": (
                float(wall / len(seq) * 1000.0) if args.slam else None
            ),
        }
        with open(args.events_out, "w") as f:
            json.dump(events, f, indent=2)
        print(f"run events saved to {args.events_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
