"""Where a fresh system's first chunk spends its host time on the card: the
kfdense scenario (``bench.build_scenario``) through the step programs, the
first chunk under ``cProfile``, then the programs' warm-up and capture
seconds and the profile's top entries by cumulative time.

    python3 perf/warmup_probe.py [--root DIR] [--top N]

``--root`` imports ``vo_slam_test_tpu_torch`` from another checkout (an
unpacked ``git archive`` of an earlier commit), so two trees can be compared
in one call. Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("warmup_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.ops import _build
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    _build.build()
    dev = torch.device("cuda")
    sc = bench.build_scenario("kfdense", dev)
    frames = bench.stage_frames(sc.frames, dev)
    s = SlamSystem(sc.cfg, vocabulary=sc.voc, chunk=sc.chunk)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    for g, d, t in frames[:sc.chunk]:
        s.track(g, d, t)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"root {args.root}: first chunk {wall:.3f} s; " + "; ".join(
        f"{name} warm {sg.warm_s:.3f} s capture {sg.capture_s:.3f} s nodes {sg.n_nodes}"
        for name, sg in (("track", s.track_graph), ("background", s.background_graph))),
        flush=True)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(args.top)
    print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
