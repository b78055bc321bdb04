"""The readings that the limits of ``correct`` are set from: a cell's window
on many seeds in one process, each checked against the reference as a run
checks it, and beside it the control (the reference one precision below, in
the program's place: bf16 keypoints and a bf16-rounded map).

    python3 -m slambench.readings --workload fr1_room.offline --seeds 1,2,3 [--seconds 24]

Live traffic is sent without pacing here (the outputs do not depend on it).
One JSON line per seed on standard output; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    manifest = run.load_manifest()
    cell = run.cell_spec(manifest, args.workload)
    cfg = run.read_json("configs", cell["config"])
    traffic = run.read_json("traffic", cell["traffic"])
    seconds = args.seconds or manifest["run_seconds"]

    import torch

    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    from vo_slam_test_tpu_torch.ops import _build

    _build.build()
    warmed = False
    for seed in [int(x) for x in args.seeds.split(",")]:
        t0 = time.perf_counter()
        inp = run.make_inputs(cfg, seed, device)
        if not warmed:
            run.warm_up(inp, traffic["chunk"], device)
            warmed = True
        win = run.run_window(inp, traffic, run.recordings_for(seconds, inp), device, False,
                             run.make_system, pace=False)
        keep = win.systems[run.sample_recording(seed, len(win.systems))]
        prog = run.check_readings(inp, cfg, win.trajectories, keep)
        ctl = run.check_readings(inp, cfg, win.trajectories, keep, control=torch.bfloat16)
        s = win.systems[-1]
        row = dict(seed=seed, frames=win.frames, frames_per_s=win.frames / win.seconds,
                   n_kf_ever=int(s.map.n_kf_ever), closures=list(s.loop_closures),
                   ba_events=len(s.ba_iters), program=prog, control=ctl,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        del win, inp, s, keep
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
