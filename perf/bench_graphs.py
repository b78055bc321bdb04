"""The port's benchmark through the step programs beside the eager path, in
one process on the card:

    python3 perf/bench_graphs.py [kfdense] [corner40]

For each scenario (default: both), ``vo_slam_test_tpu_torch.bench.measure``
twice on the same staged frames: ``graphs=False`` (the eager path), then the
default (``SlamSystem``'s step programs on the card, the loop close inside the
background program). Prints each run's JSON line and components (wall,
device busy, the background device ms by the profiler's launch times and by
CUDA events around each call of the background program, the programs'
warm-up and capture seconds of the best timed run, host syncs per chunk) and
the card's name and power limit; the last stdout line is one JSON object
with every number. Each timed run's ``setup_s`` goes to stderr
(``bench.measure``): the programs are the process's, captured by the warm
pass.
Needs the card; exits 1 without one.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("bench_graphs: no CUDA device", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.ops import _build

    from vo_slam_test_tpu_torch.utils import graphs as graphs_mod

    names = argv or ["kfdense", "corner40"]
    card = bench.card_line()
    print(card, flush=True)
    _build.build()
    dev = torch.device("cuda")
    out = {"card": card}
    for name in names:
        t0 = time.perf_counter()
        sc = bench.build_scenario(name, dev)
        print(f"{name}: scenario in {time.perf_counter() - t0:.1f} s", flush=True)
        for label, graphs in (("eager", False), ("graphs", None)):
            t0 = time.perf_counter()
            res = bench.measure(sc, dev, graphs=graphs)
            c, d = res["components"], res["diag"]
            row = dict(line=res["line"], components=c,
                       diag={k: d[k] for k in ("tracked", "frames", "n_kf_ever", "ate_m",
                                               "closures", "attempts", "ba_iters_total",
                                               "setup_s")},
                       run_s=time.perf_counter() - t0)
            out[f"{name} {label}"] = row
            print(f"{name} {label}: {json.dumps(res['line'])}; wall {c['wall_ms_per_frame']:.3f} "
                  f"ms/frame (walls {[round(w, 1) for w in c['walls_ms']]}); background device "
                  f"{c['background_device_ms']:.3f} ms (the profiler "
                  f"{c['background_device_ms_traced']:.3f} over frames {c['trace_window']}, CUDA "
                  f"events {c['background_device_ms_events']} outside them, "
                  f"{c['background_device_ms_events_window']} inside); device busy "
                  f"{c['device_busy_ms']:.3f} ms; kernels per frame "
                  f"{c['kernels_per_frame']:.1f}; warm-up and capture {c['setup_s']:.3f} s; host "
                  f"syncs per chunk {c['host_syncs_per_chunk']}; tracked {d['tracked']}/"
                  f"{d['frames']}, n_kf_ever {d['n_kf_ever']}, ATE {d['ate_m'] * 100:.4f} cm, "
                  f"closures {d['closures']}; {row['run_s']:.1f} s", flush=True)
        graphs_mod.clear_programs()  # the next scenario shares no program with this one
    print(card)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
