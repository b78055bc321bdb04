"""Eager global BA of one tree of the repo, timed on the card.

    python perf/gba_ab.py ROOT [--calls N]

imports ``vo_slam_test_tpu_torch`` and ``chip_smoke`` from the checkout at
ROOT, builds ``chip_smoke.gba_scene`` at the tests' caps (MapCaps(16, 2048,
12, 256)) and at the default MapCaps, and times ``global_bundle_adjust`` on
each: one untimed call, then N calls (default 5), each between two CUDA
events and followed by a synchronize. Prints the card's name and power limit
and one JSON line {"root", "ms": {"tests": [...], "default": [...]}, "cost":
{...}}. To compare two trees, run them alternately in one call on one card:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("perf/gba_ab.py: no CUDA device")
    import chip_smoke
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import global_ba

    if not global_ba.__file__.startswith(root):
        sys.exit(f"perf/gba_ab.py: imported {global_ba.__file__}, not the tree at {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ms, cost = {}, {}
    for label, caps in (("tests", MapCaps(16, 2048, 12, 256)), ("default", MapCaps())):
        m, _, cam = chip_smoke.gba_scene(caps, dev)
        out = global_ba.global_bundle_adjust(m, caps, cam, 0)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.calls):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = global_ba.global_bundle_adjust(m, caps, cam, 0)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms[label] = times
        cost[label] = chip_smoke.gba_cost(out, cam)[0]
    print(json.dumps(dict(root=args.root, ms=ms, cost=cost)))


if __name__ == "__main__":
    main()
