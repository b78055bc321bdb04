"""Main path 8 of chip_smoke.py alone, on the card: the JAX package's
benchmark configuration through the port's bench module (8a: kfdense, the
240-frame room orbit with the scene vocabulary, chunk=8; 8b: corner40 with u16
depth), with every check of the smoke run, without the other paths.

    python3 perf/path8_probe.py [--save-voc PATH]

Builds the kernels first (one nvcc per source, in parallel) and prints the
card's name and power limit, then the path's lines as the smoke run prints
them and one JSON line of the numbers. ``--save-voc PATH`` writes the kfdense
scene vocabulary trained here (an .npz in the JAX package's layout), which
``perf/kfdense_jax_cpu.py --voc PATH`` reads for the JAX package's CPU run.
Exits 1 without a CUDA device.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

import chip_smoke as cs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("path8_probe: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.ops import _build, ba_cuda, ba_pallas
    from vo_slam_test_tpu_torch.pipeline import system

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    if "--save-voc" in argv:
        path = argv[argv.index("--save-voc") + 1]
        t0 = time.perf_counter()
        bench.build_scenario("kfdense", "cuda").voc.save(path)
        print(f"kfdense scene vocabulary written to {path} ({time.perf_counter() - t0:.1f} s "
              f"with rendering and training)")
    t0 = time.perf_counter()
    report, launches, rows = cs.main_path8(system, ba_cuda, ba_pallas, cs.kernel_counters(),
                                           cs.plain_versions(), "cuda")
    print(f"  main path 8 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(report=report, launches=launches, dense_window=rows), default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
