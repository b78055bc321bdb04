"""The quad-tree kernel (``csrc/distribute.cu``) on the card, on the benchmark's
fr1_xyz frames (``slambench/configs/fr1_xyz.json``).

    python3 perf/distribute_probe.py [--seed N] [--frames N]

Run from the root of a checkout. Prints, one JSON line each:

- ``card`` and ``build``: the card, and the compiler's register and shared
  memory report for the kernel;
- ``equal``: on each of ``--frames`` distinct frames, the kernel's [L, M]
  keep mask against the plain version's (``distribute_level`` a level, on the
  CPU), and the valid and kept candidates a level of the first frame;
- ``timing``: on the frame with the most valid candidates, the kernel alone
  by graph replay (20 launches a graph, 5 replays), its bound (pair tests by
  instruction class, bytes), the launch floor (the ``noop`` kernel timed the
  same way), the plain version's eight calls eager (one call, after a warm-up)
  and captured in a graph (the quad-tree as the tracking program ran it
  before the kernel).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from slambench import kernels as kmod  # noqa: E402
from slambench import run as bench_run  # noqa: E402
from vo_slam_test_tpu_torch.frontend.extractor import quad_tree_levels  # noqa: E402
from vo_slam_test_tpu_torch.ops import _build, distribute_cuda, fast  # noqa: E402
from vo_slam_test_tpu_torch.ops.distribute_device import distribute_level  # noqa: E402
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior  # noqa: E402

# per pair test: the xor, the two minima (one predicated) and the response
# compare, each at the 64-lane rate (as chip_smoke.DISTRIBUTE_PAIR_OPS)
PAIR_OPS = {"alu": 4}
# bytes a candidate: x, y, response, valid read, keep written
CANDIDATE_BYTES = 4 + 4 + 4 + 1 + 1


def emit(kind: str, **row) -> None:
    print(json.dumps(dict(kind=kind, **row)), flush=True)


def candidates(gray, spec):
    pyr = build_pyramid(gray, spec)
    c = fast.detect_pyramid(interior(pyr.raw, spec), spec, 20.0, 7.0, 8)
    L = spec.n_levels
    return tuple(t.reshape(L, -1) for t in (c.xs, c.ys, c.response, c.valid))


def plain(args, levels):
    xs, ys, resp, valid = args
    return torch.stack([distribute_level(xs[l], ys[l], resp[l], valid[l], lv.bounds, lv.target,
                                         n_ini=lv.n_ini) for l, lv in enumerate(levels)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3000002025)
    ap.add_argument("--frames", type=int, default=39)
    args = ap.parse_args(argv)
    bench_run.set_cache_dirs()
    emit("card", card=bench_run.card_line(), torch=torch.__version__)
    built = _build.build()
    log = built.get("distribute", {}).get("log", "")
    emit("build", seconds=built.get("distribute", {}).get("seconds"),
         ptxas=[ln.strip() for ln in log.splitlines() if "distribute" in ln or "Used" in ln])

    cfg = bench_run.read_json("configs", "fr1_xyz")
    inp = bench_run.make_inputs(cfg, args.seed, torch.device("cuda"))
    slam = inp.slam_cfg
    spec = PyramidSpec(slam.camera_width, slam.camera_height, slam.level_pyramid,
                       slam.scale_factor)
    levels = quad_tree_levels(spec, spec.budget(slam.num_of_features))

    n_equal, most, most_args = 0, -1, None
    for i in range(args.frames):
        a = candidates(inp.frame(i)[0], spec)
        got = distribute_cuda.distribute(*a, levels).cpu()
        want = plain(tuple(t.cpu() for t in a), levels)
        n_equal += bool(torch.equal(got, want))
        pairs = int((a[3].sum(dim=1).to(torch.int64) ** 2).sum())
        if pairs > most:
            most, most_args = pairs, a
        if i == 0:
            emit("frame0", M=int(a[0].shape[1]), valid=a[3].sum(dim=1).tolist(),
                 kept=want.sum(dim=1).tolist(), targets=[lv.target for lv in levels])
    emit("equal", frames=args.frames, equal=n_equal)

    a = most_args
    L, M = a[0].shape
    ops = {k: v * most for k, v in PAIR_OPS.items()}
    bound, by = kmod.bound_ms(L * M * CANDIDATE_BYTES, ops)
    noop = _build.Kernel("noop", "noop_launch", [ctypes.c_int, ctypes.c_void_p])
    floor = kmod.time_graph_ms(lambda: noop(1, torch.cuda.current_stream().cuda_stream))
    ms = kmod.time_graph_ms(lambda: distribute_cuda.distribute(*a, levels))
    plain(a, levels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    plain(a, levels)
    ev[1].record()
    torch.cuda.synchronize()
    plain_eager = ev[0].elapsed_time(ev[1])
    plain_host = (time.perf_counter() - t0) * 1e3
    plain_graph = kmod.time_graph_ms(lambda: plain(a, levels), n_per_graph=2, reps=10)
    emit("timing", pairs=most, valid=a[3].sum(dim=1).tolist(), ms=ms, floor_ms=floor,
         x_floor=ms / floor, bound_ms=bound, bound_by=by, roofline_pct=100 * bound / ms,
         plain_eager_ms=plain_eager, plain_eager_host_ms=plain_host, plain_graph_ms=plain_graph)
    return 0


if __name__ == "__main__":
    sys.exit(main())
