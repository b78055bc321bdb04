"""The spans and counters inside the step programs on the card, on the
benchmark's fr1_xyz deployment (``slambench/configs/fr1_xyz.json``).

    python3 perf/span_probe.py [--seed N] [--frames N] [--nodes-only] [--live MODES]

Run from the root of a checkout (the parent's too: ``--nodes-only`` uses
nothing this probe measures beside the node counts). Prints, one JSON line
each:

- ``nodes``: the tracking and background programs' ``n_nodes`` / ``n_if`` /
  ``n_while`` at ``chunk`` 1 and 8, captured outside ``counting()`` (and
  inside it);
- ``clock``: ``%globaltimer``'s resolution, ten calibrations' offsets and
  error bounds, and the drift between the first and the last;
- per ``chunk`` (8, and 1 unpaced) and per mode (``off``: counting off;
  ``counters``: counting on with every ``span`` a no-op, the node counters
  alone; ``spans``: counting on): ``--frames`` frames of one system, CUDA
  events around each replay as ``slambench.run`` takes them
  (``tracking_program_ms``), and with counting the stage spans, the
  ``program`` spans (``tracking_graph_ms``), their coverage, the graph nodes
  and the host spans a frame;
- ``--live off,counters,spans,...`` instead: ``fr1_xyz.live36``'s paced window
  once per mode named (``timed_live``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from slambench import run as bench_run  # noqa: E402
from vo_slam_test_tpu_torch.ops import _build  # noqa: E402
from vo_slam_test_tpu_torch.utils import graphs  # noqa: E402

TRACKING = ("extract", "bow", "attempts", "local_map", "keyframe")


def emit(kind: str, **row) -> None:
    print(json.dumps(dict(kind=kind, **row)), flush=True)


def nodes(inp, chunk: int, counted: bool) -> dict:
    graphs.clear_programs()
    with graphs.counting() if counted else contextlib.nullcontext():
        s = bench_run.make_system(inp, chunk, torch.device("cuda"))
        for i in range(4 if chunk == 1 else 2 * chunk):
            s.track(*inp.frame(i))
        s.results()
    return {p: (g.n_nodes, g.n_if, g.n_while)
            for p, g in (("tracking", s.track_graph), ("background", s.background_graph))}


def clock_rows() -> None:
    dev = torch.device("cuda")
    res = graphs.timer_resolution(dev)
    pts = [graphs.calibrate(dev) for _ in range(10)]
    c = graphs.clock(dev)
    emit("clock", resolution=res, offsets_ns=[g - h for h, g, _ in pts],
         errors_ns=[e for _, _, e in pts], drift=c["drift"], error_ns=c["error_ns"])


def timed(inp, chunk: int, mode: str, frames: int) -> None:
    """One system over ``frames`` frames in ``mode`` (module docstring),
    after a warm-up system of the same key."""
    graphs.clear_programs()
    null = (lambda name: contextlib.nullcontext()) if mode == "counters" else None
    real = graphs.span
    if null is not None:
        graphs.span = null
    try:
        with graphs.counting() if mode != "off" else contextlib.nullcontext():
            bench_run.warm_up(inp, chunk, torch.device("cuda"))
            clock = bench_run.Clock(torch.device("cuda"))
            spans = bench_run.Spans(clock, True)
            s = bench_run.make_system(inp, chunk, torch.device("cuda"))
            spans.attach(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(frames):
                s.track(*inp.frame(i))
            s.results()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        graphs.span = real
    track_ms = sum(clock.ms(a, b) for a, b in spans.track)
    row = dict(chunk=chunk, mode=mode, frames=frames, frames_per_s=frames / wall,
               tracking_program_ms=track_ms / frames,
               background_program_ms=sum(clock.ms(a, b) for a, b in spans.background) / frames,
               n_nodes=s.track_graph.n_nodes)
    if mode != "off":
        tr = s.trace()
        st = tr["stages"]
        prog = st["tracking"].get("program", (0, 0))[0]
        row.update(
            stages_ms={p: {k: v[0] / 1e6 / frames for k, v in st[p].items()} for p in st},
            runs={p: {k: v[1] for k, v in st[p].items()} for p in st},
            coverage=(sum(st["tracking"].get(k, (0, 0))[0] for k in TRACKING) / prog
                      if prog else None),
            graph_nodes_per_frame=sum(tr["graph_nodes"].values()) / frames,
            node_runs=tr["node_runs"], clock=tr["clock"])
        host: dict = {}
        for sp in tr["spans"]:
            host[sp["name"]] = host.get(sp["name"], 0) + (sp["end_ns"] - sp["start_ns"])
        row["spans_ms"] = {k: v / 1e6 / frames for k, v in host.items()}
        gaps = sorted((g["start_ns"] - tr["spans"][g["parent"]]["start_ns"]) / 1e6
                      for g in tr["spans"] if g["name"] == "tracking_graph")
        row["replay_start_ms_p50"] = gaps[len(gaps) // 2] if gaps else None
    emit("timed", **row)


def timed_live(inp, mode: str) -> None:
    """``fr1_xyz.live36``'s window (one recording sent at its due times, as
    ``slambench.run`` sends it) in ``mode``, after a warm-up of the same key:
    latency p50, ``tracking_program_ms`` from the harness's events and, with
    counting, the device spans a frame and the per-replay program span's
    quartiles."""
    graphs.clear_programs()
    traffic = bench_run.read_json("traffic", "live36")
    real = graphs.span
    if mode == "counters":
        graphs.span = lambda name: contextlib.nullcontext()
    try:
        with graphs.counting() if mode != "off" else contextlib.nullcontext():
            bench_run.warm_up(inp, traffic["chunk"], torch.device("cuda"))
            win = bench_run.run_window(inp, traffic, 1, torch.device("cuda"), True,
                                       bench_run.make_system)
    finally:
        graphs.span = real
    s = win.systems[0]
    row = dict(mode=mode, frame_ms_p50=bench_run.percentile(win.latency_ms, 50),
               tracking_program_ms=sum(win.track_ms) / win.frames,
               track_host_ms=sum(win.host_track_ms) / win.frames)
    if mode != "off":
        tr = s.trace()
        row["stages_ms"] = {k: v[0] / 1e6 / win.frames for k, v in tr["stages"]["tracking"].items()}
        per = sorted((g["end_ns"] - g["start_ns"]) / 1e6 for g in tr["spans"]
                     if g["name"] == "tracking_graph")
        row["graph_ms_quartiles"] = [per[len(per) // 4], per[len(per) // 2], per[3 * len(per) // 4]]
    emit("live", **row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3000000123)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--nodes-only", action="store_true")
    ap.add_argument("--live", default=None,
                    help="comma-separated modes (off, counters, spans) of fr1_xyz.live36's "
                         "window, in this order, and nothing else")
    args = ap.parse_args(argv)
    bench_run.set_cache_dirs()
    emit("card", card=bench_run.card_line(), torch=torch.__version__, root=os.getcwd())
    _build.build()
    cfg = bench_run.read_json("configs", "fr1_xyz")
    inp = bench_run.make_inputs(cfg, args.seed, torch.device("cuda"))
    if args.live:
        for mode in args.live.split(","):
            timed_live(inp, mode)
        return 0
    for chunk in (1, 8):
        emit("nodes", chunk=chunk, off=nodes(inp, chunk, False),
             counted=None if args.nodes_only else nodes(inp, chunk, True))
    if args.nodes_only:
        return 0
    clock_rows()
    for chunk in (8, 1):
        for mode in ("off", "counters", "spans", "off"):
            timed(inp, chunk, mode, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
