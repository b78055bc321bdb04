"""Readers of the port's own spans and counters, for the per-layer metrics in
``metrics/`` that read inside the step programs: ``Program.spans`` (device
ns and runs of each stage span and of each replay's ``program`` span),
``Program.graph_nodes_run`` (graph nodes executed on the device) and
``SlamSystem.trace`` (the host spans and each replay on one clock). Each sums
over the window's systems and divides by the window's frames, as
``tracking_program_ms`` does, and returns None where the program has no such
span or counter (a port without them, or a run outside
``graphs.counting()``)."""

from __future__ import annotations

import statistics
from typing import Optional

PROGRAMS = {"tracking": "track_graph", "background": "background_graph"}


def span_ms(trace, program: str, name: str) -> Optional[float]:
    """Device ms a frame in span ``name`` of the ``program`` ("tracking" or
    "background") program; ``program`` is each replay, first node to last."""
    w = trace.window
    total, found = 0, False
    for s in w.systems:
        spans = getattr(getattr(s, PROGRAMS[program], None), "spans", None)
        if spans is None:
            return None
        got = spans().get(name)
        if got is not None and got[1]:
            total += got[0]
            found = True
    return total / 1e6 / w.frames if found and w.frames else None


def graph_nodes_per_frame(trace) -> Optional[float]:
    """Graph nodes the replays of both programs executed, a frame."""
    w = trace.window
    total = 0
    for s in w.systems:
        for attr in PROGRAMS.values():
            run = getattr(getattr(s, attr, None), "graph_nodes_run", None)
            if run is None:
                return None
            total += run()
    return total / w.frames if w.frames else None


def _traces(trace):
    for s in trace.window.systems:
        get = getattr(s, "trace", None)
        if get is None:
            return
        yield get()["spans"]


def replay_start_ms(trace) -> Optional[float]:
    """The median over the tracking replays of the time from the host's
    launch call to the graph's first stamp, on the shared clock."""
    gaps = [(sp["start_ns"] - spans[sp["parent"]]["start_ns"]) / 1e6
            for spans in _traces(trace) for sp in spans if sp["name"] == "tracking_graph"]
    return statistics.median(gaps) if gaps else None


def pre_launch_host_ms(trace) -> Optional[float]:
    """Host ms from entering ``track`` to the launch call of the tracking
    replay it makes, averaged over the frames that make one."""
    gaps = []
    for spans in _traces(trace):
        for sp in spans:
            if sp["name"] != "tracking_graph":
                continue
            launch = spans[sp["parent"]]
            up = launch
            while up["parent"] >= 0 and up["name"] != "track":
                up = spans[up["parent"]]
            if up["name"] == "track":
                gaps.append((launch["start_ns"] - up["start_ns"]) / 1e6)
    return sum(gaps) / len(gaps) if gaps else None
