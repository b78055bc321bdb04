"""Benchmark driver of the port: the counterpart of the JAX package's
``bench.py`` (repo root), with its scenarios, switches, gates and JSON line.

    python -m vo_slam_test_tpu_torch.bench                          # kfdense
    BENCH_SCENARIO=corner40 python -m vo_slam_test_tpu_torch.bench
    BENCH_CHUNK=4 python -m vo_slam_test_tpu_torch.bench            # frames per chunk

Scenarios:

- ``kfdense`` (the default): the 240-frame room orbit
  (``room_orbit_trajectory(240, loops=1.5)``, ``scene="room"``, seed 7) at
  640x480 with the fr1 extraction settings, f32 depth, an ORBvoc-shaped
  scene vocabulary (k=10, L=6) trained on the scene by
  ``datasets/staging.scene_vocabulary`` and ``SlamSystem(cfg,
  vocabulary=voc, chunk=8)`` at the default ``MapCaps``: about 40 keyframe
  events, point recycling throughout and a loop closure inside the window;
- ``corner40``: ``SyntheticRGBD(n_frames=40, seed=0, motion_scale=0.4)`` with
  u16 raw depth (the TUM on-disk format, scaled on the device) and
  ``synth_vocabulary(k=10, levels=6, seed=0)`` (10^6 words).

Frames are rendered and the vocabulary trained before anything is timed, and
both are cached in ``VO_STAGE_CACHE`` (``datasets/staging.py``).

The metric is ``bench.py``'s: the reference's 70 ms/frame baseline times the
tracking thread only, so ``tracking_ms_per_frame`` = (best wall of 3 fresh
systems - background device ms) / frames. Every frame is staged on the card
before t0 (the reference reads its images into RAM before its clock starts);
each timed run ends with ``_flush()`` and a ``torch.cuda.synchronize()``
before the clock stops, and ``results()`` runs after it. The background
device ms comes from one more run under ``torch.profiler``: the device time
of the kernels launched inside the ``background``, ``close_step`` and
``global_bundle`` ranges of ``pipeline/system.py`` (the JAX package's
background programs); a replayed graph's kernels are placed by the time of
their ``cudaGraphLaunch``.

The systems run the step programs (``SlamSystem``'s default on the card:
replayed CUDA graphs with conditional nodes, the loop close inside the
background program; a chunk is one replay of the tracking program and one of
the background program, each loop a WHILE node); ``measure(...,
graphs=False)`` times the eager path. The
programs are the process's for a static configuration (``utils.graphs.program``),
as the JAX package's jits are: the warm pass warms them up and captures
them, and the timed and traced systems replay them from their first chunk;
``setup_s`` reports a system's own host seconds of warm-ups and captures (0
for a system that found its programs captured; each timed run's is printed
on stderr). On the graph path the profiler traces a window of two chunks
after the captures (``trace_window``; a capture under the profiler, and a
trace of a whole run of replays, crashed the process on the card), and the
background device ms is the profiler's sum over the window plus the CUDA
events around each replay of the background program outside it
(``background_device_ms_events``). Inside the window each graph launch
waits on the host for the profiler, so the events there
(``background_device_ms_events_window``) are printed beside the profiler's
sum, not used. Device busy and kernels per frame cover the window only.

The port is host-bound: the background work also costs host time on the one
tracking thread, which the metric does not subtract. The components (wall
ms/frame, device busy ms, background device ms, background host wall ms,
kernels per frame, host syncs per chunk) go to stderr beside it.

Deviation from ``bench.py``: that script reports the full wall when its trace
fails. Here a failed trace is an error, and the benchmark runs on the card
only: without a CUDA device it exits non-zero with a message.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .bow.vocabulary import Vocabulary, synth_vocabulary
from .config import SlamConfig
from .datasets import SyntheticRGBD, ate_rmse, staging
from .datasets.synthetic import room_orbit_trajectory
from .pipeline.system import SlamSystem

BASELINE_MS = 70.0
CHUNK = 8  # frames per dispatched chunk; BENCH_CHUNK overrides
BG_RANGES = ("background", "close_step", "global_bundle")
KFDENSE_FRAMES, KFDENSE_LOOPS = 240, 1.5
CORNER_FRAMES = 40
# bench.py's kfdense gates: sustained keyframe creation and a sound trajectory
KFDENSE_MIN_KF_EVER = 25
KFDENSE_MAX_ATE_M = 0.35


@dataclasses.dataclass
class Scenario:
    """One benchmark configuration, staged on the host. ``min_kf_ever`` and
    ``max_ate_m`` are the kfdense gates (None: not checked); ``warm_frames``
    is the warm pass's length (None: the whole run)."""

    name: str
    cfg: SlamConfig
    frames: List[Tuple[np.ndarray, np.ndarray, float]]
    voc: Vocabulary
    gt_T_w_c: np.ndarray
    chunk: int = CHUNK
    min_kf_ever: Optional[int] = None
    max_ate_m: Optional[float] = None
    warm_frames: Optional[int] = None


def _pinhole_cfg(seq, **kw) -> SlamConfig:
    return SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                      camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0, **kw)


def kfdense_sequence() -> Tuple[SyntheticRGBD, SlamConfig]:
    """bench.py:123-132: the room orbit and its config."""
    seq = SyntheticRGBD(trajectory=room_orbit_trajectory(KFDENSE_FRAMES, loops=KFDENSE_LOOPS),
                        scene="room", seed=7)
    return seq, _pinhole_cfg(seq, camera_fps=30)


def corner40_sequence() -> Tuple[SyntheticRGBD, SlamConfig]:
    """bench.py:154-159: the corner sequence and its config."""
    seq = SyntheticRGBD(n_frames=CORNER_FRAMES, seed=0, motion_scale=0.4)
    return seq, _pinhole_cfg(seq)


def corner40_frames(seq, cfg) -> list:
    """bench.py:161-164: u16 raw depth (d * depth scale), scaled on the device."""
    return [(g, (d * cfg.camera_depthScale).astype(np.uint16), t)
            for g, d, t in (seq[i] for i in range(len(seq)))]


def build_scenario(name: str, device, chunk: int = CHUNK) -> Scenario:
    """Render (or load) the frames and train (or load) the vocabulary of
    ``name``, untimed; the vocabulary lands on ``device``."""
    if name == "kfdense":
        seq, cfg = kfdense_sequence()
        tag = f"orbit{KFDENSE_LOOPS}"
        grays, depths, times = staging.render_all(seq, KFDENSE_FRAMES, tag)
        voc = staging.scene_vocabulary(cfg, grays, depths, f"{tag}_{KFDENSE_FRAMES}",
                                       device=device)
        frames = [(g, d.astype(np.float32), t) for g, d, t in zip(grays, depths, times)]
        return Scenario(name, cfg, frames, voc, seq.poses[:KFDENSE_FRAMES], chunk,
                        min_kf_ever=KFDENSE_MIN_KF_EVER, max_ate_m=KFDENSE_MAX_ATE_M)
    if name == "corner40":
        seq, cfg = corner40_sequence()
        return Scenario(name, cfg, corner40_frames(seq, cfg),
                        synth_vocabulary(k=10, levels=6, seed=0, device=device),
                        seq.poses[:CORNER_FRAMES], chunk, warm_frames=3)
    raise ValueError(f"unknown BENCH_SCENARIO {name!r} (kfdense, corner40)")


def stage_frames(frames, device) -> list:
    """Every frame on ``device`` before the clock starts (the imread analogue,
    untimed in the reference)."""
    dev = torch.device(device)
    staged = [(torch.from_numpy(np.ascontiguousarray(g)).to(dev),
               torch.from_numpy(np.ascontiguousarray(d)).to(dev), t) for g, d, t in frames]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return staged


def track_all(sc: Scenario, frames_dev, device, syncs: Optional[list] = None,
              graphs: Optional[bool] = None) -> Tuple[SlamSystem, float]:
    """A fresh system (``graphs``: ``SlamSystem``'s switch, None its default)
    over the staged frames -> (system, wall s): every tracking and background
    kernel has finished when the clock stops. ``syncs`` (on the card): gets
    the host syncs of each chunk, counted in the sync debug mode (slower: not
    for a timed run)."""
    s = SlamSystem(sc.cfg, vocabulary=sc.voc, chunk=sc.chunk, device=device, graphs=graphs)
    count = syncs is not None and torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    for i, (g, d, ts) in enumerate(frames_dev):
        if not count:
            s.track(g, d, ts)
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            s.track(g, d, ts)
            torch.cuda.set_sync_debug_mode("default")
        if i % sc.chunk == 0:
            syncs.append(0)
        syncs[-1] += sum("synchroniz" in str(w.message) for w in caught)
    s._flush()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return s, time.perf_counter() - t0


def check(sc: Scenario, s: SlamSystem, n_frames: int) -> dict:
    """bench.py's asserts on a finished run (after the clock): every frame
    tracked; for kfdense ``n_kf_ever`` and ATE within the gates, with its
    stderr line and the closures as diagnostics -> the run's numbers."""
    traj, stats, _ = s.results()
    n_ok = sum(st.ok for st in stats)
    ate = ate_rmse(s.timestamps, sc.gt_T_w_c[:n_frames], s.timestamps, traj)
    its = np.asarray([(a, b) for _, a, b in s.ba_iters] or [(0, 0)])
    diag = dict(frames=n_frames, tracked=n_ok, n_kf_ever=int(s.map.n_kf_ever),
                keyframe_frames=[i for i, o in enumerate(s._outs) if o.made_kf],
                closures=list(s.loop_closures), attempts=list(s.loop_attempts),
                ate_m=float(ate), ba_iters_total=int(its.sum()),
                ba_iters_mean=float(its.sum(1).mean()), ba_iters_max=int(its.sum(1).max()),
                n_ba_interrupts=s.n_ba_interrupts)
    if n_ok != n_frames:
        raise AssertionError(f"tracking failed on {n_frames - n_ok} frames")
    if sc.min_kf_ever is None:
        return diag
    print(f"[bench] {sc.name}: KFs ever {diag['n_kf_ever']}, closures {diag['closures']}, "
          f"ATE {ate * 100:.2f} cm, BA iters total {diag['ba_iters_total']} (mean/event "
          f"{diag['ba_iters_mean']:.1f}, max {diag['ba_iters_max']}), ba_interrupts "
          f"{diag['n_ba_interrupts']}", file=sys.stderr)
    if not s.loop_closures:
        print(f"[bench] NOTE: no closure fired on this orbit (attempts: "
              f"{len(s.loop_attempts)})", file=sys.stderr)
    if ate > 0.08:
        print(f"[bench] WARNING: ATE {ate * 100:.1f} cm exceeds the 8 cm envelope",
              file=sys.stderr)
    if not diag["n_kf_ever"] >= sc.min_kf_ever:
        raise AssertionError(f"{diag['n_kf_ever']} keyframes ever < {sc.min_kf_ever}")
    if not ate < sc.max_ate_m:
        raise AssertionError(f"ATE {ate} m >= {sc.max_ate_m} m")
    return diag


def setup_s(s: SlamSystem) -> float:
    """Host seconds of the system's own warm-ups and captures of its step
    programs (0 eager, and for programs it found captured)."""
    return sum(g.warm_s + g.capture_s for g in (s.track_graph, s.background_graph))


def run(sc: Scenario, frames_dev, device, syncs: Optional[list] = None,
        graphs: Optional[bool] = None) -> Tuple[float, dict]:
    """One timed run, then the gates -> (wall s, the run's numbers, with the
    programs' ``setup_s``)."""
    s, wall = track_all(sc, frames_dev, device, syncs, graphs)
    return wall, dict(check(sc, s, len(frames_dev)), setup_s=setup_s(s))


# ---------------------------------------------------------------------------
# the traced run: device time inside the background ranges
# ---------------------------------------------------------------------------


def trace_rows(prof) -> Tuple[list, list]:
    """A finished ``torch.profiler`` run -> (host ranges (start, end) ns of
    the background annotations, device activities (launch ns or None, ns)).
    A device activity's launch time is that of its runtime call (the host
    event with its correlation id: linked to a host op, or a CUDA runtime or
    driver call, named ``cu...``, made outside any op), else the start of the
    host op or annotation the activity is linked to. The device spans of the
    annotations themselves are not activities."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ranges, device, runtime, host = [], [], {}, []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if e.linked_correlation_id() > 0 or name.startswith("cu"):
                runtime[e.correlation_id()] = e.start_ns()
            else:
                host.append(e)
                if name in BG_RANGES:
                    ranges.append((e.start_ns(), e.end_ns()))
        elif not (e.is_user_annotation() or e.name() in BG_RANGES):
            device.append((e.correlation_id(), e.linked_correlation_id(), e.duration_ns()))
    need = {lc for c, lc, _ in device if c not in runtime and lc > 0}
    starts = {e.correlation_id(): e.start_ns() for e in host if e.correlation_id() in need}
    return ranges, [(runtime[c] if c in runtime else starts.get(lc), ns) for c, lc, ns in device]


def _union(ranges) -> list:
    """Sorted, merged intervals (nested ranges count once)."""
    out = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def background_device_ms(ranges, acts) -> dict:
    """Device ms of the activities launched inside the background ranges,
    the total device ms, the activity count, the host ms of the ranges and
    the activities whose launch time is unknown."""
    merged = _union(ranges)
    starts = [a for a, _ in merged]
    bg = total = 0
    unplaced = 0
    for t, ns in acts:
        total += ns
        if t is None:
            unplaced += 1
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= merged[j][1]:
            bg += ns
    return dict(bg_ms=bg / 1e6, device_ms=total / 1e6, n_device=len(acts),
                bg_host_ms=sum(b - a for a, b in merged) / 1e6, unplaced=unplaced)


def time_background_replays(s: SlamSystem, spans: list) -> None:
    """On the card's graph path: a CUDA event pair around each replay of the
    system's background program, one per chunk (not its warm-up and capture,
    whose host time is ``setup_s``), appended to ``spans``."""
    if not (s.graphs and s.device.type == "cuda"):
        return
    program = s.background_graph
    run_program = program.run

    def timed(*args):
        if program.graph is None:
            return run_program(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run_program(*args)
        e1.record()
        spans.append((e0, e1))
        return out

    s.background_graph.run = timed


def trace_window(sc: Scenario, n_frames: int, on_graphs: bool) -> range:
    """The frames the traced run profiles: all of them when eager; on the
    graph path two chunks from the middle of the run, after the programs'
    captures (a capture under the profiler, and a trace of a whole run of
    replays, crashed the process on the card)."""
    if not on_graphs:
        return range(n_frames)
    start = max(1, n_frames // sc.chunk // 2 - 1) * sc.chunk
    return range(start, min(n_frames, start + 2 * sc.chunk))


def traced_run(sc: Scenario, frames_dev, device, graphs: Optional[bool] = None
               ) -> Tuple[float, dict]:
    """One more run under ``torch.profiler`` (CUDA activities on the card)
    over ``trace_window``'s frames -> (wall s, ``background_device_ms``'s
    dict, with ``window`` (first frame, frames) and, on the graph path, the
    CUDA events' sum over the background program's replays outside the
    window (``events_ms``) and over those inside it (``events_window_ms``,
    beside the profiler's ``bg_ms``: inside the window each launch waits on
    the host for the profiler, which the events count), else None).
    ``TEARDOWN_CUPTI=1`` (unless set): a profiler session that leaves CUPTI
    attached makes every later graph launch cost host time in proportion to
    the graph's nodes (78 ms a launch of the background program's 180,507 on
    the card)."""
    from torch.profiler import ProfilerActivity, profile

    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    s = SlamSystem(sc.cfg, vocabulary=sc.voc, chunk=sc.chunk, device=device, graphs=graphs)
    spans: list = []
    time_background_replays(s, spans)
    window = trace_window(sc, len(frames_dev), s.graphs and cuda)
    prof, on, spans_in = profile(activities=acts), False, [0, 0]

    def toggle():
        nonlocal on
        if cuda:
            torch.cuda.synchronize(device)
        if on:
            prof.stop()
        else:
            prof.start()
        on = not on
        spans_in[on] = len(spans)

    t0 = time.perf_counter()
    try:
        for i, (g, d, ts) in enumerate(frames_dev):
            if i == window.start:
                toggle()
            s.track(g, d, ts)
            if i == window.stop - 1 and window.stop < len(frames_dev):
                toggle()
        s._flush()
        if on:
            toggle()
        wall = time.perf_counter() - t0
    finally:
        if on:
            prof.stop()
    t0 = time.perf_counter()
    bg = background_device_ms(*trace_rows(prof))
    bg["parse_s"] = time.perf_counter() - t0
    bg["window"] = (window.start, len(window))
    if spans:  # the last chunk's background replay may still run on the card
        torch.cuda.synchronize(device)
    ms = [e0.elapsed_time(e1) for e0, e1 in spans]
    inside = sum(ms[spans_in[1]:spans_in[0]])
    bg["events_ms"] = sum(ms) - inside if spans else None
    bg["events_window_ms"] = inside if spans else None
    check(sc, s, len(frames_dev))
    if torch.device(device).type == "cuda" and not bg["n_device"]:
        raise RuntimeError("the trace recorded no device activity")
    return wall, bg


def measure(sc: Scenario, device, reps: int = 3, graphs: Optional[bool] = None) -> dict:
    """The protocol of bench.py:173-297: frames staged on the device, a warm
    pass (counting host syncs per chunk), the best wall of ``reps`` fresh
    systems, one traced run -> dict(line=the JSON line, components, diag).
    ``graphs``: ``SlamSystem``'s switch for every system (None: its
    default). As the JAX package's jits, the step programs are the
    process's: the warm pass warms them up and captures them, and the timed
    and traced systems replay them (each timed run's ``setup_s``, 0 then, is
    printed on stderr)."""
    frames_dev = stage_frames(sc.frames, device)
    n = len(frames_dev)
    syncs: list = []
    if sc.warm_frames is None:
        run(sc, frames_dev, device, syncs, graphs)
    else:
        warm = SlamSystem(sc.cfg, vocabulary=sc.voc, chunk=sc.chunk, device=device,
                          graphs=graphs)
        for f in frames_dev[:sc.warm_frames]:
            warm.track(*f)
        warm.results()
        del warm
    walls, diags = [], []
    for i in range(reps):
        wall, diag = run(sc, frames_dev, device, graphs=graphs)
        walls.append(wall)
        diags.append(diag)
        print(f"[bench] {sc.name}: timed run {i}: wall {wall * 1e3:.1f} ms, setup_s "
              f"{diag.get('setup_s')!r}", file=sys.stderr)
    best = int(np.argmin(walls))
    diag = diags[best]
    best_ms = walls[best] * 1e3
    traced_s, bg = traced_run(sc, frames_dev, device, graphs)
    # the graph path's background device time: the CUDA events over the
    # replays outside the traced window, the profiler's sum inside it
    bg_ms = bg["bg_ms"] + (bg["events_ms"] or 0.0)
    ms = (best_ms - min(bg_ms, 0.9 * best_ms)) / n  # bench.py's sanity clamp
    components = dict(
        wall_ms_per_frame=best_ms / n, walls_ms=[w * 1e3 for w in walls],
        traced_wall_ms=traced_s * 1e3, device_busy_ms=bg["device_ms"],
        background_device_ms=bg_ms, background_device_ms_traced=bg["bg_ms"],
        background_host_wall_ms=bg["bg_host_ms"],
        kernels_per_frame=bg["n_device"] / bg["window"][1], unplaced_activities=bg["unplaced"],
        trace_parse_s=bg["parse_s"], host_syncs_per_chunk=syncs,
        background_device_ms_events=bg["events_ms"],
        background_device_ms_events_window=bg["events_window_ms"],
        trace_window=bg["window"], setup_s=diag["setup_s"])
    line = {"metric": "tracking_ms_per_frame", "value": round(ms, 3), "unit": "ms",
            "vs_baseline": round(BASELINE_MS / ms, 3)}
    return dict(line=line, components=components, diag=diag)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card listed"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: unavailable ({e.__class__.__name__})"


def report(res: dict, card: str) -> None:
    """The components on stderr, then the card line and the JSON line."""
    c, d = res["components"], res["diag"]
    syncs = c["host_syncs_per_chunk"]
    sync_text = (f"{sum(syncs) / len(syncs):.1f} (max {max(syncs)})" if syncs else
                 "not counted (counted in a whole-run warm pass only)")
    print(f"[bench] wall best {c['wall_ms_per_frame'] * d['frames']:.1f} ms "
          f"({c['wall_ms_per_frame']:.3f} ms/frame; walls {[round(w, 1) for w in c['walls_ms']]}), "
          f"traced wall {c['traced_wall_ms']:.1f} ms, device busy {c['device_busy_ms']:.1f} ms, "
          f"background device {c['background_device_ms']:.1f} ms, background host wall "
          f"{c['background_host_wall_ms']:.1f} ms (traced run), kernels per frame "
          f"{c['kernels_per_frame']:.0f}, host syncs per chunk {sync_text}, trace parsed in "
          f"{c['trace_parse_s']:.1f} s "
          f"({c['unplaced_activities']} activities without a launch time); background device "
          f"by CUDA events around the background program's calls "
          f"{c['background_device_ms_events']} ms outside the traced window (frame and "
          f"length {c['trace_window']}; inside it {c['background_device_ms_events_window']} "
          f"ms, the profiler {c['background_device_ms_traced']:.1f} ms); step "
          f"programs' warm-up and capture "
          f"{c['setup_s']:.3f} s in the best timed run", file=sys.stderr)
    print(f"[bench] {d['tracked']}/{d['frames']} tracked, keyframe events at "
          f"{d['keyframe_frames']}, closures {d['closures']}, attempts {d['attempts']}",
          file=sys.stderr)
    print(card, file=sys.stderr)
    print(json.dumps(res["line"]), flush=True)


def main(device=None) -> int:
    """The benchmark on the card (``device``: the tests pass ``"cpu"``)."""
    name = os.environ.get("BENCH_SCENARIO", "kfdense")
    chunk = int(os.environ.get("BENCH_CHUNK", str(CHUNK)))
    if device is None:
        if not torch.cuda.is_available():
            print("[bench] FATAL: no CUDA device; the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda")
    card = card_line()
    print(card, file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    sc = build_scenario(name, device, chunk)
    print(f"[bench] {name}: {len(sc.frames)} frames staged on the host, vocabulary k={sc.voc.k} "
          f"L={sc.voc.levels}, chunk {sc.chunk} ({time.perf_counter() - t0:.1f} s, untimed)",
          file=sys.stderr, flush=True)
    try:
        res = measure(sc, device)
    except RuntimeError as e:
        print(f"[bench] FATAL: {e}", file=sys.stderr)
        return 3
    report(res, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
