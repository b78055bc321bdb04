"""The benchmark of ``vo_slam_test_tpu_torch`` on one card.

    python3 -m slambench.run --workload fr1_xyz.live36 --seed 7 --seconds 30 --trace 0

One run is one process: it loads, makes the cell's inputs on the card from
``--seed``, warms up the cell's own step programs (counted in ``setup_s``),
drives the window, checks what the window produced against the plain
reference (``slambench/reference.py``), and prints one JSON line last on
standard output. Everything about a cell comes from files found by name:
``BENCHMARK.json`` names the cell's configuration (``configs/<name>.json``),
its traffic (``traffic/<name>.json``) and its metrics; a per-layer metric is
read by ``metrics/<name>.py``.

The window processes ``--seconds`` of camera time: ``ceil(seconds * fps /
frames)`` whole recordings of the configuration, each a fresh
``SlamSystem`` over the same staged frames. Traffic ``live``: each frame is
sent at its due time on the camera's schedule (open loop), and its latency
runs from the due time to the end of its tracking program on the card's
clock. Traffic ``offline``: frames are sent as fast as the system takes them,
and the rate is all frames over all the time from the window's start to the
last recording's ``results()``.

With ``--trace 1`` the run also records CUDA events around each replay of
the tracking and background programs and the host time of each ``track``
call, and prints the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
# top-level module names that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "vo_slam_test_tpu")


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    with open(bench / kind / f"{name}.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(manifest: dict, name: str) -> dict:
    """The cell's entry with its end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = dict(cells[name])
    w["end_to_end"] = [m for m in manifest["end_to_end"] if applies(m, name)]
    w["per_layer"] = [m for m in manifest["per_layer"] if applies(m, name)]
    return w


def load_reader(name: str, bench: Path = BENCH) -> Callable:
    """``metrics/<name>.py``'s ``read(trace) -> value or None``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Inputs:
    """A cell's staged inputs: the distinct frames on the device, the ground
    truth of one recording, the port's configuration and vocabulary."""

    gray: object          # [D,H,W] u8 on the device
    depth: object         # [D,H,W] f32 metres, or u16 raw (depth factor)
    depth_m: object       # [D,H,W] f32 metres as the reference reads them
    gt: object            # [F,4,4] T_w_c of a recording's frames
    frames: int           # frames of a recording
    fps: float
    slam_cfg: object
    voc: object

    def frame(self, i: int):
        k = i % self.gray.shape[0]
        return self.gray[k], self.depth[k], i / self.fps


def file_sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def synthetic_vocabulary(voc_cfg: dict, seed: int, device):
    """An ORBvoc-shaped vocabulary of random centroids, drawn on the device
    from ``seed`` (the port's ``synth_vocabulary`` in shape and distribution)."""
    import torch

    from vo_slam_test_tpu_torch.bow.vocabulary import Vocabulary

    k, levels = voc_cfg["k"], voc_cfg["levels"]
    lo, hi = voc_cfg["idf_range"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2**63))
    cents = [torch.randint(-2**31, 2**31, (k ** (l + 1), 8), generator=g, device=device,
                           dtype=torch.int64).to(torch.int32) for l in range(levels)]
    idf = torch.rand(k ** levels, generator=g, device=device) * (hi - lo) + lo
    valid = [torch.ones(k ** (l + 1), dtype=torch.bool, device=device) for l in range(levels)]
    return Vocabulary(k=k, levels=levels, centroids=cents, idf=idf, node_valid=valid)


def load_vocabulary(voc_cfg: dict, seed: int, device, bench: Path = BENCH):
    from vo_slam_test_tpu_torch.bow.vocabulary import Vocabulary

    if voc_cfg["kind"] == "synthetic":
        return synthetic_vocabulary(voc_cfg, seed, device)
    path = bench / voc_cfg["file"]
    got = file_sha256(path)
    if got != voc_cfg["sha256"]:
        raise RuntimeError(f"{path}: sha256 {got} is not the configuration's {voc_cfg['sha256']}")
    return Vocabulary.load(str(path), device)


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    """Render the configuration's frames on ``device`` from ``seed`` (the
    scene's textures), and load or draw its vocabulary."""
    import numpy as np
    import torch

    from vo_slam_test_tpu_torch.config import SlamConfig

    from . import scene

    sc = cfg["scene"]
    slam = SlamConfig.from_dict(cfg["slam"])
    cam = scene.Camera(slam.camera_width, slam.camera_height, slam.camera_fx, slam.camera_fy,
                       slam.camera_cx, slam.camera_cy)
    tex_seed = abs(int(seed))
    if sc["trajectory"] == "room_orbit":
        poses = scene.room_orbit(sc["orbit_frames"], sc["loops"])
    elif sc["trajectory"] == "corner":
        poses = scene.corner_trajectory(sc["period"] + 1, sc["motion_scale"])[:sc["period"]]
    else:
        raise ValueError(f"unknown trajectory {sc['trajectory']!r}")
    planes = scene.scene_planes(sc["kind"], tex_seed)
    log(f"textures drawn {time.perf_counter() - T_START:.3f} s after start")
    gray, depth = scene.render(planes, poses, cam, device)
    frames = cfg["recording_frames"]
    gt = np.stack([poses[i % poses.shape[0]] for i in range(frames)])
    depth_m = depth
    if cfg["depth_format"] == "u16":
        depth = (depth * float(slam.camera_depthScale)).to(torch.int32).to(torch.uint16)
        depth_m = depth.to(torch.float32) * (1.0 / float(slam.camera_depthScale))
    voc = load_vocabulary(cfg["vocabulary"], seed, device)
    return Inputs(gray, depth, depth_m, gt, frames, float(slam.camera_fps), slam, voc)


# ---------------------------------------------------------------------------
# clocks and spans
# ---------------------------------------------------------------------------


class Clock:
    """Marks on the card's clock (CUDA events), or on the host's without a card."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


class Spans:
    """Marks around each replay of a system's tracking and background
    programs: ``done`` is the mark after the last tracking replay; with
    ``trace`` each replay's (start, end) goes to ``track`` / ``background``,
    and to ``order`` with what the host did before it (``label`` for a
    tracking replay; the dispatch's own work between the two programs for a
    background replay)."""

    def __init__(self, clock: Clock, trace: bool):
        self.clock, self.trace = clock, trace
        self.track: list = []
        self.background: list = []
        self.order: list = []
        self.label = "host_dispatch"
        self.done = None

    def attach(self, s) -> None:
        for prog, spans, is_track in ((s.track_graph, self.track, True),
                                      (s.background_graph, self.background, False)):
            run = prog.run

            def timed(inputs, state, _run=run, _spans=spans, _is_track=is_track):
                a = self.clock.mark() if self.trace else None
                out = _run(inputs, state)
                b = self.clock.mark()
                if self.trace:
                    _spans.append((a, b))
                    self.order.append((a, b, self.label if _is_track else "between_programs"))
                if _is_track:
                    self.done = b
                return out

            prog.run = timed


@dataclasses.dataclass
class Window:
    """What a window produced and how long it took."""

    frames: int
    recordings: int
    seconds: float              # host clock, window start to its last sync
    device_ms: float            # card clock, the same interval
    latency_ms: List[float]     # per frame (live): due time to its tracking's end
    late_ms: List[float]        # per frame (live): how late the sender ran
    host_track_ms: List[float]  # per track() call
    track_ms: List[float]       # per tracking replay (trace)
    background_ms: List[float]  # per background replay (trace)
    trajectories: list          # per recording: (T_w_c [F,4,4], ok [F])
    systems: list
    gaps_ms: Dict[str, float]   # card idle between replays (trace), by the host's work before


def wait_until(t: float) -> None:
    while True:
        d = t - time.perf_counter()
        if d <= 0:
            return
        time.sleep(d - 0.001 if d > 0.002 else 0)


def run_window(inp: Inputs, traffic: dict, recordings: int, device, trace: bool,
               make_system: Callable, pace: bool = True) -> Window:
    """Drive ``recordings`` fresh systems over the recording's frames
    (``pace=False``: live traffic sent without waiting for the due times,
    for readings that need the outputs alone)."""
    import numpy as np

    clock = Clock(device)
    spans = Spans(clock, trace)
    live = traffic["mode"] == "live" and pace
    period = 1.0 / traffic["rate_hz"] if live else 0.0
    done, late, host, trajs, systems = [], [], [], [], []
    clock.sync()
    t0 = time.perf_counter()
    start = clock.mark()
    j = 0
    for _ in range(recordings):
        s = None
        for i in range(inp.frames):
            if live:
                wait_until(t0 + j * period)
                late.append((time.perf_counter() - t0 - j * period) * 1e3)
            t = time.perf_counter()
            if s is None:
                s = make_system(inp, traffic["chunk"], device)
                spans.attach(s)
                # the host's work before a new system's first replay: the last
                # recording's results(), the new system and its first frame
                spans.label = "new_system"
            spans.done = None
            s.track(*inp.frame(i))
            host.append((time.perf_counter() - t) * 1e3)
            if spans.done is not None:
                spans.label = "waiting_for_the_camera" if live else "host_dispatch"
            if live:
                done.append(spans.done if spans.done is not None else clock.mark())
            j += 1
        traj, stats, _ = s.results()
        trajs.append((traj, np.array([st.ok for st in stats], bool)))
        systems.append(s)
    clock.sync()
    seconds = time.perf_counter() - t0
    end = clock.mark()
    clock.sync()
    lat = [clock.ms(start, d) - k * period * 1e3 for k, d in enumerate(done)]
    gaps: Dict[str, float] = {}
    prev = start
    for a, b, label in spans.order + [(end, end, "window_end")]:
        gaps[label] = gaps.get(label, 0.0) + max(clock.ms(prev, a), 0.0)
        prev = b
    return Window(j, recordings, seconds, clock.ms(start, end), lat, late, host,
                  [clock.ms(a, b) for a, b in spans.track],
                  [clock.ms(a, b) for a, b in spans.background], trajs, systems,
                  gaps if spans.order else {})


def make_system(inp: Inputs, chunk: int, device):
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    return SlamSystem(inp.slam_cfg, vocabulary=inp.voc, chunk=chunk, device=device)


def warm_up(inp: Inputs, chunk: int, device) -> None:
    """One system over the frames that warm up and capture both step programs
    and replay each once (4 frames one at a time; two chunks otherwise)."""
    s = make_system(inp, chunk, device)
    for i in range(4 if chunk == 1 else 2 * chunk):
        s.track(*inp.frame(i))
    s.results()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def percentile(xs: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between closest ranks."""
    s = sorted(xs)
    if not s:
        raise ValueError("no samples")
    k = (len(s) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return s[lo] + (s[hi] - s[lo]) * (k - lo)


def end_to_end(win: Window) -> Dict[str, float]:
    """The window's end-to-end readings (the set-up time apart)."""
    out = {"frames_per_s": win.frames / win.seconds}
    if win.latency_ms:
        out["frame_ms_p50"] = percentile(win.latency_ms, 50)
        out["frame_ms_p95"] = percentile(win.latency_ms, 95)
    return out


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------


def map_arrays(s) -> dict:
    m = s.map
    keys = ("kf_valid", "kf_frame_id", "kf_pose", "kf_uv_und", "kf_octave", "kf_angle", "kf_desc",
            "kf_depth", "kf_kp_valid", "pt_valid", "pt_pos", "pt_obs_kf", "pt_obs_kp")
    return {k: getattr(m, k) for k in keys}


def sample_recording(seed: int, n: int) -> int:
    """The recording whose map the reference checks, drawn from the seed."""
    import numpy as np

    return int(np.random.default_rng(abs(int(seed))).integers(n))


def check_readings(inp: Inputs, cfg: dict, trajectories: list, system,
                   control=None) -> Dict[str, float]:
    """The numbers compared: frames not tracked (or missing) over every
    recording, the worst recording's ATE against the ground truth, and on
    ``system`` (one recording's) the share of its keyframe keypoints that
    disagree with the reference and the median reprojection error of its map's
    observations (level pixels). ``control`` (a torch dtype): the reference in
    that precision stands in for the program's keypoints, and the map is
    rounded to it."""
    import numpy as np
    import torch

    from . import reference

    slam = inp.slam_cfg
    n_levels, scale = int(slam.level_pyramid), float(slam.scale_factor)
    untracked, ates = 0, []
    for traj, ok in trajectories:
        untracked += inp.frames - int(ok.sum())
        ates.append(reference.ate(inp.gt[:len(traj), :3, 3], traj[:, :3, 3]) * 100.0)
    m = map_arrays(system)
    kfs = torch.nonzero(m["kf_valid"]).flatten().tolist()
    counts: Dict[str, int] = {}
    for kf in kfs:
        v = m["kf_kp_valid"][kf]
        k = int(m["kf_frame_id"][kf]) % inp.gray.shape[0]
        got = reference.orb_check(inp.gray[k], inp.depth_m[k], m["kf_uv_und"][kf][v],
                                  m["kf_octave"][kf][v], m["kf_angle"][kf][v], m["kf_desc"][kf][v],
                                  m["kf_depth"][kf][v], n_levels, scale,
                                  float(slam.min_fast_threshold), control)
        for key, n in got.items():
            counts[key] = counts.get(key, 0) + n
    host = {k: v.cpu().numpy() for k, v in m.items() if k.startswith("pt_") or k in
            ("kf_valid", "kf_pose", "kf_uv_und", "kf_octave")}
    p, o = np.nonzero(host["pt_valid"][:, None] & (host["pt_obs_kf"] >= 0))
    kf, kp = host["pt_obs_kf"][p, o], host["pt_obs_kp"][p, o]
    live = host["kf_valid"][kf]
    err = reference.reprojection_px(host["kf_pose"], host["kf_uv_und"], host["kf_octave"],
                                    host["pt_pos"][p[live]], kf[live], kp[live],
                                    slam.camera_fx, slam.camera_fy, slam.camera_cx,
                                    slam.camera_cy, scale,
                                    np.float32 if control is None else control)
    return dict(untracked=float(untracked), ate_cm=max(ates),
                orb_bad_pct=100.0 * counts.get("bad", 0) / max(counts.get("keypoints", 0), 1),
                reproj_px_p50=float(np.median(err)) if err.size else float("inf"),
                keyframes_checked=float(len(kfs)),
                keypoints_checked=float(counts.get("keypoints", 0)),
                observations_checked=float(err.size),
                **{f"kp_{k}": float(v) for k, v in counts.items() if k not in ("keypoints",)})


COMPARED = ("untracked", "ate_cm", "orb_bad_pct", "reproj_px_p50")


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": readings[k], "limit": limits[k]} for k in COMPARED}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi: no card listed"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: unavailable ({e.__class__.__name__})"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def recordings_for(seconds: float, inp: Inputs) -> int:
    """Whole recordings covering ``seconds`` of camera time."""
    return max(1, math.ceil(seconds * inp.fps / inp.frames - 1e-9))


def log(msg: str) -> None:
    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    manifest = load_manifest()
    cell = cell_spec(manifest, args.workload)
    cfg = read_json("configs", cell["config"])
    traffic = read_json("traffic", cell["traffic"])
    readers = {m["name"]: load_reader(m["name"]) for m in cell["per_layer"]} if args.trace else {}

    import torch

    t_torch = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"FATAL: the cell needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    t_cuda = time.perf_counter() - T_START
    from vo_slam_test_tpu_torch.ops import _build

    t_port = time.perf_counter() - T_START
    log(f"{card_line()}; after start: torch imported {t_torch:.3f} s, CUDA found {t_cuda:.3f} s, "
        f"port imported {t_port:.3f} s, card queried {time.perf_counter() - T_START:.3f} s")
    _build.build()
    log(f"kernels built or found {time.perf_counter() - T_START:.3f} s after start")
    out = measure(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"), readers)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


def measure(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
            device, readers: Dict[str, Callable]) -> Optional[dict]:
    """Set-up, the window and the check of one run on ``device`` -> the result
    line (None, with the reason on standard error, when the process holds a
    forbidden module once the window has closed)."""
    import torch

    from vo_slam_test_tpu_torch.utils import graphs

    cuda = device.type == "cuda"
    inp = make_inputs(cfg, seed, device)
    Clock(device).sync()
    log(f"inputs staged {time.perf_counter() - T_START:.3f} s after start "
        f"({inp.gray.shape[0]} distinct frames, recording {inp.frames} frames)")
    n_rec = recordings_for(seconds, inp)
    kernels = launches = eager_before = None
    with (graphs.counting() if trace else contextlib.nullcontext()):
        warm_up(inp, traffic["chunk"], device)
        log(f"programs warmed up and captured {time.perf_counter() - T_START:.3f} s after start")
        if trace and cuda:
            from . import kernels as kmod

            kernels = kmod.record_instances(inp, traffic["chunk"], device)
            eager_before = kmod.wrapper_counts()
        # the set-up's garbage is collected in the set-up: a full collection
        # of it inside the window took 270-294 ms on the card's host
        gc.collect()
        Clock(device).sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START
        log(f"setup_s {setup_s:.3f}; window: {n_rec} recording(s) of {inp.frames} frames, "
            f"traffic {cell['traffic']} {traffic}")
        win = run_window(inp, traffic, n_rec, device, trace, make_system)
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if kernels is not None:
            launches = kmod.window_launches(win.systems, eager_before)
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"FATAL: the process holds forbidden modules {bad}")
        return None
    e2e = end_to_end(win)
    if win.latency_ms:
        lat = win.latency_ms
        p50 = percentile(lat, 50)
        log(f"latency ms p90 {percentile(lat, 90):.4f}, p99 {percentile(lat, 99):.4f}, max "
            f"{max(lat):.4f}; frames over twice the median at "
            f"{[k for k, x in enumerate(lat) if x > 2 * p50][:40]}")
    if win.late_ms:
        log(f"sender lateness ms: median {percentile(win.late_ms, 50):.4f}, p95 "
            f"{percentile(win.late_ms, 95):.4f}, max {max(win.late_ms):.4f}; latency ms medians "
            f"by recording {[round(percentile(win.latency_ms[r * inp.frames:(r + 1) * inp.frames], 50), 4) for r in range(win.recordings)]}")
    log(f"window {win.seconds:.4f} s host, {win.device_ms:.4f} ms device, {win.frames} frames, "
        f"readings {e2e}")
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else device.type, "count": 1,
                   "memory_peak_bytes": int(memory_peak)}
    line = {}
    if trace:
        tr = TraceData(win, launches, kernels)
        metrics = {}
        for m in cell["per_layer"]:
            v = readers[m["name"]](tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy_ms = sum(win.track_ms) + sum(win.background_ms)
        device_info.update(busy_s=busy_ms / 1e3, window_s=win.device_ms / 1e3)
        line["breakdown"] = breakdown(win, kernels, launches)
        if kernels:
            log(f"kernels timed alone {kernels}; launches in the window {launches}")
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    # the reference runs on the sampled recording's system alone
    keep = sample_recording(seed, len(win.systems))
    system, trajectories = win.systems[keep], win.trajectories
    win.systems = []
    t0 = time.perf_counter()
    readings = check_readings(inp, cfg, trajectories, system)
    checks = judge(readings, cfg["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log(f"reference check {time.perf_counter() - t0:.3f} s on recording {keep}: {readings}")
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": correct, "attempted": win.frames, "failed": int(readings["untracked"]),
           "metrics": metrics, "device": device_info}
    out.update(line)
    out["checks"] = checks
    return out


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads: the window (``Window``), the launches
    of each hand kernel in it counted on the device (name -> count) and the
    kernels' timed instances (name -> dict with ``ms`` and ``bound_ms``)."""

    window: Window
    launches: Optional[Dict[str, int]]
    kernels: Optional[Dict[str, dict]]


def breakdown(win: Window, kernels, launches) -> dict:
    """The programs by their replay events and the hand kernels as timed
    alone, and the longest idle stretches by what the host was doing."""
    ops = [["tracking_program", sum(win.track_ms) / 1e3],
           ["background_program", sum(win.background_ms) / 1e3]]
    for name, k in (kernels or {}).items():
        n = (launches or {}).get(name, 0)
        if n:
            ops.append([f"kernel:{name}", n * k["ms"] / 1e3])
    ops.sort(key=lambda x: -x[1])
    gaps = sorted(([k, v / 1e3] for k, v in win.gaps_ms.items()), key=lambda x: -x[1])
    return {"device_ops": ops[:10], "idle_gaps": gaps[:10]}


if __name__ == "__main__":
    sys.exit(main())
