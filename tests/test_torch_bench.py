"""The port's benchmark driver (``vo_slam_test_tpu_torch/bench.py``) and the
frames it stages on the device, on the CPU:

- ``SlamSystem.track`` takes gray and depth tensors already on its device and
  passes them through untouched (f32 meters; u16 raw is scaled), with the
  states of numpy inputs; a tensor on another device raises;
- the scenarios are bench.py's: the kfdense config field for field, its
  trajectory and frames, corner40's u16 depths;
- the bench configuration (scene vocabulary, ``chunk=8``, loop closing on) at
  320x240 over the first 24 frames of the room orbit against the JAX
  package's SlamSystem, frame by frame;
- the timed protocol and the background sum at small size with
  ``device="cpu"``, and the entry point's refusals (no card, a failed trace).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD as JSyntheticRGBD
from vo_slam_test_tpu.datasets.synthetic import room_orbit_trajectory as j_room_orbit
from vo_slam_test_tpu_torch import bench, convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import staging
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from torch_slam_helpers import (FLOAT_TOL, P_CAPS, JSlamSystem, per_frame_rows, room_kw,
                                room_sequence)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 24
CHUNK = 8
KEYS = ("ok", "relocalized", "n_features", "n_matches", "n_inliers", "made_kf")


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The 320x240 room orbit's first 24 frames (the JAX renderer's), its
    config keys and the bench's scene vocabulary at small size (k=8, L=3:
    ``staging.scene_vocabulary`` on every 4th frame), trained once."""
    seq = room_sequence()
    frames = [seq[i] for i in range(N_FRAMES)]
    kw = room_kw(seq)
    old, staging.CACHE_DIR = staging.CACHE_DIR, str(tmp_path_factory.mktemp("stage"))
    try:
        voc = staging.scene_vocabulary(SlamConfig(**kw), [f[0] for f in frames],
                                       [f[1] for f in frames], "bench_room", k=8, levels=3,
                                       device="cpu")
    finally:
        staging.CACHE_DIR = old
    return dict(seq=seq, frames=frames, kw=kw, voc=voc)


# ---------------------------------------------------------------------------
# (a) frames staged on the device pass through track
# ---------------------------------------------------------------------------


def _run(kw, frames, chunk=2):
    s = SlamSystem(SlamConfig(**kw), caps=P_CAPS, device="cpu", chunk=chunk)
    bufs = []
    for f in frames:
        s.track(*f)
        bufs.append(list(s._chunk_buf))
    s.results()
    return s, bufs


@pytest.mark.parametrize("raw_depth", [False, True])
def test_track_takes_prestaged_tensors(room, raw_depth):
    kw = room["kw"]
    frames = room["frames"][:3]
    if raw_depth:
        frames = [(g, (d * 5000.0).astype(np.uint16), t) for g, d, t in frames]
    staged = [(torch.from_numpy(g.copy()), torch.from_numpy(d.copy()), t) for g, d, t in frames]
    ref, _ = _run(kw, frames)
    got, bufs = _run(kw, staged)
    # the buffered chunk holds the caller's tensors; u16 depth is scaled to meters
    g0, d0, _ = bufs[0][0]
    assert g0 is staged[0][0]
    if raw_depth:
        assert d0.dtype == torch.float32
        torch.testing.assert_close(d0, staged[0][1].to(torch.float32) / 5000.0, rtol=0, atol=0)
    else:
        assert d0 is staged[0][1]
    for i, (p, q) in enumerate(zip(per_frame_rows(got._outs), per_frame_rows(ref._outs))):
        assert tuple(p[k] for k in KEYS) == tuple(q[k] for k in KEYS), i
        np.testing.assert_array_equal(p["T"], q["T"])
    for f in ref.map.__dataclass_fields__:
        assert torch.equal(getattr(got.map, f), getattr(ref.map, f)), f


def test_track_refuses_a_tensor_on_another_device(room):
    g, d, t = room["frames"][0]
    s = SlamSystem(SlamConfig(**room["kw"]), caps=P_CAPS, device="cpu")
    with pytest.raises(ValueError, match="frame tensor"):
        s.track(torch.empty(g.shape, dtype=torch.uint8, device="meta"), d, t)
    with pytest.raises(ValueError, match="frame tensor"):
        s.track(g, torch.empty(d.shape, dtype=torch.float32, device="meta"), t)
    assert not s._outs


# ---------------------------------------------------------------------------
# (b) the scenarios are bench.py's
# ---------------------------------------------------------------------------


def _jax_pinhole(seq, **kw):
    return JConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                   camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0, **kw)


def test_kfdense_is_bench_py_configuration():
    seq, cfg = bench.kfdense_sequence()
    # bench.py:123-132, through the JAX package
    traj = j_room_orbit(240, loops=1.5)
    jseq = JSyntheticRGBD(trajectory=traj, scene="room", seed=7)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_jax_pinhole(jseq, camera_fps=30))
    np.testing.assert_array_equal(seq.poses, traj)
    for i in (0, 120):
        for a, b in zip(seq[i], jseq[i]):
            np.testing.assert_array_equal(a, b)


def test_corner40_is_bench_py_configuration():
    seq, cfg = bench.corner40_sequence()
    jseq = JSyntheticRGBD(n_frames=40, seed=0, motion_scale=0.4)
    jcfg = _jax_pinhole(jseq)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    frames = bench.corner40_frames(seq, cfg)
    assert len(frames) == 40
    for i in (0, 20, 39):
        g, d, t = jseq[i]
        np.testing.assert_array_equal(frames[i][0], g)
        assert frames[i][1].dtype == np.uint16
        np.testing.assert_array_equal(frames[i][1], (d * jcfg.camera_depthScale).astype(np.uint16))
        assert frames[i][2] == t


def test_build_scenario_stages_bench_py_inputs(tmp_path, monkeypatch):
    """The builder's scenarios: kfdense (cut to 4 frames here) with f32 depth,
    the scene vocabulary at k=10, L=6, chunk 8 and bench.py's gates;
    corner40 with u16 depth, synth_vocabulary(k=10, levels=6) and a 3-frame
    warm pass."""
    monkeypatch.setattr(staging, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "KFDENSE_FRAMES", 4)
    sc = bench.build_scenario("kfdense", "cpu")
    seq, _ = bench.kfdense_sequence()
    assert (sc.chunk, sc.min_kf_ever, sc.max_ate_m, sc.warm_frames) == (8, 25, 0.35, None)
    assert (sc.voc.k, sc.voc.levels) == (10, 6) and len(sc.frames) == 4
    for i, (g, d, t) in enumerate(sc.frames):
        assert d.dtype == np.float32
        for a, b in zip((g, d, t), seq[i]):
            np.testing.assert_array_equal(a, b)
    assert len(list(tmp_path.glob("pilot_voc_orbit1.5_4_10_6_*.npz"))) == 1
    c40 = bench.build_scenario("corner40", "cpu", chunk=4)
    assert (c40.chunk, c40.min_kf_ever, c40.warm_frames, c40.voc.k, c40.voc.levels) == (
        4, None, 3, 10, 6)
    assert all(d.dtype == np.uint16 for _, d, _ in c40.frames)
    with pytest.raises(ValueError, match="BENCH_SCENARIO"):
        bench.build_scenario("corner41", "cpu")


# ---------------------------------------------------------------------------
# (c) the bench configuration at 320x240 against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bench_run(room, tmp_path_factory):
    """The JAX SlamSystem with the same vocabulary (read from the port's
    .npz), chunk=8, loop closing on (its default with a vocabulary); its
    state and map before each later chunk, as numpy."""
    path = str(tmp_path_factory.mktemp("voc") / "voc.npz")
    room["voc"].save(path)
    js = JSlamSystem(JConfig(**room["kw"]), vocabulary=JVocabulary.load(path), chunk=CHUNK)
    pre = {}
    for i, f in enumerate(room["frames"]):
        if i and i % CHUNK == 0:
            pre[i] = tuple(convert.dataclass_to_numpy(jax.device_get(x))
                           for x in (js.state, js.map))
        js.track(*f)
    js.results()
    return dict(rows=per_frame_rows(js._per_frame(jax.device_get(js._outs))), pre=pre,
                closures=list(js.loop_closures), attempts=list(js.loop_attempts),
                n_kf_ever=int(np.asarray(js.map.n_kf_ever)),
                ba_iters=[tuple(int(v) for v in x) for x in js.ba_iters])


def test_bench_configuration_matches_jax(room, jax_bench_run):
    """The free run: per frame ok, the feature count and the keyframe
    decision equal, and ``n_kf_ever``, the keyframe events and the loop
    closing equal; the first chunk's match and inlier counts, its poses
    (within FLOAT_TOL) and its events' LM iterations equal. Later chunks
    track against a map that local BA rounded in another order (its LM
    decisions are rounding-sensitive, ROADMAP queue 3: frame 18's inliers
    part by one, frame 23's second LM pass takes 10 iterations against 3),
    so their counts and poses are held from JAX's state in the next test."""
    ps = SlamSystem(SlamConfig(**room["kw"]), device="cpu", chunk=CHUNK, vocabulary=room["voc"])
    assert ps.enable_loop_closing
    for f in room["frames"]:
        ps.track(*f)
    ps.results()
    j = jax_bench_run
    p_rows = per_frame_rows(ps._outs)
    assert len(p_rows) == len(j["rows"]) == N_FRAMES
    assert ([i for i, r in enumerate(p_rows) if r["made_kf"]]
            == [i for i, r in enumerate(j["rows"]) if r["made_kf"]])
    for i, (p, q) in enumerate(zip(p_rows, j["rows"])):
        keys = KEYS if i < CHUNK else ("ok", "relocalized", "n_features", "made_kf")
        assert tuple(p[k] for k in keys) == tuple(q[k] for k in keys), (i, p, q)
        if i < CHUNK:
            np.testing.assert_allclose(p["T"], q["T"], err_msg=f"frame {i}", **FLOAT_TOL)
    assert int(ps.map.n_kf_ever) == j["n_kf_ever"]
    assert [x[0] for x in ps.ba_iters] == [x[0] for x in j["ba_iters"]]
    first = [tuple(x) for x in ps.ba_iters if x[0] < CHUNK]
    assert first and first == [x for x in j["ba_iters"] if x[0] < CHUNK]
    assert ps.loop_closures == j["closures"] and ps.loop_attempts == j["attempts"]


@pytest.mark.parametrize("c0", [CHUNK, 2 * CHUNK])
def test_bench_configuration_chunk_from_jax_state(room, jax_bench_run, c0):
    """Each later chunk from the JAX system's state and map before it: per
    frame the counts and the keyframe decision equal, poses within
    FLOAT_TOL."""
    j = jax_bench_run
    ps = SlamSystem(SlamConfig(**room["kw"]), device="cpu", chunk=CHUNK, vocabulary=room["voc"])
    state, m = j["pre"][c0]
    ps.state = convert.slam_track_state_from_numpy(state, "cpu")
    ps.map = convert.map_state_from_numpy(m, "cpu")
    for f in room["frames"][c0:c0 + CHUNK]:
        ps.track(*f)
    assert not ps._chunk_buf
    for i, (p, q) in enumerate(zip(per_frame_rows(ps._outs), j["rows"][c0:c0 + CHUNK])):
        assert tuple(p[k] for k in KEYS) == tuple(q[k] for k in KEYS), (c0 + i, p, q)
        np.testing.assert_allclose(p["T"], q["T"], err_msg=f"frame {c0 + i}", **FLOAT_TOL)


# ---------------------------------------------------------------------------
# (d) the timed protocol, the background sum and the entry point
# ---------------------------------------------------------------------------


def small_scenario(room, n=5):
    """kfdense's shape at 320x240: one chunk of 4 and one frame for the flush."""
    seq = room["seq"]
    return bench.Scenario("kfdense", SlamConfig(**room["kw"]), room["frames"][:n], room["voc"],
                          seq.poses[:n], chunk=4, min_kf_ever=2, max_ate_m=0.35)


def test_measure_reports_bench_py_line(room, capsys):
    res = bench.measure(small_scenario(room), torch.device("cpu"), reps=1)
    line = res["line"]
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert (line["metric"], line["unit"]) == ("tracking_ms_per_frame", "ms")
    assert line["value"] > 0 and line["vs_baseline"] == round(bench.BASELINE_MS / line["value"], 3)
    c = res["components"]
    for k in ("wall_ms_per_frame", "device_busy_ms", "background_device_ms",
              "background_host_wall_ms", "kernels_per_frame", "host_syncs_per_chunk"):
        assert k in c
    # on the CPU no device activity: the metric is the wall per frame
    assert c["background_device_ms"] == 0.0 and c["kernels_per_frame"] == 0
    assert line["value"] == round(c["wall_ms_per_frame"], 3)
    assert 0 < c["background_host_wall_ms"] < c["traced_wall_ms"]
    d = res["diag"]
    assert d["tracked"] == d["frames"] == 5 and d["n_kf_ever"] >= 2
    for k in ("closures", "attempts", "ate_m", "ba_iters_total", "ba_iters_mean", "ba_iters_max",
              "n_ba_interrupts"):
        assert k in d
    err = capsys.readouterr().err
    assert "[bench] kfdense: KFs ever" in err and "ba_interrupts" in err
    bench.report(res, "card line")
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1].startswith('{"metric": "tracking_ms_per_frame"')
    assert err.strip().splitlines()[-1] == "card line"
    for k in ("wall best", "device busy", "background device", "background host wall",
              "kernels per frame", "host syncs per chunk"):
        assert k in err


def test_background_device_ms_counts_launches_inside_ranges():
    ms = 1_000_000
    # nested ranges (a close inside a background step) count once
    ranges = [(100, 200), (120, 150), (300, 400)]
    acts = [(110, 5 * ms), (130, 7 * ms), (250, 11 * ms), (300, 13 * ms), (400, 17 * ms),
            (401, 19 * ms), (None, 23 * ms), (50, 29 * ms)]
    got = bench.background_device_ms(ranges, acts)
    assert got["bg_ms"] == 5 + 7 + 13 + 17
    assert got["device_ms"] == sum(ns for _, ns in acts) / ms
    assert got["n_device"] == 8 and got["unplaced"] == 1
    assert got["bg_host_ms"] == (100 + 100) / ms


class _Event:
    """A kineto event as ``trace_rows`` reads it."""

    def __init__(self, name, kind, device, corr, linked, start, dur):
        from torch.autograd import DeviceType

        self._v = dict(name=name, activity_type=kind, correlation_id=corr,
                       linked_correlation_id=linked, start_ns=start, end_ns=start + dur,
                       duration_ns=dur, is_user_annotation=kind.endswith("user_annotation"),
                       device_type=DeviceType.CUDA if device else DeviceType.CPU)

    def __getattr__(self, k):
        return lambda: self._v[k]


def test_trace_rows_places_each_launch():
    """Launch times: a kernel's runtime call (linked to an op, or unlinked,
    as a launch from outside any op), else the host op or annotation the
    kernel is linked to; the annotations' device spans are not activities."""
    import types

    events = [
        _Event("background", "user_annotation", False, 1, 0, 100, 100),
        _Event("aten::add", "cpu_op", False, 2, 0, 110, 20),
        _Event("cudaLaunchKernel", "cuda_runtime", False, 900, 2, 120, 3),
        _Event("add_kernel", "kernel", True, 900, 2, 500, 5),
        _Event("cudaLaunchKernel", "cuda_runtime", False, 901, 0, 300, 3),
        _Event("fast_score", "kernel", True, 901, 0, 600, 7),
        _Event("ba_cost", "kernel", True, 902, 1, 700, 11),
        _Event("background", "gpu_user_annotation", True, 1, 1, 500, 300),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    ranges, acts = bench.trace_rows(prof)
    assert ranges == [(100, 200)]
    assert acts == [(120, 5), (300, 7), (100, 11)]
    got = bench.background_device_ms(ranges, acts)
    assert (got["bg_ms"], got["n_device"], got["unplaced"]) == (16 / 1e6, 3, 0)


def test_bench_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "vo_slam_test_tpu_torch.bench"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "metric" not in out.stdout


def test_bench_fails_on_a_failed_trace(room, monkeypatch, capsys):
    sc = small_scenario(room)
    monkeypatch.setattr(bench, "build_scenario", lambda name, device, chunk: sc)
    monkeypatch.setattr(bench, "run", lambda *a, **k: (1.0, {}))

    def no_trace(*a, **k):
        raise RuntimeError("the trace recorded no device activity")

    monkeypatch.setattr(bench, "traced_run", no_trace)
    assert bench.main(device="cpu") != 0
    out, err = capsys.readouterr()
    assert "metric" not in out and "FATAL" in err
