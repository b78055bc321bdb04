"""The window's arithmetic with a stand-in system whose frames take known
times on a virtual clock: latency from the due time, its median and 95th
percentile over every frame, the rate over all frames and all the time, and a
stall that moves both."""

import numpy as np
import pytest
import torch

from slambench import run


class _Clock:
    """Virtual seconds: ``sleep`` and the stand-in's frames advance them."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.t += max(d, 1e-6)


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(run, "time", c)
    return c


class _Prog:
    def run(self, inputs, state):  # replaced by the harness's timer
        return None


class _Stats:
    ok = True


class _System:
    """Frames take ``service[i]`` seconds of host time each."""

    def __init__(self, service):
        self.service = service
        self.track_graph, self.background_graph = _Prog(), _Prog()
        self.n = 0

    def track(self, gray, depth, ts):
        run.time.t += self.service[self.n]
        self.track_graph.run(None, None)
        self.background_graph.run(None, None)
        self.n += 1

    def results(self):
        return np.tile(np.eye(4), (self.n, 1, 1)), [_Stats()] * self.n, []


class _Inputs:
    def __init__(self, frames):
        self.frames, self.fps = frames, 50.0

    def frame(self, i):
        return None, None, i / self.fps


def _window(mode, service, recordings=1, trace=False):
    traffic = {"mode": mode, "rate_hz": 50.0, "chunk": 1}
    inp = _Inputs(len(service))
    return run.run_window(inp, traffic, recordings, torch.device("cpu"), trace,
                          lambda i, c, d: _System(service))


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))
    assert run.percentile(xs, 50) == pytest.approx(50.5)
    assert run.percentile(xs, 95) == pytest.approx(95.05)
    assert run.percentile([3.0], 95) == 3.0


def test_live_latency_counts_from_the_due_time():
    service = [0.002] * 40
    w = _window("live", service)
    assert len(w.latency_ms) == 40
    lat = np.array(w.latency_ms)
    # each frame is sent at its due time (20 ms apart) and takes 2 ms
    assert lat == pytest.approx(2.0, abs=0.01)
    assert max(w.late_ms) < 0.01


def test_a_stall_moves_the_tail_and_the_rate():
    base = [0.002] * 60
    stall = list(base)
    stall[20] = 0.200  # 10 frame periods
    a, b = _window("live", base), _window("live", stall)
    ea, eb = run.end_to_end(a), run.end_to_end(b)
    # the frames due while frame 20 runs are sent late, and their latency
    # counts the wait: frame 20 takes 200 ms, frame 21 (due 20 ms later)
    # ends 182 ms after its due time, ..., frame 30 20 ms, frame 31 on time
    lat = np.array(b.latency_ms)
    assert lat[20] == pytest.approx(200.0, abs=0.05)
    assert lat[21:30] == pytest.approx(202.0 - 20.0 * np.arange(1, 10) + 2.0 * np.arange(0, 9),
                                       abs=0.05)
    assert lat[31:] == pytest.approx(2.0, abs=0.05)
    assert eb["frame_ms_p95"] > ea["frame_ms_p95"] + 100
    assert eb["frame_ms_p50"] == pytest.approx(2.0, abs=0.05)
    oa, ob = _window("offline", base), _window("offline", stall)
    ra, rb = run.end_to_end(oa)["frames_per_s"], run.end_to_end(ob)["frames_per_s"]
    assert ra == pytest.approx(60 / oa.seconds)
    assert rb < ra * 0.7


def test_offline_rate_covers_every_recording():
    w = _window("offline", [0.001] * 10, recordings=3)
    assert w.frames == 30 and w.recordings == 3 and len(w.trajectories) == 3
    assert run.end_to_end(w)["frames_per_s"] == pytest.approx(30 / w.seconds)
    assert w.seconds >= 0.03


def test_recordings_cover_the_seconds_of_camera_time():
    inp = _Inputs(240)
    inp.fps = 30.0
    assert run.recordings_for(24, inp) == 3
    assert run.recordings_for(8, inp) == 1
    assert run.recordings_for(8.1, inp) == 2
    inp.frames = 900
    assert run.recordings_for(24, inp) == 1


def test_traced_spans_and_idle_gaps():
    w = _window("live", [0.002] * 20, recordings=2, trace=True)
    assert len(w.track_ms) == len(w.background_ms) == 40
    # the stand-in's replays take no time: the window is idle between them,
    # nearly all of it waiting for the camera's next frame
    assert set(w.gaps_ms) == {"new_system", "waiting_for_the_camera", "between_programs",
                              "window_end"}
    assert sum(w.gaps_ms.values()) == pytest.approx(w.device_ms, rel=0.02)
    assert w.gaps_ms["waiting_for_the_camera"] > 0.6 * w.device_ms
    b = run.breakdown(w, None, None)
    assert b["device_ops"][0][0] in ("tracking_program", "background_program")
    assert b["idle_gaps"][0][0] == "waiting_for_the_camera"
