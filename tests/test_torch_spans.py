"""Spans and counters inside the port's step programs
(``vo_slam_test_tpu_torch/utils/graphs.py``: ``span``, named nodes,
``Tally``, ``Recorder``, the clock) on the CPU, where a program's run is its
select form (the stand-in for a replay) and records its spans on the host's
clock and its nodes along the taken paths:

- outside ``counting()`` a span captures no kernel, records nothing, and
  the program key is the one without spans;
- a toy program's spans and node runs, labels unique and stable across a
  loop's trips;
- a ``SlamSystem`` with a vocabulary through its programs over a window of
  ``slambench.run``: every stage of both programs with its runs, the
  scans' ``carry`` spans, node runs by label, the host spans per frame and ``trace()``; each of the
  benchmark's span readers returns a number on that window;
- the owner hand-over of spans and node counters on a StepGraph given its
  counters by hand (the card's split between systems sharing a program);
- the clock's conversion, and the profiler ranges that ``bench.py`` reads.

The card's side (stamps, coverage, node counts, the calibration): the
``spans`` tests of tests/test_torch_graphs_gpu.py."""

import numpy as np
import pytest
import torch

from slambench import run as bench_run
from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
from vo_slam_test_tpu_torch.ops import _build
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.run_slam import trace_report
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.utils import graphs

torch.set_num_threads(1)

W, H, FRAMES = 160, 120, 2
TRACKING_STAGES = ("extract", "bow", "attempts", "local_map", "keyframe")
MAPPING_STAGES = ("cull_points", "triangulate", "fuse", "local_ba", "cull_keyframes")
LOOP_STAGES = ("loop_detect", "loop_close")
READERS = [f"stage_{s}_ms.{m}" for m in ("live", "offline") for s in TRACKING_STAGES] + [
    f"{n}.{m}" for n in ("tracking_graph_ms", "background_graph_ms", "graph_nodes_per_frame")
    for m in ("live", "offline")] + ["replay_start_ms.live", "pre_launch_host_ms.live"]


@pytest.fixture(autouse=True)
def empty_table():
    graphs.clear_programs()
    yield
    graphs.clear_programs()


# ---------------------------------------------------------------------------
# outside counting()
# ---------------------------------------------------------------------------


def test_a_span_outside_counting_captures_and_records_nothing(monkeypatch):
    def no_kernels():
        raise AssertionError("a kernel wrapper was asked for")

    monkeypatch.setattr(graphs, "_graph_kernels", no_kernels)
    calls = {k: k.launches for k in _build.Kernel.ALL}
    rec, tally = graphs.Recorder(), graphs.Tally()
    cap = graphs._Capture(torch.device("cpu"))
    for sink in (rec, tally):
        with graphs._recording(sink):  # even with a sink named
            with graphs.span("extract"):
                pass
            graphs._CAPTURING[0] = cap
            try:
                with graphs.span("extract"):
                    pass
            finally:
                graphs._CAPTURING[0] = None
    with rec.span("track", 0):
        pass
    assert graphs.span("extract") is graphs._NULL and graphs.recording(rec) is graphs._NULL
    assert rec.records == [] and tally.spans == {} and tally.node_runs == {}
    assert cap.span_slots == {} and cap.top == 0
    assert {k: k.launches for k in _build.Kernel.ALL} == calls


def test_the_program_key_is_the_one_without_spans():
    """The key is the Program's own plus whether counting is on, nothing of
    the spans: off and on give two programs whose keys differ in that flag."""
    owner = type("Owner", (), {})()
    p = graphs.Program("toy", ("statics",), lambda inp, st: (st, None), "cpu", owner, ())
    off = p.step()
    with graphs.counting():
        on = p.step()
    keys = {sg: k for k, sg in graphs.programs()}
    assert off is not on
    assert keys[off] == p.key + (False,) and keys[on] == p.key + (True,)
    assert p.key == (torch.device("cpu"), "toy", "statics")


# ---------------------------------------------------------------------------
# a toy program
# ---------------------------------------------------------------------------


def _toy(inputs, state):
    """Three trips; in each: a span, a named cond on the trip's parity, an
    unnamed cond, and a named loop of two trips."""
    def body(i, c, _):
        with graphs.span("stage"):
            c = graphs.cond(i % 2 == 1, lambda: c + 1, lambda: c, name="odd")
            c = graphs.cond(c > 100, lambda: c * 0, lambda: c)
            c = graphs.while_capped(lambda x: x[1] < 2, lambda x: (x[0] + 10, x[1] + 1),
                                    (c, torch.zeros((), dtype=torch.int64)), 5, name="inner")[0]
        return c, None

    c, _ = graphs.scan(body, state, length=3, name="trips")
    return c, c.clone()


def test_a_toy_program_reports_its_spans_and_node_runs():
    owner = type("Owner", (), {})()
    p = graphs.Program("toy", (), _toy, "cpu", owner, ())
    with graphs.counting():
        for _ in range(2):
            state, out = p.run((), torch.zeros((), dtype=torch.int64))
    assert int(out) == 61  # one odd trip, six inner trips
    spans = p.spans()
    assert set(spans) == {"program", "stage"}
    assert spans["program"][1] == 2 and spans["stage"][1] == 6
    assert spans["program"][0] >= spans["stage"][0] > 0
    assert p.node_runs() == {"trips": 6, "odd": 2, "odd.else": 4, "stage#1": 0,
                             "stage#1.else": 6, "inner": 12}
    assert p.graph_nodes_run() == 0  # no graph on the CPU
    assert [r[:2] for r in p.replay_log] == [(None, None)] * 2


def test_a_toy_program_outside_counting_records_nothing():
    owner = type("Owner", (), {})()
    p = graphs.Program("toy", (), _toy, "cpu", owner, ())
    p.run((), torch.zeros((), dtype=torch.int64))
    assert p.spans() == {} and p.node_runs() == {} and p.replay_log == []


# ---------------------------------------------------------------------------
# a SlamSystem through its programs, in a window of slambench.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def window():
    """One recording of FRAMES frames at 160x120 through a vocabulary
    SlamSystem's programs (select mode), inside ``counting()``, driven by
    the benchmark's ``run_window`` with tracing on."""
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 / 4, fy=516.5 / 4, cx=318.6 / 4,
                        cy=255.3 / 4, n_frames=12, seed=31, motion_scale=0.3)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H, level_pyramid=2, num_of_features=200)
    frames = [seq[i] for i in range(FRAMES)]
    gray = torch.stack([torch.as_tensor(g) for g, _, _ in frames])
    depth = torch.stack([torch.as_tensor(d) for _, d, _ in frames])
    voc = V.synth_vocabulary(k=4, levels=3, seed=0, device="cpu")
    inp = bench_run.Inputs(gray, depth, depth, np.stack([seq.poses[i] for i in range(FRAMES)]),
                           FRAMES, 30.0, SlamConfig(**kw), voc)

    def make(inp, chunk, device):
        return SlamSystem(inp.slam_cfg, caps=MapCaps(max_kf=8, max_pt=512), device=device,
                          vocabulary=inp.voc, chunk=chunk, graphs=True)

    graphs.clear_programs()
    with graphs.counting():
        win = bench_run.run_window(inp, {"mode": "offline", "chunk": 1}, 1,
                                   torch.device("cpu"), True, make)
    s = win.systems[0]
    return win, s, s.trace()


def test_every_stage_of_both_programs_runs_as_often_as_its_node(window):
    _, s, tr = window
    tracked = FRAMES - 1  # the first frame runs outside the programs
    stages, runs = tr["stages"], tr["node_runs"]
    assert runs["tracking"]["frames"] == tracked and runs["background"]["events"] == FRAMES
    for name in TRACKING_STAGES + ("program",):
        assert stages["tracking"][name][1] == tracked and stages["tracking"][name][0] > 0, name
    events = runs["background"]["mapping"]  # keyframe events: frame 0's, and any later
    assert events == len(s.ba_iters) >= 1
    for name in MAPPING_STAGES:
        assert stages["background"][name][1] == events, name
    for name in LOOP_STAGES + ("program",):
        assert stages["background"][name][1] == FRAMES, name
    # the paths the reference takes, by name: motion tracking from frame 1 on
    assert runs["tracking"]["motion"] + runs["tracking"]["motion.else"] == tracked
    assert runs["tracking"]["kf_insert"] + runs["tracking"]["kf_insert.else"] == tracked
    assert runs["background"]["close"] == 0 and runs["background"]["close.else"] == FRAMES
    assert runs["background"]["local_ba_lm"] >= events


def test_the_stages_fit_inside_their_program(window):
    _, _, tr = window
    for prog, names in (("tracking", TRACKING_STAGES),
                        ("background", MAPPING_STAGES + LOOP_STAGES)):
        got = tr["stages"][prog]
        assert sum(got[n][0] for n in names) <= got["program"][0], prog


def test_the_carry_span_runs_each_trip_beside_the_stages(window):
    """Both programs' scans name their own copying ``carry``: on the CPU one
    span a trip (a tracked frame, a background event), beside the stages
    inside the program."""
    _, _, tr = window
    for prog, names, trips in (("tracking", TRACKING_STAGES, FRAMES - 1),
                               ("background", MAPPING_STAGES + LOOP_STAGES, FRAMES)):
        got = tr["stages"][prog]
        assert got["carry"][1] == trips and got["carry"][0] > 0, prog
        assert sum(got[n][0] for n in names + ("carry",)) <= got["program"][0], prog


def test_node_labels_are_unique_and_named_where_asked(window):
    _, s, tr = window
    for prog in ("tracking", "background"):
        labels = list(tr["node_runs"][prog])
        assert len(labels) == len(set(labels)) and all(labels), prog
    assert {"retry_r30", "ref_kf", "reloc", "kf_insert", "pose_round"} <= set(
        tr["node_runs"]["tracking"])
    assert {"mapping", "local_ba_lm", "local_ba_lm#2", "detect", "close"} <= set(
        tr["node_runs"]["background"])
    # an unnamed node: its innermost span and its ordinal there
    assert any(k.startswith("attempts#") for k in tr["node_runs"]["tracking"])


def test_host_spans_carry_their_frames_and_join_the_replays(window):
    _, s, tr = window
    spans = tr["spans"]
    tracks = [sp for sp in spans if sp["name"] == "track"]
    assert [sp["frame"] for sp in tracks] == list(range(FRAMES))
    assert all(sp["parent"] == -1 and sp["end_ns"] >= sp["start_ns"] for sp in tracks)
    names = {sp["name"] for sp in spans}
    assert {"stage", "first_frame", "track_replay", "outputs", "background",
            "background_replay", "settle", "results", "launch", "tracking_graph",
            "background_graph"} <= names
    graphs_ = [sp for sp in spans if sp["name"] == "tracking_graph"]
    assert len(graphs_) == FRAMES - 1
    for g in graphs_:
        launch = spans[g["parent"]]
        replay = spans[launch["parent"]]
        track = spans[replay["parent"]]
        assert (launch["name"], replay["name"], track["name"]) == (
            "launch", "track_replay", "track")
        assert g["frame"] == launch["frame"] == replay["frame"] == track["frame"]
        assert track["start_ns"] <= launch["start_ns"] <= g["start_ns"] <= g["end_ns"]
    assert len([sp for sp in spans if sp["name"] == "background_graph"]) == FRAMES
    assert tr["clock"] is None and tr["graph_nodes"] == {"tracking": 0, "background": 0}


@pytest.mark.parametrize("name", READERS)
def test_each_span_reader_reads_the_window(window, name):
    win, _, _ = window
    got = bench_run.load_reader(name)(bench_run.TraceData(win, None, None))
    assert isinstance(got, float) and got >= 0.0, got


def test_the_operator_report_names_every_stage(window):
    _, _, tr = window
    text = "\n".join(trace_report(tr, FRAMES))
    for name in TRACKING_STAGES + MAPPING_STAGES + LOOP_STAGES + ("track", "mapping"):
        assert name in text, name


# ---------------------------------------------------------------------------
# the owner hand-over of spans and node counters
# ---------------------------------------------------------------------------


class Owner:
    def __init__(self, state):
        self.state = state


def test_spans_and_nodes_are_settled_per_owner():
    """A StepGraph given its counters by hand (no graph on the CPU): two
    nodes (bodies of 3 and 5 graph nodes) in slots 0-1, a span ``stage`` in
    slots 7 (ns) and 6 (runs) and ``program`` in 5 and 4; each replay adds
    what its stamps and counter kernels would. Each owner's totals are its
    own replays', and both add up to the StepGraph's."""
    a, b = Owner(torch.zeros(2)), Owner(torch.ones(2))
    pa = graphs.Program("case", (), None, "cpu", a, ("state",))
    pb = graphs.Program("case", (), None, "cpu", b, ("state",))
    sg = graphs.StepGraph(lambda inp, st: (st, None), "cpu", "case")
    _, sg._in_spec = graphs.flatten(())
    st_leaves, sg._state_spec = graphs.flatten(a.state)
    sg._in, sg._state = [], [x.clone() for x in st_leaves]
    sg._node_calls, sg._top_calls = [{}, {}], {}
    sg._labels, sg._body_n, sg.n_top = ["mapping", "mapping.else"], [3, 5], 10
    sg._span_slots = {"stage": (7, 6), "program": (5, 4)}
    sg._counts = torch.zeros(8, dtype=torch.int64)
    sg._mark = torch.zeros(8, dtype=torch.int64)

    def replay(owner, prog, node_runs, stage_ns, program_ns):
        sg._load((), owner.state, prog)
        add = torch.zeros(8, dtype=torch.int64)
        add[:2] = torch.tensor(node_runs)
        add[7], add[6], add[5], add[4] = stage_ns, 1, program_ns, 1
        sg._counts += add
        sg.replays += 1
        sg._owner_replays[prog] = sg._owner_replays.get(prog, 0) + 1

    replay(a, pa, [1, 0], 100, 150)
    replay(b, pb, [0, 1], 200, 260)
    replay(a, pa, [1, 0], 110, 170)
    got_a, got_b, whole = sg.counters(pa), sg.counters(pb), sg.counters()
    assert got_a["spans"] == {"stage": (210, 2), "program": (320, 2)}
    assert got_b["spans"] == {"stage": (200, 1), "program": (260, 1)}
    assert whole["spans"] == {"stage": (410, 3), "program": (580, 3)}
    assert got_a["node_runs"] == {"mapping": 2, "mapping.else": 0}
    assert got_b["node_runs"] == {"mapping": 0, "mapping.else": 1}
    assert (got_a["graph_nodes"], got_b["graph_nodes"], whole["graph_nodes"]) == (
        2 * 10 + 2 * 3, 10 + 5, 3 * 10 + 2 * 3 + 5)


# ---------------------------------------------------------------------------
# the clock, and the profiler ranges
# ---------------------------------------------------------------------------


def test_the_card_clock_maps_back_onto_the_host_clock(monkeypatch):
    """Two calibration points 1 s apart whose offsets differ by 20 us: a
    card stamp at either point lands on its host time, one between them in
    proportion."""
    dev = torch.device("cuda", 0)
    h0, h1 = 5_000_000_000, 6_000_000_000
    off0, off1 = 123_456_789, 123_476_789
    monkeypatch.setattr(graphs, "_CLOCK", {dev: [(h0, h0 + off0, 4000.0),
                                                 (h1, h1 + off1, 6000.0)]})
    c = graphs.clock(dev)
    assert c["offset_ns"] == off0 and c["error_ns"] == 6000.0 and c["points"] == 2
    assert c["drift"] == pytest.approx(20_000 / 1e9)
    for h, off in ((h0, off0), (h1, off1), ((h0 + h1) // 2, (off0 + off1) // 2)):
        assert graphs.to_host(dev, h + off) == pytest.approx(h, abs=1e-3)
    assert graphs.clock("cpu") is None and graphs.to_host("cpu", 42) == 42


def test_spans_open_the_profiler_ranges_bench_reads():
    """``bench.py`` sums the kernels inside the ``background``,
    ``close_step`` and ``global_bundle`` ranges: with a profiler recording,
    a host span and a step's span open them, counting on or off."""
    from torch.profiler import ProfilerActivity, profile

    from vo_slam_test_tpu_torch.bench import BG_RANGES

    rec = graphs.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for on in (False, True):
            with (graphs.counting() if on else graphs._NULL), graphs._recording(rec):
                with rec.span("background", 0):
                    torch.ones(3).sum()
                with graphs.span("close_step"):
                    torch.ones(3).sum()
                with rec.span("global_bundle"):
                    torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    for name in BG_RANGES:
        assert names.count(name) == 2, name
    assert [r[1] for r in rec.records] == ["background", "close_step", "global_bundle"]
