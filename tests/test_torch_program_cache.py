"""The process's step programs (``vo_slam_test_tpu_torch/utils/graphs.py``'s
table, the counterpart of ``jax.jit``'s cache) on the CPU, where a program
runs its select form under ``no_host_reads``, the stand-in for a replay:

- which systems share a program: those that agree on every key field
  (intrinsics and vocabulary values are traced inputs), and no two that
  differ in one (``caps``, ``chunk``, ``reloc_parity``, a vocabulary or none,
  ``inline_close``, ``counting``);
- two ``FusedTracker``s with different intrinsics, interleaved frame by
  frame through one program, each bit-equal to its own eager run, and one
  of them equal to the JAX ``FusedTracker``'s per-frame counts;
- two vocabulary ``SlamSystem``s with different vocabularies of one shape
  and different intrinsics, interleaved through one pair of programs over
  the first two frames of the 320x240 kidnap scene (two keyframe events),
  each bit-equal to its own eager run: a program that read a value of the
  system that built it would fail here;
- ``clear_programs()`` leaving no program referenced;
- the residency hand-over (``StepGraph._load`` with owners) on a StepGraph
  given static buffers by hand: the resident's state cloned out, an
  unchanged input not copied again, each owner's node executions.

The JAX tracker runs once per file (a module fixture)."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch_slam_helpers import P_CAPS, kidnap_small

from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.utils import graphs

W, H = 320, 240
TRACK_FRAMES = 8
SLAM_FRAMES = 2  # frames 0 and 1 of the kidnap each make a keyframe


@pytest.fixture(autouse=True)
def empty_table():
    graphs.clear_programs()
    yield
    graphs.clear_programs()


def other_intrinsics(kw: dict) -> dict:
    return dict(kw, camera_fx=kw["camera_fx"] * 1.01, camera_fy=kw["camera_fy"] * 0.995,
                camera_cx=kw["camera_cx"] + 1.5, camera_cy=kw["camera_cy"] - 1.0)


@pytest.fixture(scope="module")
def kidnap():
    k = kidnap_small()
    vocs = [V.build_vocabulary(k["descs"], k=8, levels=3, seed=s, device="cpu") for s in (2, 5)]
    return dict(k, vocs=vocs, kws=[k["kw"], other_intrinsics(k["kw"])])


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

# (name, SlamSystem keywords or "counting", tracking program shared, background shared)
KEY_CASES = [
    ("same configuration", {}, True, True),
    ("caps", dict(caps=MapCaps(max_kf=16, max_pt=2048)), False, False),
    ("chunk", dict(chunk=2), False, False),
    ("reloc_parity", dict(reloc_parity=True), False, True),
    ("no vocabulary", dict(vocabulary=None), False, False),
    ("inline_close", "diag", True, False),
    ("counting", "counting", False, False),
]


@pytest.mark.parametrize("name,change,track_shared,bg_shared", KEY_CASES,
                         ids=[c[0] for c in KEY_CASES])
def test_programs_are_shared_by_key(kidnap, monkeypatch, name, change, track_shared, bg_shared):
    """The first system has the first vocabulary and intrinsics; the second
    the other ones of the same shapes, and the one change named."""
    def make(i, **kw):
        args = dict(caps=P_CAPS, device="cpu", vocabulary=kidnap["vocs"][i], graphs=True)
        args.update(kw)
        return SlamSystem(SlamConfig(**kidnap["kws"][i]), **args)

    a = make(0)
    pa = (a.track_graph.step(), a.background_graph.step())
    if change == "diag":
        monkeypatch.setenv("VO_LOOP_DIAG", "1")
        b = make(1)
        pb = (b.track_graph.step(), b.background_graph.step())
    elif change == "counting":
        b = make(1)
        with graphs.counting():
            pb = (b.track_graph.step(), b.background_graph.step())
    else:
        b = make(1, **change)
        pb = (b.track_graph.step(), b.background_graph.step())
    assert (pa[0] is pb[0], pa[1] is pb[1]) == (track_shared, bg_shared)
    assert len(graphs.programs()) == 4 - track_shared - bg_shared
    assert b.track_graph.hits == int(track_shared)
    assert b.background_graph.hits == int(bg_shared)


# ---------------------------------------------------------------------------
# FusedTracker
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trackers():
    """The JAX FusedTracker's per-frame counts, and the port's two trackers
    (other intrinsics for the second) interleaved through one program, and
    each alone eagerly."""
    from vo_slam_test_tpu.config import SlamConfig as JConfig
    from vo_slam_test_tpu.datasets import SyntheticRGBD as JSyntheticRGBD
    from vo_slam_test_tpu.pipeline.tracking import FusedTracker as JFusedTracker

    def seq_kw(cls):
        return cls(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                   cy=255.3 * 0.5, n_frames=TRACK_FRAMES, seed=11, motion_scale=0.5)

    jseq = seq_kw(JSyntheticRGBD)
    kw = dict(camera_fx=jseq.fx, camera_fy=jseq.fy, camera_cx=jseq.cx, camera_cy=jseq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)
    frames = [jseq[i] for i in range(TRACK_FRAMES)]
    jt = JFusedTracker(JConfig(**kw))
    for f in frames:
        jt.track(*f)
    j_stats = jt.results()[1]
    kws = [kw, other_intrinsics(kw)]

    graphs.clear_programs()
    shared = [FusedTracker(SlamConfig(**k), device="cpu", graphs=True) for k in kws]
    for f in frames:
        for t in shared:
            t.track(*f)
    programs = [t.step_graph.step() for t in shared]
    alone = []
    for k in kws:
        t = FusedTracker(SlamConfig(**k), device="cpu", graphs=False)
        for f in frames:
            t.track(*f)
        alone.append(t)
    graphs.clear_programs()
    return dict(j_stats=j_stats, shared=shared, alone=alone, programs=programs)


def test_fused_trackers_share_one_program(trackers):
    a, b = trackers["programs"]
    assert a is b and a.hits == 1
    assert [t.step_graph.replays for t in trackers["shared"]] == [0, 0]  # no replay on the CPU


@pytest.mark.parametrize("which", [0, 1])
def test_interleaved_fused_tracker_equals_its_own_run(trackers, which):
    got, want = trackers["shared"][which], trackers["alone"][which]
    rg, rw = got.results(), want.results()
    assert np.array_equal(rg[0], rw[0]) and rg[1] == rw[1]
    for x, y in zip(got._outs, want._outs):
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f.name


def test_shared_fused_tracker_matches_jax_counts(trackers):
    stats = trackers["shared"][0].results()[1]
    assert len(stats) == TRACK_FRAMES and all(s.ok for s in stats)
    for i, (a, b) in enumerate(zip(trackers["j_stats"], stats)):
        assert (b.n_features, b.n_matches, b.n_inliers, b.ok) == \
            (a.n_features, a.n_matches, a.n_inliers, a.ok), i
    # the other tracker's intrinsics give other poses
    assert not np.array_equal(trackers["shared"][1].results()[0],
                              trackers["shared"][0].results()[0])


# ---------------------------------------------------------------------------
# SlamSystem with a vocabulary
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slam_pair(kidnap):
    """Two vocabulary systems through one pair of programs, interleaved
    chunk by chunk (``chunk=1``), and each alone eagerly."""
    def make(i, on):
        return SlamSystem(SlamConfig(**kidnap["kws"][i]), caps=P_CAPS, device="cpu",
                          vocabulary=kidnap["vocs"][i], graphs=on)

    frames = kidnap["frames"][:SLAM_FRAMES]
    graphs.clear_programs()
    shared = [make(0, True), make(1, True)]
    for f in frames:
        for s in shared:
            s.track(*f)
    programs = [(s.track_graph.step(), s.background_graph.step()) for s in shared]
    alone = []
    for i in range(2):
        s = make(i, False)
        for f in frames:
            s.track(*f)
        alone.append(s)
    graphs.clear_programs()
    return dict(shared=shared, alone=alone, programs=programs)


def test_vocabulary_systems_share_their_programs(slam_pair):
    (ta, ba), (tb, bb) = slam_pair["programs"]
    assert ta is tb and ba is bb and ta is not ba
    assert (ta.hits, ba.hits) == (1, 1)
    a, b = slam_pair["shared"]
    assert a.voc is not b.voc and not torch.equal(a.camera.fx, b.camera.fx)


@pytest.mark.parametrize("which", [0, 1])
def test_interleaved_vocabulary_system_equals_its_own_run(slam_pair, which):
    a, b = slam_pair["alone"][which], slam_pair["shared"][which]
    ra, rb = a.results(), b.results()
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]
    assert [o.made_kf for o in a._outs] == [o.made_kf for o in b._outs] == [True] * SLAM_FRAMES
    assert [o.reloc_winner for o in a._outs] == [o.reloc_winner for o in b._outs]
    assert a.ba_iters == b.ba_iters and len(a.ba_iters) == SLAM_FRAMES
    assert (a.loop_closures, a.loop_attempts) == (b.loop_closures, b.loop_attempts)
    for x, y in zip(a._outs, b._outs):
        for f in dataclasses.fields(x):
            if f.name not in ("made_kf", "reloc_winner"):
                assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f.name
    for tree in ("map", "loop_state", "state"):
        la, lb = graphs.flatten(getattr(a, tree))[0], graphs.flatten(getattr(b, tree))[0]
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb)), tree


def test_the_two_vocabulary_systems_differ(slam_pair):
    """The comparison above has teeth: the two systems' own runs differ."""
    a, b = slam_pair["alone"]
    assert not np.array_equal(a.results()[0], b.results()[0])


# ---------------------------------------------------------------------------
# clear_programs
# ---------------------------------------------------------------------------


def test_clear_programs_leaves_no_program_referenced():
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=TRACK_FRAMES, seed=11, motion_scale=0.5)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)
    trackers = [FusedTracker(SlamConfig(**kw), device="cpu", graphs=True) for _ in range(2)]
    for i in range(3):
        for t in trackers:
            t.track(*seq[i])
    refs = [weakref.ref(sg) for _, sg in graphs.programs()]
    assert len(refs) == 1 and trackers[1].step_graph.hits == 1
    graphs.clear_programs()
    gc.collect()
    assert graphs.programs() == [] and all(r() is None for r in refs)
    # a tracker runs on: its next frame builds the program again
    trackers[0].track(*seq[3])
    assert len(graphs.programs()) == 1 and refs[0]() is None


# ---------------------------------------------------------------------------
# the residency hand-over
# ---------------------------------------------------------------------------


class Owner:
    def __init__(self, state, other=None):
        self.state = state
        self.other = other


def _captured(inputs, state, n_nodes=0):
    """A StepGraph on the CPU given static buffers as ``_capture`` makes
    them (no graph: ``_load`` alone is exercised), resident: none."""
    sg = graphs.StepGraph(lambda inp, st: (st, None), "cpu", "case")
    in_leaves, sg._in_spec = graphs.flatten(inputs)
    st_leaves, sg._state_spec = graphs.flatten(state)
    sg._in = [x.clone() for x in in_leaves]
    sg._state = [x.clone() for x in st_leaves]
    if n_nodes:
        sg._node_calls = [{"k": 1}] * n_nodes
        sg._top_calls = {"top": 1}
        sg._counts = torch.zeros(8, dtype=torch.int64)
        sg._mark = torch.zeros(8, dtype=torch.int64)
    return sg


def _state(v: float):
    return {"T": torch.full((4, 4), v), "n": torch.full((), int(v), dtype=torch.int32)}


def test_hand_over_clones_the_resident_state_out():
    consts, own = torch.arange(3.0), torch.zeros(2)
    a, b = Owner(_state(1.0), own), Owner(_state(2.0))
    pa = graphs.Program("case", (), None, "cpu", a, ("state", "other"))
    pb = graphs.Program("case", (), None, "cpu", b, ("state", "other"))
    sg = _captured((consts,), a.state)
    sg._load((consts,), a.state, pa)
    a.state = graphs.unflatten(sg._state_spec, sg._state)  # what a replay returns
    a_leaves = graphs.flatten(a.state)[0]
    sg._load((consts,), b.state, pb)
    # b's state now fills the static buffers; a holds clones of its own
    assert sg._resident_owner() is pb
    assert all(x is not y for x, y in zip(graphs.flatten(a.state)[0], sg._state))
    assert all(x is not y for x, y in zip(graphs.flatten(a.state)[0], a_leaves))
    assert torch.equal(a.state["T"], torch.full((4, 4), 1.0)) and int(a.state["n"]) == 1
    assert torch.equal(sg._state[0], torch.full((4, 4), 2.0))
    # a tensor of a's that was never a static buffer stays as it is
    assert a.other is own


def test_unchanged_inputs_of_the_resident_are_not_copied_again():
    consts, frame = torch.arange(3.0), torch.zeros(2)
    o = Owner(_state(1.0))
    po = graphs.Program("case", (), None, "cpu", o, ("state",))
    sg = _captured((consts, frame), o.state)
    sg._load((consts, frame), o.state, po)
    sg._in[0].fill_(-1.0)  # a copy would restore it
    frame.add_(1.0)        # an in-place change: copied
    sg._load((consts, frame), o.state, po)
    assert torch.equal(sg._in[0], torch.full((3,), -1.0))
    assert torch.equal(sg._in[1], torch.ones(2))
    # another owner, then this one again: everything is copied
    other = Owner(_state(3.0))
    sg._load((consts, frame), other.state, graphs.Program("case", (), None, "cpu", other,
                                                          ("state",)))
    sg._in[0].fill_(-1.0)
    sg._load((consts, frame), o.state, po)
    assert torch.equal(sg._in[0], consts)


def test_a_caller_with_other_shapes_or_statics_raises():
    o = Owner(_state(1.0))
    po = graphs.Program("case", (), None, "cpu", o, ("state",))
    sg = _captured((torch.arange(3.0),), o.state)
    with pytest.raises(ValueError, match="input leaf 0"):
        sg._load((torch.arange(4.0),), o.state, po)
    with pytest.raises(ValueError, match="structure"):
        sg._load((torch.arange(3.0), torch.zeros(1)), o.state, po)
    with pytest.raises(ValueError, match="static"):
        sg._load((torch.arange(3.0),), dict(o.state, tag="x"), po)


def test_node_executions_are_settled_per_owner():
    a, b = Owner(_state(1.0)), Owner(_state(2.0))
    pa = graphs.Program("case", (), None, "cpu", a, ("state",))
    pb = graphs.Program("case", (), None, "cpu", b, ("state",))
    sg = _captured((), a.state, n_nodes=2)

    def replay(owner, prog, runs):
        sg._load((), owner.state, prog)
        sg._counts[:2] += torch.tensor(runs)  # what the replay's counter kernels add
        sg.replays += 1
        sg._owner_replays[prog] = sg._owner_replays.get(prog, 0) + 1

    replay(a, pa, [1, 3])
    replay(b, pb, [2, 0])
    replay(a, pa, [1, 1])
    assert sg.launches(pa) == {"top": 2, "k": 6}
    assert sg.launches(pb) == {"top": 1, "k": 2}
    assert sg.launches() == {"top": 3, "k": 8}
