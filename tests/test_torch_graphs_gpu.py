"""The port's step programs as captured CUDA graphs with conditional nodes
(``vo_slam_test_tpu_torch/utils/graphs.py``) against the eager runs, on the
card: each module whose host reads became ``cond``/``while_capped``, then
``FusedTracker`` and ``SlamSystem(vocabulary=None)`` per frame and in chunks,
bit for bit and with no host sync across ``track``; the replays' launches
counted on the device (``graphs.counting``) against eager's; dropped systems
releasing their graphs' memory; the vocabulary path: a captured
relocalization attempt, and ``SlamSystem(vocabulary=...)`` over the kidnap
(chip_smoke.py's main path 4), bit for bit with no host sync inside a
tracking replay; WHILE nodes (``graphs.scan``, ``while_capped``): a toy loop
for 0, 1 and all trips, nested in IF and WHILE bodies, counted launches per
trip, a node count that does not grow with the trip cap, and the chunk
programs of ``SlamSystem(chunk=4)`` with a vocabulary; the process's
program table: two systems with different vocabularies interleaved through
one program pair (the residency hand-over), each equal to its eager run; a
cache hit capturing nothing; ``clear_programs()`` returning the reserved
memory; the three fixed-trip loops (undistortion, EPnP's Gauss-Newton, the
fast pose round) each one WHILE node, replayed bit-equal to eager; the mesh
solvers' step programs on 8 shards of the card, replayed bit-equal to the
eager mesh calls, local BA's rows 7-9 counted on the device. Each test
starts from an empty table.

Run on a machine with a CUDA card (no JAX needed there):

    python -m pytest tests/test_torch_graphs_gpu.py -m gpu --noconftest -q

Without a card every test skips (decided in a fixture, never at import).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker
from vo_slam_test_tpu_torch.slam_map import insert, triangulate
from vo_slam_test_tpu_torch.solvers import local_ba, pose_only
from vo_slam_test_tpu_torch.utils import graphs

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def empty_table():
    graphs.clear_programs()
    yield
    graphs.clear_programs()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(seq):
    return SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                      camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)


@pytest.fixture(scope="module")
def room(cuda):
    seq = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    frames = [(torch.as_tensor(g).to(cuda), torch.as_tensor(d).to(cuda), t)
              for g, d, t in (seq[i] for i in range(12))]
    return _cfg(seq), frames


@pytest.fixture(scope="module")
def room_map(room):
    """The eager system after the room orbit's first 6 frames (keyframe
    events 0, 1 and 5)."""
    cfg, frames = room
    s = SlamSystem(cfg, graphs=False)
    for f in frames[:6]:
        s.track(*f)
    s.results()
    return s


def leaf_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Integer and bool tensors equal; floats equal with NaN in the same
    places."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if not x.is_floating_point():
        return torch.equal(x, y)
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(torch.where(nx, 0.0, x), torch.where(ny, 0.0, y))


def bit_equal(a, b) -> bool:
    la, lb = graphs.flatten(a)[0], graphs.flatten(b)[0]
    return len(la) == len(lb) and all(leaf_equal(x, y) for x, y in zip(la, lb))


def replay_matches_eager(fn, calls):
    """``fn(*args)`` for each args of ``calls``, eagerly and as a StepGraph
    (warm-up, capture, replays), the outputs bit-equal; the graph replayed."""
    sg = graphs.StepGraph(lambda inp, st: (st, fn(*inp)), "cuda", "case")
    dummy = torch.zeros(1, device="cuda")
    for i, args in enumerate(calls):
        want = fn(*args)
        _, got = sg.run(tuple(args), dummy)
        torch.cuda.synchronize()
        assert bit_equal(got, want), f"call {i}"
    assert sg.replays == len(calls) - 1


def test_pose_only_lm_replays(cuda):
    """Module 3: the LM loop of ``solve_pose_only(fast=False)``."""
    rng = np.random.default_rng(11)
    calls = []
    for k in range(4):
        n = 120
        p = rng.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)
        uv = (p[:, :2] / p[:, 2:] * 500 + 320 + rng.normal(0, 0.7 + k, (n, 2))).astype(np.float32)
        obs = pose_only.PoseObs(
            p_world=torch.as_tensor(p, device=cuda), uv=torch.as_tensor(uv, device=cuda),
            u_right=torch.full((n,), -1.0, device=cuda), inv_sigma2=torch.ones(n, device=cuda),
            valid=torch.as_tensor(rng.random(n) < 0.9, device=cuda))
        T0 = torch.eye(4, device=cuda)
        T0[:3, 3] = torch.as_tensor(rng.normal(0, 0.05, 3).astype(np.float32), device=cuda)
        calls.append((T0, obs))
    replay_matches_eager(
        lambda T0, obs: pose_only.solve_pose_only(T0, obs, 500.0, 500.0, 320.0, 320.0, 40.0),
        calls)


def test_insert_keyframe_replays(room_map):
    """Module 5: the predicated insert at a device slot, with the timestamp
    and frame id as device inputs, taken and not taken."""
    s = room_map
    feats = s.state.feats
    assign = s.state.assign_real
    create = insert.spawn_mask_depth_sorted(feats, assign >= 0, s.camera.th_depth)

    def step(do, ts, fid):
        return insert.insert_keyframe(s.map, s.caps, feats, torch.eye(4, device="cuda"), ts, fid,
                                      assign, create, s.camera, s.scale_factors, do=do)

    def dev(v, dt):
        return torch.full((), v, dtype=dt, device="cuda")

    calls = [(dev(b, torch.bool), dev(0.5 + i, torch.float32), dev(40 + i, torch.int32))
             for i, b in enumerate((True, True, False, True, False))]
    # eager, the flag is read back and the timestamp and frame id are host
    # values; in the graph all three are device inputs
    sg = graphs.StepGraph(lambda inp, st: (st, step(*inp)), "cuda", "insert")
    dummy = torch.zeros(1, device="cuda")
    for i, (do, ts, fid) in enumerate(calls):
        want_m, want_kf = insert.insert_keyframe(
            s.map, s.caps, feats, torch.eye(4, device="cuda"), float(ts), int(fid), assign,
            create, s.camera, s.scale_factors, do=do)
        _, (got_m, got_kf) = sg.run((do, ts, fid), dummy)
        assert int(got_kf) == want_kf, i
        assert bit_equal(got_m, want_m), i


def test_triangulation_replays(room_map):
    """Module 7: the neighbour slots as one WHILE node, each slot's search
    under a cond inside it, the f64 null vector; keyframes 1 and 2 (slot ids
    as device inputs)."""
    s = room_map
    m = s.map

    def tri(kf):
        return triangulate.create_new_map_points(m, kf, s.caps, s.camera, s.scale_factors)

    calls = [(torch.tensor(k, dtype=torch.int32, device="cuda"),) for k in (2, 1, 2)]
    sg = graphs.StepGraph(lambda inp, st: (st, tri(*inp)), "cuda", "triangulate")
    dummy = torch.zeros(1, device="cuda")
    for i, (kf,) in enumerate(calls):
        want = tri(int(kf))
        _, got = sg.run((kf,), dummy)
        assert bit_equal(got, want), i
    assert sg.n_while == 1 and sg.replays == len(calls) - 1


def test_mapping_loops_replay_in_a_while_body(room_map):
    """Triangulation's neighbour loop (WHILE > IF per slot, row 6 inside)
    and keyframe culling's reparenting (WHILE > WHILE) nested as the
    background program nests them, inside a WHILE body over keyframe ids:
    each replay bit-equal to the eager chain, and row 6's launches counted
    on the device equal to the eager calls' (the wrapper's count)."""
    from vo_slam_test_tpu_torch.ops import match_cuda
    from vo_slam_test_tpu_torch.slam_map import culling

    s = room_map

    def chain(m, kf):
        m = triangulate.create_new_map_points(m, kf, s.caps, s.camera, s.scale_factors)
        return culling.cull_keyframes(m, kf, s.caps, s.camera)

    def step(inp, m):
        kfs, = inp
        return graphs.scan(lambda i, m, kf: (chain(m, kf), None), m, kfs)[0], ()

    sg = graphs.StepGraph(step, "cuda", "mapping loops")
    runs = ((2, 1), (1, 2), (2, 2), (1, 1))
    with graphs.counting():
        for i, kfs in enumerate(runs):
            got, _ = sg.run((torch.tensor(kfs, dtype=torch.int32, device="cuda"),), s.map)
            want = s.map
            for kf in kfs:
                want = chain(want, kf)
            assert bit_equal(got, want), i
    replayed = sg.launches().get(match_cuda.KERNEL_EPI, 0)
    before = match_cuda.KERNEL_EPI.launches
    for kfs in runs[1:]:  # the runs the graph replayed (the first is the warm-up)
        want = s.map
        for kf in kfs:
            want = chain(want, kf)
    assert replayed == match_cuda.KERNEL_EPI.launches - before and replayed > 0
    assert sg.n_while == 4 and sg.replays == len(runs) - 1


@pytest.mark.parametrize("caps", ["tests", "default"])
def test_global_ba_program_replays_like_eager(cuda, caps):
    """Global BA's step program (``solvers/global_ba.py::program``: the LM
    loop a WHILE node with the CG loop a WHILE node inside) on
    ``chip_smoke.gba_scene`` at the tests' caps and the default MapCaps:
    warm-up, capture and three replays, each map bit-equal to eager
    ``global_bundle_adjust``'s, no host sync in a replay."""
    import sys
    from pathlib import Path

    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import global_ba

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    mc = MapCaps(16, 2048, 12, 256) if caps == "tests" else MapCaps()
    m, _, cam = chip_smoke.gba_scene(mc, cuda)
    want = global_ba.global_bundle_adjust(m, mc, cam, 0)

    owner = global_ba.MapOwner(m)
    prog = global_ba.program(owner, mc, cam, None)
    fixed = torch.zeros((), dtype=torch.int32, device=cuda)
    for k in range(5):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if k >= 2 else "default")
        try:
            owner.map, _ = prog.run((cam, None, fixed), m)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bit_equal(owner.map, want), k
    assert prog.replays == 4 and prog.n_while == 2
    assert not torch.equal(want.kf_pose, m.kf_pose)


def test_local_ba_replays(room_map):
    """Module 8: the LM passes as while_capped, the interruptBA entry as a
    cond; the LM counts equal the eager loop's."""
    s = room_map
    inv = 1.0 / (s.scale_factors * s.scale_factors)

    def lba(kf, stop):
        return local_ba.local_bundle_adjust_iters(s.map, kf, s.caps, s.camera, inv, stop=stop)

    sg = graphs.StepGraph(lambda inp, st: (st, lba(*inp)), "cuda", "local_ba")
    dummy = torch.zeros(1, device="cuda")
    for i, (kf, stop) in enumerate(((2, False), (1, False), (2, True), (2, False))):
        want_m, w1, w2 = lba(kf, stop)
        _, (got_m, g1, g2) = sg.run((torch.tensor(kf, dtype=torch.int32, device="cuda"),
                                     torch.tensor(stop, device="cuda")), dummy)
        assert (int(g1), int(g2)) == (w1, w2), i
        assert bit_equal(got_m, want_m), i


def test_counted_replays_launch_as_eager(room_map):
    """``StepGraph.launches`` under ``graphs.counting()``: the BA kernels'
    launches by the replays, counted per conditional node on the device,
    equal the same calls' eager launches (the wrappers' counts)."""
    from vo_slam_test_tpu_torch.ops import ba_cuda

    s = room_map
    inv = 1.0 / (s.scale_factors * s.scale_factors)

    def lba(kf, stop):
        return local_ba.local_bundle_adjust_iters(s.map, kf, s.caps, s.camera, inv, stop=stop)

    calls = ((2, False), (1, False), (2, True), (2, False))
    kernels = (ba_cuda.KERNEL_ACC, ba_cuda.KERNEL_COST, ba_cuda.KERNEL_BACKSUB)
    sg = graphs.StepGraph(lambda inp, st: (st, lba(*inp)), "cuda", "local_ba")
    dummy = torch.zeros(1, device="cuda")
    with graphs.counting():
        for kf, stop in calls:
            sg.run((torch.tensor(kf, dtype=torch.int32, device="cuda"),
                    torch.tensor(stop, device="cuda")), dummy)
    got = sg.launches()
    before = [k.launches for k in kernels]
    for kf, stop in calls[1:]:  # the calls the graph replayed (the first is the warm-up)
        lba(kf, stop)
    want = [k.launches - b for k, b in zip(kernels, before)]
    assert sg.replays == len(calls) - 1
    assert [got.get(k, 0) for k in kernels] == want and want[0] > 0


def _track_all(make, frames, error_on_sync: bool):
    s = make()
    for f in frames:
        if error_on_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            s.track(*f)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return s


def test_fused_tracker_graph_equals_eager(cuda):
    """Module 2: FusedTracker over 10 corner frames (main path 1's sequence),
    no host sync in any ``track`` call."""
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    frames = [(torch.as_tensor(g).to(cuda), torch.as_tensor(d).to(cuda), t)
              for g, d, t in (seq[i] for i in range(10))]
    a = _track_all(lambda: FusedTracker(_cfg(seq), graphs=False), frames, False)
    b = _track_all(lambda: FusedTracker(_cfg(seq)), frames, True)
    assert b.graphs and b.step_graph.replays == len(frames) - 2
    ra, rb = a.results(), b.results()
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]


@pytest.mark.parametrize("chunk", [1, 4])
def test_slam_system_graph_equals_eager(room, chunk):
    """Modules 4, 6 and 9 (and 5, 7, 8 inside them): SlamSystem(vocabulary=None)
    over the room orbit's first 12 frames per frame and with chunk=4: every
    map tensor, the poses, keyframes and LM counts equal, no host sync in any
    ``track`` call."""
    cfg, frames = room
    a = _track_all(lambda: SlamSystem(cfg, chunk=chunk, graphs=False), frames, False)
    b = _track_all(lambda: SlamSystem(cfg, chunk=chunk), frames, True)
    # per frame: a replay from frame 2; in chunks: the tracking program is
    # replayed once per chunk (the first chunk's capturing call included)
    assert b.graphs and b.track_graph.replays == (len(frames) - 2 if chunk == 1
                                                  else len(frames) // chunk)
    ta, tb = a.results()[0], b.results()[0]
    assert np.array_equal(ta, tb)
    assert [o.made_kf for o in a._outs] == [o.made_kf for o in b._outs]
    assert a.ba_iters == b.ba_iters and len(a.ba_iters) >= 3
    for f in dataclasses.fields(a.map):
        assert torch.equal(getattr(a.map, f.name), getattr(b.map, f.name)), f.name


def test_dropped_systems_release_their_graph_pools(room):
    """A StepGraph's graph and both private pools (the capture's and the IF
    bodies') are released when it is collected: building and dropping
    systems that captured both programs, and the table's programs with them,
    leaves the reserved memory flat."""
    cfg, frames = room

    def cycle():
        s = SlamSystem(cfg)
        for f in frames[:4]:
            s.track(*f)
        s.results()
        assert s.track_graph.graph is not None and s.background_graph.graph is not None
        del s
        graphs.clear_programs()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    first = cycle()
    later = [cycle() for _ in range(3)]
    assert max(later) <= first, (first, later)


def test_graph_dropped_during_a_capture_is_released_after_it(cuda):
    """A StepGraph collected while another is being captured (the collector
    runs at any allocation) releases its graph after that capture: destroying
    a graph inside a capture would invalidate it."""
    x, dummy = torch.arange(4.0, device=cuda), torch.zeros(1, device=cuda)

    def captured(fn):
        sg = graphs.StepGraph(fn, cuda, "case")
        outs = [sg.run(x, dummy)[1] for _ in range(3)]
        assert sg.replays == 2
        return sg, outs

    holder = [captured(lambda inp, st: (st, inp * 2.0))[0]]

    def drop_then_add(inp, st):
        if graphs.mode() == "capture":
            holder.clear()  # the last reference: its release runs here
        return st, inp + 1.0

    _, outs = captured(drop_then_add)
    assert not holder and all(torch.equal(o, x + 1.0) for o in outs)


@pytest.fixture(scope="module")
def kidnap(cuda):
    """chip_smoke.py's main path 4: the kidnap at 640x480, its vocabulary,
    its frames (and the depth-poor ones) staged on the card."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    seq, cfg = chip_smoke.kidnap_sequence()
    voc = chip_smoke.kidnap_vocabulary(seq, cfg, cuda)

    def staged(fr):
        return [(torch.as_tensor(g).to(cuda), torch.as_tensor(d).to(cuda), t) for g, d, t in fr]

    return cfg, voc, staged(chip_smoke.kidnap_frames(seq, False)), staged(
        chip_smoke.kidnap_frames(seq, True))


def test_relocalization_attempt_replays(kidnap):
    """Module 6's relocalization (``_attempt_reloc``) captured as a StepGraph
    and replayed on the eager system's map after the kidnap's lost frames,
    against the eager attempt, bit for bit: black frame 9 (no candidate),
    return frames 11-13 with depth (Horn) and without (EPnP), in the default
    mode (candidate slots, the solver cond, the winner's cascade) and in
    parity mode (the insertion-order loop, a cascade per candidate)."""
    from vo_slam_test_tpu_torch.bow import retrieval as bow_ret
    from vo_slam_test_tpu_torch.bow import vocabulary as bow_voc
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
    from vo_slam_test_tpu_torch.pipeline import system
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    cfg, voc, frames, poor = kidnap
    s = SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc, graphs=False)
    for f in frames[:11]:
        s.track(*f)
    calls = []
    for i, (g, d, _) in [(9, frames[9]), (11, frames[11]), (12, poor[12]), (13, frames[13])]:
        feats = extract_fused(g, d, s.camera, s.spec, s.budgets, s.fast_hi, s.fast_lo)
        words = bow_voc.transform(s.voc, feats.desc, feats.valid)
        uniq, wgt = bow_ret.bow_vector(words, s.voc.idf)
        bow = (uniq, wgt, bow_voc.feature_groups(s.voc, words))
        calls.append((s.map, feats, bow, torch.full((), i, dtype=torch.int32, device="cuda")))
    for parity in (False, True):
        replay_matches_eager(
            lambda m, feats, bow, fid, parity=parity: system._attempt_reloc(
                m, feats, bow, s.voc, fid, parity, s.camera, s.scale_factors,
                s.inv_level_sigma2), calls)


@pytest.mark.parametrize("parity", [False, True])
def test_vocabulary_system_graph_equals_eager(kidnap, parity):
    """Module 8: SlamSystem(vocabulary=..., graphs=True) over the kidnap:
    every map and loop-state tensor, the poses, keyframes, relocalization
    frames and winners equal eager's; no host sync inside any tracking
    replay, and none after a background replay (the close runs inside it)."""
    import warnings

    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    cfg, voc, frames, _ = kidnap

    def make(on):
        return SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc,
                          reloc_parity=parity, graphs=on)

    a = _track_all(lambda: make(False), frames, False)
    b = make(True)
    replay = b.track_graph.run

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return replay(*args)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
    b.track_graph.run = strict
    reads = []
    for f in frames:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                b.track(*f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        reads.append(sum("synchroniz" in str(w.message) for w in caught))
    assert reads == [0] * len(frames) and b.track_graph.replays == len(frames) - 2
    ra, rb = a.results(), b.results()
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]
    assert a.reloc_frames == b.reloc_frames and a.reloc_frames[0] == 11
    assert [o.reloc_winner for o in a._outs] == [o.reloc_winner for o in b._outs]
    assert [o.made_kf for o in a._outs] == [o.made_kf for o in b._outs]
    for f in dataclasses.fields(a.map):
        assert torch.equal(getattr(a.map, f.name), getattr(b.map, f.name)), f.name
    for f in dataclasses.fields(a.loop_state):
        assert torch.equal(getattr(a.loop_state, f.name), getattr(b.loop_state, f.name)), f.name


def test_loop_chain_background_program_closes_like_eager(cuda, monkeypatch):
    """Module 9: the background step with the loop close inside (the
    candidate scan, the correction with its loop fuse, the essential graph)
    on the drifted chain (tests/torch_loop_chain.py: four keyframe events of
    KF9, the fourth confirms KF0 and closes), captured and replayed against
    eager ``background_step``, bit for bit, with no host sync from the
    capture on; the close runs in a replay. Then SlamSystem's graph path with
    ``enable_global_ba``: one read after each dispatch's replays, and global
    BA after the closure, equal to the eager system."""
    import types
    import warnings

    from torch_loop_chain import CAPS, GROUP_DIV, KW, SCALES, drifted_chain
    from vo_slam_test_tpu_torch.bow import vocabulary as bow_voc
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
    from vo_slam_test_tpu_torch.pipeline import system

    cam = Camera.from_config(SlamConfig(**KW), cuda)
    sf = torch.as_tensor(SCALES, device=cuda)

    def step(ev, carry):
        m, ls, bg = system.background_step(*carry, *ev, CAPS, cam, sf, True, GROUP_DIV)
        return (m, ls), (bg.cands, bg.close)

    sg = graphs.StepGraph(step, cuda, "chain")
    ev = (torch.tensor(True, device=cuda), torch.tensor(9, dtype=torch.int32, device=cuda),
          torch.tensor(True, device=cuda))
    m_e, ls_e = drifted_chain(cuda), LC.empty_loop_state(CAPS, cuda)
    carry = (drifted_chain(cuda), LC.empty_loop_state(CAPS, cuda))
    closed = []
    for r in range(4):
        m_e, ls_e, out_e = system.background_step(m_e, ls_e, True, 9, True, CAPS, cam, sf, True,
                                                  GROUP_DIV)
        torch.cuda.set_sync_debug_mode("error" if r else "default")
        try:
            carry, (cands, close) = sg.run(ev, carry)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out_g = system.BackgroundOut()
        out_g.fold(*graphs.fetch(cands, *close.leaves()))
        assert (out_e.attempted, out_e.closed, out_e.which, out_e.attempts) == \
            (out_g.attempted, out_g.closed, out_g.which, out_g.attempts), r
        assert bit_equal((m_e, ls_e), carry), r
        closed.append(out_g.closed)
    assert closed == [False, False, False, True] and sg.replays == 3
    assert out_g.attempts[0][:2] == (0, True)

    voc = bow_voc.synth_vocabulary(k=10, levels=3, seed=0, device=cuda)
    eager, graph = (SlamSystem(SlamConfig(**KW), caps=CAPS, vocabulary=voc, enable_global_ba=True,
                               graphs=on) for on in (False, True))
    runs = []
    for s in (eager, graph):
        s.map = drifted_chain(cuda)
        gba = s._global_ba

        def counted(gba=gba, s=s):
            runs.append(s)
            gba()  # the graph system's: its program, which reads nothing back
        monkeypatch.setattr(s, "_global_ba", counted)
    reads = []
    made, kid = torch.ones(1, dtype=torch.bool, device=cuda), torch.full(
        (1,), 9, dtype=torch.int32, device=cuda)
    for r in range(4):
        eager.map, eager.loop_state, bg = system.background_step(
            eager.map, eager.loop_state, True, 9, True, CAPS, eager.camera, eager.scale_factors,
            True, GROUP_DIV)
        eager._fold_background([(r, True, bg)])
        graph._outs.append(types.SimpleNamespace(made_kf=None, reloc_winner=None))
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                graph._graph_background_steps(len(graph._outs) - 1, made, kid, made)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        graph._frame_id += 1
        reads.append(sum("synchroniz" in str(w.message) for w in caught))
    assert reads == [1] * 4 and runs == [eager, graph]
    assert graph.loop_closures == eager.loop_closures == [3]
    assert graph.loop_gates == eager.loop_gates and graph.ba_iters == eager.ba_iters
    assert bit_equal((eager.map, eager.loop_state), (graph.map, graph.loop_state))


# ---------------------------------------------------------------------------
# WHILE nodes
# ---------------------------------------------------------------------------


def _dint(v):
    return torch.full((), v, dtype=torch.int64, device="cuda")


def _toy_scan(xs, st, start, n):
    return graphs.scan(lambda i, c, x: (c * 0.5 + x * (i + 1), c + x), st, xs, start=start, n=n)


@pytest.mark.parametrize("length", [5, 32])
def test_while_node_replays_a_toy_loop(cuda, length):
    """A scan over a device trip range is one WHILE node; replays for 0, 1
    and every trip (and a range cut at the end) equal eager, the rows of the
    trips not run zero."""
    xs = torch.linspace(-1.0, 2.0, length, device=cuda)
    sg = graphs.StepGraph(lambda inp, st: _toy_scan(inp[0], st, inp[1], inp[2]), cuda, "toy")
    ranges = [(0, 1), (0, length), (2, 0), (1, 1), (length - 2, 5), (0, length)]
    for k, (start, n) in enumerate(ranges):
        st = torch.full((), 0.25, device=cuda)
        got_c, got_y = sg.run((xs, _dint(start), _dint(n)), st.clone())
        want_c, want_y = _toy_scan(xs, st, start, n)
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c), k
        if want_y is None:  # no trip ran
            assert not got_y.any(), k
        else:
            assert torch.equal(got_y, want_y), k
    assert sg.n_while == 1 and sg.n_if == 0 and sg.replays == len(ranges) - 1


def test_nested_while_if_while_replays(cuda):
    """A WHILE inside an IF inside a WHILE (the background program's chunk >
    keyframe > LM nesting), replayed for both branch values, equals eager."""
    def step(inp, st):
        xs, go = inp

        def inner(c):
            return graphs.while_capped(lambda s: s[0].sum() < 40.0,
                                       lambda s: (s[0] * 1.5 + 1.0, s[1] + 1),
                                       (c, torch.zeros((), dtype=torch.int32, device=cuda)), 6)

        def body(i, c, x):
            grown, trips = graphs.cond(go & (x > 0), lambda: inner(c + x),
                                       lambda: (c - x, torch.zeros((), dtype=torch.int32,
                                                                   device=cuda)))
            return grown, trips

        return graphs.scan(body, st, xs)

    sg = graphs.StepGraph(step, cuda, "nested")
    xs = torch.tensor([1.0, -2.0, 0.5, 3.0], device=cuda)
    for go in (True, False, True, True):
        gd = torch.full((), go, device=cuda)
        st = torch.full((3,), 0.5, device=cuda)
        got = sg.run((xs, gd), st.clone())
        want = step((xs, gd), st)
        torch.cuda.synchronize()
        assert bit_equal(got, want), go
    assert sg.n_while == 2 and sg.replays == 3


def test_counted_launches_are_per_trip(cuda):
    """Under ``graphs.counting()`` a kernel wrapper called once in a WHILE
    body counts once per trip: the eigensolver in a scan over a device range
    of trips."""
    from vo_slam_test_tpu_torch.ops import symeig_cuda

    A = torch.randn(6, 4, 12, 12, device=cuda)
    A = A @ A.mT

    def step(inp, st):
        xs, n = inp
        return graphs.scan(lambda i, c, a: (c + symeig_cuda.symeig(a)[0].sum(), c), st, xs, n=n)

    sg = graphs.StepGraph(step, cuda, "counted")
    with graphs.counting():
        trips = [3, 6, 1, 4]  # the first call is the warm-up
        for n in trips:
            sg.run((A, _dint(n)), torch.zeros((), device=cuda))
    got = sg.launches()
    assert sum(got.values()) == sum(trips[1:]) and sg.replays == len(trips) - 1


def test_while_node_count_does_not_grow_with_the_cap(cuda):
    """The body of a captured ``scan``/``while_capped`` is captured once: the
    graph's node count is the same at two trip caps."""
    def scan_step(length):
        def step(inp, st):
            return graphs.scan(lambda i, c, _: (torch.sin(c) + c * 0.5 + i, None), st,
                               length=length)
        return step

    def while_step(cap):
        def step(inp, st):
            return graphs.while_capped(lambda c: c.sum() < 1e6, lambda c: torch.cos(c) * 2 + c,
                                       st, cap), None
        return step

    for make in (scan_step, while_step):
        sizes = []
        for cap in (3, 40):
            sg = graphs.StepGraph(make(cap), cuda, "cap")
            for _ in range(3):
                sg.run((), torch.ones(4, device=cuda))
            sizes.append((sg.n_nodes, sg.n_while))
        assert sizes[0] == sizes[1] and sizes[0][1] == 1, sizes


def test_vocabulary_chunk_programs_equal_eager(kidnap):
    """SlamSystem(chunk=4) with a vocabulary over the kidnap: the chunk
    programs (tracking and background, the close inside) equal eager's
    chunks bit for bit, with one replay of each per full chunk after the
    first and no host sync in a chunk's dispatch."""
    import warnings

    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    cfg, voc, frames, _ = kidnap

    def make(on):
        return SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc, chunk=4,
                          graphs=on)

    a = _track_all(lambda: make(False), frames, False)
    b = make(True)
    reads = []
    for i, f in enumerate(frames):
        if i == 4:
            replays0 = b.track_graph.replays + b.background_graph.replays
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                b.track(*f)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        reads.append(sum("synchroniz" in str(w.message) for w in caught))
    full = len(frames) // 4
    assert b.track_graph.replays + b.background_graph.replays - replays0 == 2 * (full - 1)
    assert b.track_graph.n_while >= 1 and b.background_graph.n_while >= 1
    assert reads == [0] * len(frames)
    ra, rb = a.results(), b.results()
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]
    assert a.reloc_frames == b.reloc_frames
    assert [o.reloc_winner for o in a._outs] == [o.reloc_winner for o in b._outs]
    assert [o.made_kf for o in a._outs] == [o.made_kf for o in b._outs]
    assert a.ba_iters == b.ba_iters
    for f in dataclasses.fields(a.map):
        assert torch.equal(getattr(a.map, f.name), getattr(b.map, f.name)), f.name
    for f in dataclasses.fields(a.loop_state):
        assert torch.equal(getattr(a.loop_state, f.name), getattr(b.loop_state, f.name)), f.name


# ---------------------------------------------------------------------------
# the process's program table
# ---------------------------------------------------------------------------


def test_interleaved_systems_share_programs_and_equal_eager(kidnap, tmp_path):
    """Two kidnap systems with different vocabularies of one shape,
    interleaved frame by frame through one program pair: each replay for
    the other system first clones this one's state out of the static
    buffers, so each equals its own eager run bit for bit (every map and
    loop-state tensor, poses, keyframes, winners, LM counts), no ``track``
    call synchronizes, each program is warmed up and captured once for both,
    and ``save_map`` of the system that is not resident writes its own
    map."""
    import os
    import sys
    import warnings

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from vo_slam_test_tpu_torch.slam_map import serialize
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    cfg, voc, frames, _ = kidnap
    voc2 = chip_smoke.kidnap_vocabulary(chip_smoke.kidnap_sequence()[0], cfg, "cuda", seed=5)
    caps = MapCaps(max_kf=32, max_pt=8192)

    def make(v, on):
        return SlamSystem(cfg, caps=caps, vocabulary=v, graphs=on)

    eager = [_track_all(lambda v=v: make(v, False), frames, False) for v in (voc, voc2)]
    pair = [make(v, True) for v in (voc, voc2)]
    reads = []
    for f in frames:
        for s in pair:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    s.track(*f)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            reads.append(sum("synchroniz" in str(w.message) for w in caught))
    assert reads == [0] * len(reads)
    a, b = pair
    assert a.track_graph.last is b.track_graph.last
    assert a.background_graph.last is b.background_graph.last
    # one warm-up and one capture of each program in all: the background
    # program's at frame 0 (a warms it up, b captures it), the tracking
    # program's at frame 1
    for p, q in ((a.track_graph, b.track_graph), (a.background_graph, b.background_graph)):
        assert p.warm_s > 0 and p.capture_s == 0 and q.warm_s == 0 and q.capture_s > 0
    assert (a.track_graph.replays, b.track_graph.replays) == (len(frames) - 2, len(frames) - 1)
    # b ran last: a's tensors are its own now
    serialize.save_map(os.fspath(tmp_path / "a.npz"), a.map, caps)
    saved, _ = serialize.load_map(os.fspath(tmp_path / "a.npz"))
    assert bit_equal(saved, eager[0].map)
    for e, g in zip(eager, pair):
        re_, rg = e.results(), g.results()
        assert np.array_equal(re_[0], rg[0]) and re_[1] == rg[1]
        assert [o.made_kf for o in e._outs] == [o.made_kf for o in g._outs]
        assert [o.reloc_winner for o in e._outs] == [o.reloc_winner for o in g._outs]
        assert e.ba_iters == g.ba_iters and e.reloc_frames == g.reloc_frames
        assert bit_equal((e.map, e.loop_state), (g.map, g.loop_state))


def test_a_cache_hit_makes_no_capture(room):
    """A fresh system of a configuration already captured in the process
    replays its programs from its first chunk: no warm-up, no capture, the
    same programs (node counts unchanged), its results equal the first's."""
    cfg, frames = room
    runs = []
    for _ in range(2):
        s = SlamSystem(cfg, chunk=4)
        for f in frames[:8]:
            s.track(*f)
        runs.append((s, s.results()))
    (a, ra), (b, rb) = runs
    ta, ba_ = a.track_graph, a.background_graph
    tb, bb = b.track_graph, b.background_graph
    assert ta.last is tb.last and ba_.last is bb.last and len(graphs.programs()) == 2
    assert ta.capture_s > 0 and ba_.warm_s > 0
    assert tb.warm_s == tb.capture_s == bb.warm_s == bb.capture_s == 0
    assert (tb.n_nodes, bb.n_nodes) == (ta.n_nodes, ba_.n_nodes) and tb.hits == bb.hits == 1
    assert tb.replays + bb.replays == 2 * 2  # one replay of each a chunk
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]
    assert bit_equal(a.map, b.map)


def test_clear_programs_returns_the_reserved_memory(room):
    """The table keeps a dropped system's programs (their pools stay
    reserved); ``clear_programs()`` releases them: after ``empty_cache`` the
    reserved memory is back at its level before the programs."""
    cfg, frames = room

    def run():
        s = SlamSystem(cfg, chunk=4)
        for f in frames[:8]:
            s.track(*f)
        s.results()
        assert s.track_graph.graph is not None and s.background_graph.graph is not None
        del s
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    def cleared():
        graphs.clear_programs()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    run()  # the process's own first-use allocations (library workspaces, streams)
    before = cleared()
    held = run()
    assert held > before and len(graphs.programs()) == 2
    assert cleared() <= before and graphs.programs() == []


def _loop_calls(name, dev):
    """Four seeded argument tuples for one of the three fixed-trip loops, at
    the shapes the step programs give them: 1024 keypoints (undistortion),
    EPnP's 128 minimal samples, 512 observations (the fast pose round)."""
    from vo_slam_test_tpu_torch.camera import Camera

    rng = np.random.default_rng(17)
    calls = []
    for k in range(4):
        if name == "undistort":
            uv = rng.uniform([0, 0], [640, 480], (1024, 2)).astype(np.float32)
            dist = np.array([0.26, -0.95, -0.005, 0.002, 1.16], np.float32) * (1 + 0.1 * k)
            calls.append((torch.as_tensor(uv, device=dev), torch.as_tensor(dist, device=dev)))
        elif name == "epnp":
            X = rng.uniform([-1, -1, 2], [1, 1, 5], (128, 4, 3)).astype(np.float32)
            uv = (X[..., :2] / X[..., 2:] * 500 + [320, 240]
                  + rng.normal(0, 0.5 + k, (128, 4, 2))).astype(np.float32)
            calls.append((torch.as_tensor(X, device=dev), torch.as_tensor(uv, device=dev),
                          Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0,
                                                        camera_p2=0, camera_k3=0), dev)))
        else:
            n = 512
            p = rng.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)
            uv = (p[:, :2] / p[:, 2:] * 500 + 320 + rng.normal(0, 0.5 + k, (n, 2)))
            obs = pose_only.PoseObs(
                p_world=torch.as_tensor(p, device=dev),
                uv=torch.as_tensor(uv.astype(np.float32), device=dev),
                u_right=torch.full((n,), -1.0, device=dev), inv_sigma2=torch.ones(n, device=dev),
                valid=torch.as_tensor(rng.random(n) < 0.9, device=dev))
            T0 = torch.eye(4, device=dev)
            T0[:3, 3] = torch.as_tensor(rng.normal(0, 0.05, 3).astype(np.float32), device=dev)
            calls.append((T0, obs))
    return calls


def _loop_fn(name):
    from vo_slam_test_tpu_torch.ops import undistort
    from vo_slam_test_tpu_torch.solvers import epnp

    if name == "undistort":
        return lambda uv, dist: undistort.undistort_points(uv, 500.0, 500.0, 320.0, 240.0, dist)
    if name == "epnp":
        return lambda X, uv, cam: epnp.epnp_pose(X, uv, torch.ones(X.shape[:2], device=X.device),
                                                 cam)
    return lambda T0, obs: pose_only._solve_round_gn(T0, obs, obs.valid, 500.0, 500.0, 320.0,
                                                     320.0, 40.0, True, 4)


@pytest.mark.parametrize("name", ["undistort", "epnp", "pose_round"])
def test_fixed_trip_loops_are_one_while_node(cuda, name):
    """Undistortion's 10 trips, EPnP's 6 Gauss-Newton trips and the fast pose
    round's 4 trips: each captured alone is one WHILE node (EPnP's
    eigensolver is a kernel, no loop), and every replay equals eager."""
    fn = _loop_fn(name)
    calls = _loop_calls(name, cuda)
    sg = graphs.StepGraph(lambda inp, st: (st, fn(*inp)), "cuda", name)
    dummy = torch.zeros(1, device="cuda")
    for i, args in enumerate(calls):
        want = fn(*args)
        torch.cuda.set_sync_debug_mode("error" if i >= 2 else "default")
        try:
            _, got = sg.run(tuple(args), dummy)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bit_equal(got, want), i
    assert sg.n_while == 1 and sg.n_if == 0 and sg.replays == len(calls) - 1


def test_local_ba_mesh_program_replays_like_eager(room_map):
    """``local_ba.mesh_program`` on 8 shards of the card (the room orbit's
    map; keyframes 2 and 1, ``stop`` raised once): each replay's map and LM
    counts bit-equal to eager ``local_bundle_adjust_mesh_iters``, no host
    sync in a replay, and rows 7-9 launched 8 x (n1 + n2) times a replay,
    counted on the device."""
    from vo_slam_test_tpu_torch import parallel
    from vo_slam_test_tpu_torch.ops import ba_cuda
    from vo_slam_test_tpu_torch.solvers import global_ba

    s = room_map
    inv = 1.0 / (s.scale_factors * s.scale_factors)
    mesh = parallel.make_obs_mesh(8)
    runs = ((2, False), (1, False), (2, True), (2, False))
    owner = global_ba.MapOwner(s.map)
    expect = 0
    with graphs.counting():
        prog = local_ba.mesh_program(owner, s.caps, s.camera, inv, mesh)
        for i, (kf, stop) in enumerate(runs):
            want_m, w1, w2 = local_ba.local_bundle_adjust_mesh_iters(
                s.map, kf, s.caps, s.camera, mesh, inv, stop=stop)
            if i:
                expect += mesh.n_shards * (w1 + w2)
            inputs = (s.camera, inv, torch.tensor(kf, dtype=torch.int32, device="cuda"),
                      torch.tensor(stop, device="cuda"))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if i >= 2 else "default")
            try:
                owner.map, (g1, g2) = prog.run(inputs, s.map)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert (int(g1), int(g2)) == (w1, w2), i
            assert bit_equal(owner.map, want_m), i
    launches = prog.launches()
    assert [launches.get(k, 0) for k in (ba_cuda.KERNEL_ACC, ba_cuda.KERNEL_COST,
                                         ba_cuda.KERNEL_BACKSUB)] == [expect] * 3 and expect > 0
    assert prog.replays == len(runs) - 1


def test_global_ba_mesh_program_replays_like_eager(cuda):
    """``global_ba.program`` with an 8-shard mesh of the card on
    ``chip_smoke.gba_scene`` at the tests' caps: warm-up, capture and three
    replays, each map bit-equal to eager ``global_bundle_adjust_mesh``'s, no
    host sync in a replay, the LM and CG loops two WHILE nodes."""
    import sys
    from pathlib import Path

    from vo_slam_test_tpu_torch import parallel
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.solvers import global_ba

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    mc = MapCaps(16, 2048, 12, 256)
    mesh = parallel.make_obs_mesh(8)
    m, _, cam = chip_smoke.gba_scene(mc, cuda)
    want = global_ba.global_bundle_adjust_mesh(m, mc, cam, 0, mesh)
    owner = global_ba.MapOwner(m)
    prog = global_ba.program(owner, mc, cam, None, mesh)
    fixed = torch.zeros((), dtype=torch.int32, device=cuda)
    for k in range(5):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if k >= 2 else "default")
        try:
            owner.map, _ = prog.run((cam, None, fixed), m)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bit_equal(owner.map, want), k
    assert prog.replays == 4 and prog.n_while == 2 and prog.name == "global_ba_mesh"
    assert not torch.equal(want.kf_pose, m.kf_pose)


# ---------------------------------------------------------------------------
# spans and counters inside the programs
# ---------------------------------------------------------------------------


def test_spans_add_no_node_outside_counting(room, monkeypatch):
    """Outside ``counting()`` the spans capture nothing: both programs of a
    system have the nodes, IF nodes and WHILE nodes of a capture with every
    ``span`` a no-op."""
    import contextlib

    cfg, frames = room

    def sizes():
        graphs.clear_programs()
        s = SlamSystem(cfg, graphs=True)
        for f in frames[:4]:
            s.track(*f)
        s.results()
        return [(p.n_nodes, p.n_if, p.n_while) for p in (s.track_graph, s.background_graph)]

    with_spans = sizes()
    monkeypatch.setattr(graphs, "span", lambda name: contextlib.nullcontext())
    assert sizes() == with_spans and with_spans[0][0] > 0


def test_spans_stamp_the_programs_on_one_clock(kidnap):
    """``SlamSystem(vocabulary=...)`` over the kidnap inside ``counting()``:
    each replay's stamps in order (first before last, after the previous
    replay's last; both programs share one stream), each after its launch
    call on the shared clock; the tracking program's five stages and its
    ``carry`` (the scan's and the capture's own copying) cover 90-100% of
    its ``program`` span, the five run once a tracked frame and ``carry`` at
    least as often; the calibration's error bound under 50 us; ``%globaltimer``
    advances."""
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    cfg, voc, frames, _ = kidnap
    with graphs.counting():
        s = SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc, graphs=True)
        for f in frames:
            s.track(*f)
        s.results()
    tr = s.trace()
    spans = tr["spans"]
    replays = [sp for sp in spans if sp["name"] in ("tracking_graph", "background_graph")]
    assert len(replays) == s.track_graph.replays + s.background_graph.replays
    order = sorted(replays, key=lambda sp: sp["start_ns"])
    for a, b in zip(order, order[1:]):
        assert a["start_ns"] <= a["end_ns"] <= b["start_ns"]
    err = tr["clock"]["error_ns"]
    assert 0 < err < 50_000
    for sp in replays:
        assert sp["start_ns"] >= spans[sp["parent"]]["start_ns"] - err
    stages = tr["stages"]["tracking"]
    tracked = s.track_graph.replays
    names = ("extract", "bow", "attempts", "local_map", "keyframe")
    assert all(stages[k][1] == tracked for k in names + ("program",))
    assert stages["carry"][1] >= tracked
    share = sum(stages[k][0] for k in names + ("carry",)) / stages["program"][0]
    assert 0.90 <= share <= 1.0, share
    bg = tr["stages"]["background"]
    assert sum(v[0] for k, v in bg.items() if k not in ("program", "close_step")) \
        <= bg["program"][0]
    assert graphs.timer_resolution(torch.device("cuda"))["changes"] > 0
