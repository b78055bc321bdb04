"""The device loops of ``utils/graphs.py`` on the CPU: ``scan``, ``fori_loop``
and ``while_capped`` in select mode under ``no_host_reads`` (the stand-in for
a replay of one WHILE node) against their eager forms, over trip ranges
[start, start + n) with n = 0 and n = K, host and device range ints, an early
exit on the first, a middle and no trip, stacked per-trip outputs and the
device trip index; then ``loop_closing._close_multi``'s candidate scan on
tests/test_torch_loop_close.py's multi-candidate scene, with dead slots
between live ones and with an accept on the first slot, against its eager
form and against the JAX package's ``close_step_multi`` (the JAX runs are
tests/test_torch_loop_close_graphs.py's, shared by the session)."""

import contextlib

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.slam_map.map_state import pick
from vo_slam_test_tpu_torch.utils import graphs
from test_torch_loop_background import GROUP_DIV
from test_torch_loop_close import KW, P_CAPS, SCALES, _assert_map
from test_torch_loop_close_graphs import JAX_CANDS, _leaves_equal, jax_close_multi
from torch_slam_helpers import port_map

torch.set_num_threads(1)

K = 6
XS = torch.tensor([1.5, -2.0, 0.25, 4.0, -0.5, 3.0])


def _body(i, carry, x):
    """A trip: a running sum and a trip count; the outputs hold the trip
    index (the device int the body gets) and a value of the carry before."""
    total, trips = carry
    return (total + x * (i + 1).to(torch.float32), trips + 1), dict(i=i, before=total * 2)


def _run(mode, start, n, until=None, device_ints=False):
    if device_ints:
        start, n = torch.tensor(start), torch.tensor(n)
    carry = (torch.zeros(()), torch.zeros((), dtype=torch.int32))
    guard = graphs.no_host_reads() if mode == "select" else contextlib.nullcontext()
    with graphs.use(mode), guard:
        return graphs.scan(_body, carry, XS, start=start, n=n, until=until)


def _plain(start, n, stop_at=None):
    """The loop by hand -> (total, trips, rows of i, rows of before)."""
    total, trips = 0.0, 0
    idx, before = [0] * K, [0.0] * K
    for i in range(start, min(start + n, K)):
        if stop_at is not None and total > stop_at:
            break
        idx[i], before[i] = i, np.float32(total) * 2
        total = np.float32(total + np.float32(XS[i]) * (i + 1))
        trips += 1
    return np.float32(total), trips, idx, before


@pytest.mark.parametrize("device_ints", [False, True])
@pytest.mark.parametrize("start,n", [(0, 0), (0, K), (2, 3), (K - 1, 1), (3, K), (0, 1)])
def test_scan_select_equals_eager(start, n, device_ints):
    eager = _run("eager", start, n, device_ints=device_ints)
    select = _run("select", start, n, device_ints=device_ints)
    total, trips, idx, before = _plain(start, n)
    for got in (eager, select):
        (t, c), ys = got
        assert float(t) == total and int(c) == trips
        if trips == 0:
            assert ys is None  # no trip ran and no ys given
            continue
        assert ys["i"].dtype == torch.int64 and ys["i"].tolist() == idx
        assert ys["before"].tolist() == before
    if trips:
        _leaves_equal(eager, select, "select against eager")


@pytest.mark.parametrize("stop_at,want_trips", [(-1.0, 0), (2.0, 4), (100.0, K)])
def test_scan_early_exit(stop_at, want_trips):
    """``until`` tested before each trip: an exit before the first trip, in
    the middle and never; the rows of the trips not run keep ``ys``."""
    def until(c):
        return c[0] > stop_at

    fill = dict(i=torch.full((K,), -7, dtype=torch.int64), before=torch.full((K,), 9.0))
    runs = []
    for mode in ("eager", "select"):
        carry = (torch.zeros(()), torch.zeros((), dtype=torch.int32))
        guard = graphs.no_host_reads() if mode == "select" else contextlib.nullcontext()
        with graphs.use(mode), guard:
            runs.append(graphs.scan(_body, carry, XS, ys=fill, until=until))
    total, trips, idx, before = _plain(0, K, stop_at)
    assert trips == want_trips
    for (t, c), ys in runs:
        assert float(t) == total and int(c) == trips
        assert ys["i"].tolist() == idx[:trips] + [-7] * (K - trips)
        assert ys["before"].tolist() == before[:trips] + [9.0] * (K - trips)
    assert torch.equal(fill["i"], torch.full((K,), -7, dtype=torch.int64))  # the loop's own rows
    _leaves_equal(runs[0], runs[1], "select against eager")


def test_fori_loop_and_while_capped_select_equal_eager():
    """``fori_loop`` from a host and a device lower bound; ``while_capped``
    stopping on its flag and on its trip cap."""
    def fori(mode, lower):
        one = torch.ones((), dtype=torch.int64)
        with graphs.use(mode):
            return graphs.fori_loop(lower, 8, lambda i, c: c * 2 + i, one)

    want = 1
    for i in range(3, 8):
        want = want * 2 + i
    for lower in (3, torch.tensor(3)):
        got = [fori(m, lower) for m in ("eager", "select")]
        assert [int(x) for x in got] == [want, want]

    def loop(mode, cap):
        state = (torch.ones(()), torch.zeros((), dtype=torch.int32))
        guard = graphs.no_host_reads() if mode == "select" else contextlib.nullcontext()
        with graphs.use(mode), guard:
            return graphs.while_capped(lambda c: c[0] < 50.0, lambda c: (c[0] * 3, c[1] + 1),
                                       state, cap)

    for cap, trips in ((10, 4), (2, 2), (0, 0)):
        e, s = loop("eager", cap), loop("select", cap)
        _leaves_equal(e, s, f"while_capped cap {cap}")
        assert int(s[1]) == trips and float(s[0]) == 3.0 ** trips


# ---------------------------------------------------------------------------
# the Sim3 candidate scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    run = jax_close_multi(tmp_path_factory)
    return dict(run, cam=Camera.from_config(SlamConfig(**KW), "cpu"))


def _close(scene, cands, gens, select: bool):
    """``_close_multi`` for keyframe 9 (eager with a host id, select with a
    device one) counting the slots that ran their verification."""
    m = port_map(scene["host"])
    kf = torch.tensor(9, dtype=torch.int32) if select else 9
    kf_ok = pick(m.kf_valid, torch.as_tensor(kf)) & (pick(m.kf_gen, torch.as_tensor(kf)) == 0)
    guard = graphs.no_host_reads() if select else contextlib.nullcontext()
    with graphs.use("select" if select else "eager"), guard:
        return LC._close_multi(m, LC.empty_loop_state(P_CAPS, "cpu"), kf, kf_ok,
                               torch.tensor(cands, dtype=torch.int32),
                               torch.tensor(gens, dtype=torch.int32), GROUP_DIV, P_CAPS,
                               scene["cam"], torch.as_tensor(SCALES))


@pytest.mark.parametrize("name,tried,winner_slot", [
    ("gapped", [True, False, True, False, True, False, False, False], 4),
    ("first", [True] + [False] * 7, 0),
])
def test_close_scan_equals_eager_and_jax(scene, monkeypatch, name, tried, winner_slot):
    """Dead slots between live ones are skipped and the scan goes on past
    them (the JAX package's scan); after an accept no slot runs (the early
    exit), in both modes; the map within 1e-4 of JAX's."""
    cands, gens = JAX_CANDS[name]
    ran = []
    gates = LC._gates_and_group

    def counted(*a, **k):
        ran.append(1)
        return gates(*a, **k)

    monkeypatch.setattr(LC, "_gates_and_group", counted)
    m_e, ls_e, out_e = _close(scene, cands, gens, False)
    n_eager, ran[:] = len(ran), []
    m_g, ls_g, out_g = _close(scene, cands, gens, True)
    _leaves_equal((m_e, ls_e, out_e), (m_g, ls_g, out_g), f"{name}: select against eager")
    # eager verifies the live slots; select (on the CPU) runs every trip up
    # to the accept, where the WHILE node stops, and each cond's two sides
    assert n_eager == sum(tried) and len(ran) == winner_slot + 1
    closed, which, got_tried, accepted, gate_rows = graphs.fetch(*out_g.leaves())
    assert got_tried == tried
    assert accepted == [i == winner_slot for i in range(len(tried))]
    assert (closed, which) == (True, cands[winner_slot])
    assert all(v == 0 for i, t in enumerate(tried) if not t
               for v in gate_rows[11 * i:11 * (i + 1)])
    want_map, want_seq, want_done, want_which = scene["want"][name]
    assert (want_done, want_which) == (True, cands[winner_slot])
    assert int(ls_g.last_loop_seq) == want_seq
    _assert_map(m_g, want_map, f"_close_multi ({name}) in select mode")
