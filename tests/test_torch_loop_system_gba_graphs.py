"""``SlamSystem``'s graph path with the loop close inside the background
program and ``enable_global_ba``, on the CPU, over
tests/test_torch_loop_background.py's drifted chain (the systems and rounds of
test_torch_loop_system_graphs.py): one read after each dispatch's background
replays (the JAX package reads its close results synchronously when global BA
is on), global BA after the closure on both paths (on the graph path through
its step program, ``solvers/global_ba.py::program``, in select mode under
``no_host_reads``; eager ``global_bundle_adjust`` on the eager path), the
loop records and every map and loop-state tensor equal to the eager system's
bit for bit."""

import torch

from vo_slam_test_tpu_torch.solvers import global_ba

from test_torch_loop_system_graphs import _assert_same, _chain_systems, _rounds
from test_torch_loop_background import ROUNDS

torch.set_num_threads(1)


def test_system_graph_path_global_ba_one_read_a_dispatch(monkeypatch):
    eager, graph = _chain_systems(gba=True)
    runs = []
    for s in (eager, graph):
        gba = s._global_ba
        monkeypatch.setattr(s, "_global_ba", lambda gba=gba, s=s: (runs.append(s), gba()))
    eager_gba, direct = global_ba.global_bundle_adjust, []
    monkeypatch.setattr(global_ba, "global_bundle_adjust",
                        lambda *a, **k: (direct.append(a[0]), eager_gba(*a, **k))[1])
    calls = _rounds(eager, graph, monkeypatch)
    assert calls == [1] * ROUNDS  # one read after each dispatch's replays
    assert runs == [eager, graph]  # global BA once each, after the closure
    assert len(direct) == 1  # the eager system's; the graph system ran its program
    assert graph.gba_graph.last is not None and graph.gba_graph.step().warmed
    assert eager.gba_graph.last is None
    _assert_same(eager, graph)
