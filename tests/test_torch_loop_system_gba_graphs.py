"""``SlamSystem``'s graph path with the loop close inside the background
program and ``enable_global_ba``, on the CPU, over
tests/test_torch_loop_background.py's drifted chain (the systems and rounds of
test_torch_loop_system_graphs.py): one read after each dispatch's background
replays (the JAX package reads its close results synchronously when global BA
is on), the same global BA after the closure on both paths, the loop records
and every map and loop-state tensor equal to the eager system's bit for
bit."""

import torch

from test_torch_loop_system_graphs import _assert_same, _chain_systems, _rounds
from test_torch_loop_background import ROUNDS

torch.set_num_threads(1)


def test_system_graph_path_global_ba_one_read_a_dispatch(monkeypatch):
    eager, graph = _chain_systems(gba=True)
    runs = []
    for s in (eager, graph):
        gba = s._global_ba
        monkeypatch.setattr(s, "_global_ba", lambda gba=gba, s=s: (runs.append(s), gba()))
    calls = _rounds(eager, graph, monkeypatch)
    assert calls == [1] * ROUNDS  # one read after each dispatch's replays
    assert runs == [eager, graph]  # global BA once each, after the closure
    _assert_same(eager, graph)
