"""``SlamSystem``'s graph path with the loop close inside the background
program, on the CPU, over tests/test_torch_loop_background.py's drifted chain
(four keyframe events of KF9, local BA interrupted; the fourth detection
confirms KF0 and the loop closes): the graph system's background program in
select mode under ``no_host_reads`` (the stand-in for a replay) against the
eager system's ``background_step``. Without global BA nothing is read after a
background replay, and ``_settle`` (what ``results()`` reads) folds the
close's records with the eager path's values and order (with global BA:
test_torch_loop_system_gba_graphs.py). Every map and loop-state tensor equal
bit for bit. Also: the card tests' JAX-free construction of the chain
(tests/torch_loop_chain.py) against the JAX-built map."""

import dataclasses
import types

import jax
import numpy as np
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import system
from test_torch_loop_background import GROUP_DIV, KW, P_CAPS, ROUNDS, place_map
from torch_loop_chain import drifted_chain
from torch_slam_helpers import port_map

torch.set_num_threads(1)


def _chain_systems(gba: bool):
    """Two SlamSystems on the drifted chain (tests/test_torch_loop_background
    .py's place map), eager and graph path, with a vocabulary whose featVec
    divisor is the chain's (k 10, 3 levels)."""
    start = jax.device_get(place_map(JCamera.from_config(JConfig(**KW)))[0])
    voc = V.synth_vocabulary(k=10, levels=3, seed=0, device="cpu")
    made = []
    for on in (False, True):
        s = system.SlamSystem(SlamConfig(**KW), caps=P_CAPS, device="cpu", vocabulary=voc,
                              enable_global_ba=gba, graphs=on)
        assert s._bow_group_div == GROUP_DIV
        s.map = port_map(start)
        made.append(s)
    return made


def _rounds(eager, graph, monkeypatch):
    """ROUNDS keyframe events of KF9 (local BA interrupted) on both systems:
    the eager one through ``background_step`` and ``_fold_background`` (as
    its ``track`` runs them), the graph one through
    ``_graph_background_steps`` (its program in select mode). -> the graph
    system's ``_settle`` calls per round."""
    calls = []
    settle = graph._settle

    def counted():
        calls[-1] += 1
        return settle()

    monkeypatch.setattr(graph, "_settle", counted)
    for r in range(ROUNDS):
        eager.map, eager.loop_state, bg = system.background_step(
            eager.map, eager.loop_state, True, 9, True, eager.caps, eager.camera,
            eager.scale_factors, True, eager._bow_group_div)
        eager._fold_background([(r, True, bg)])
        graph._outs.append(types.SimpleNamespace(made_kf=None, reloc_winner=None))
        calls.append(0)
        graph._graph_background_steps(len(graph._outs) - 1, torch.tensor([True]),
                                      torch.tensor([9], dtype=torch.int32), torch.tensor([True]))
        graph._frame_id += 1
    monkeypatch.setattr(graph, "_settle", settle)
    return calls


def _assert_same(eager, graph):
    assert graph.loop_closures == eager.loop_closures == [ROUNDS - 1]
    assert graph.loop_attempts == eager.loop_attempts == [(ROUNDS - 1, 0, True)]
    assert graph.loop_gates == eager.loop_gates and graph.loop_gates[0][:3] == (ROUNDS - 1, 0,
                                                                                 True)
    assert graph.ba_iters == eager.ba_iters
    for f in dataclasses.fields(eager.map):
        assert torch.equal(getattr(eager.map, f.name), getattr(graph.map, f.name)), f.name
    for f in dataclasses.fields(eager.loop_state):
        assert torch.equal(getattr(eager.loop_state, f.name),
                           getattr(graph.loop_state, f.name)), f.name


def test_system_graph_path_reads_nothing_after_the_close(monkeypatch):
    eager, graph = _chain_systems(gba=False)
    calls = _rounds(eager, graph, monkeypatch)
    assert calls == [0] * ROUNDS  # no read after a background replay
    assert graph.loop_closures == [] and len(graph._bg_pending) == ROUNDS
    graph._settle()  # what results() reads
    assert graph._bg_pending == []
    _assert_same(eager, graph)


def test_card_chain_equals_the_jax_place_map():
    """tests/torch_loop_chain.py (the card tests' JAX-free construction) gives the
    JAX-built place map: integer and bool fields equal, poses and points
    within 1e-6 (se3_exp of each package)."""
    want = convert.dataclass_to_numpy(
        jax.device_get(place_map(JCamera.from_config(JConfig(**KW)))[0]))
    got = convert.map_state_to_numpy(drifted_chain("cpu"))
    for k, v in want.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
