"""The mesh solvers as step programs (``solvers/local_ba.py::mesh_program``
and ``solvers/global_ba.py::program`` with a mesh; the counterparts of the
JAX package's ``jax.jit(shard_map(optimize, ...))``), on the 8-shard CPU
mesh of tests/test_torch_parallel.py, where a program runs in ``select`` mode
under ``no_host_reads`` (the stand-in for a replay):

- each program's map equals the eager mesh call's bit for bit (every
  field), local BA's LM counts too, with ``center_kf``/``fixed_kf`` a device
  int and local BA's ``stop`` a device bool (raised: the map passes through,
  counts 0);
- each stays within tests/test_torch_parallel.py's bounds of the one-device
  solver (local BA: ``pt_obs_cnt`` equal, poses within 5e-4, live points
  within 5e-3; global BA: tests/test_global_ba.py's contract), on the scenes
  that file builds, at its caps;
- a mesh over two devices makes both programs raise;
- a second owner of one configuration finds the program in the process's
  table and runs it with no warm-up of its own, while another mesh layout
  gets an entry of its own.
"""

import dataclasses

import pytest
import torch

from vo_slam_test_tpu_torch import parallel
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import global_ba, local_ba
from vo_slam_test_tpu_torch.utils import graphs
from test_torch_parallel import (SYNTH_CAPS, assert_gba_contract, assert_mesh_ba_close,
                                 cpu_mesh, gba_scene, port_copy, synth)  # noqa: F401

torch.set_num_threads(1)
CENTER = 7


def _differ(a, b) -> list:
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def _local_inputs(cam, stop: bool):
    return (cam, None, torch.tensor(CENTER, dtype=torch.int32), torch.tensor(stop))


def _run_local(host, cam, mesh, stop=False):
    m = port_copy(host)
    owner = global_ba.MapOwner(m)
    prog = local_ba.mesh_program(owner, MapCaps(**SYNTH_CAPS), cam, None, mesh)
    got, (n1, n2) = prog.run(_local_inputs(cam, stop), m)
    return prog, got, n1, n2


@pytest.fixture(autouse=True)
def fresh_table():
    graphs.clear_programs()
    yield
    graphs.clear_programs()


def test_local_ba_mesh_program_equals_eager(synth):
    caps, cam, mesh = MapCaps(**SYNTH_CAPS), synth["cam"], cpu_mesh()
    eager, k1, k2 = local_ba.local_bundle_adjust_mesh_iters(port_copy(synth["host"]), CENTER, caps,
                                                            cam, mesh)
    prog, got, n1, n2 = _run_local(synth["host"], cam, mesh)
    assert prog.step().warmed and prog.name == "local_ba_mesh"
    assert _differ(got, eager) == []
    assert (int(n1), int(n2)) == (k1, k2) and k1 > 0
    single = local_ba.local_bundle_adjust(port_copy(synth["host"]), CENTER, caps, cam)
    assert_mesh_ba_close(got, single, synth["poses"])


def test_local_ba_mesh_program_stop_skips(synth):
    _, got, n1, n2 = _run_local(synth["host"], synth["cam"], cpu_mesh(), stop=True)
    assert _differ(got, port_copy(synth["host"])) == []
    assert (int(n1), int(n2)) == (0, 0)


@pytest.mark.parametrize("n_shards", [8, 32])
def test_global_ba_mesh_program_equals_eager(gba_scene, n_shards):  # noqa: F811
    caps, cam, mesh = gba_scene["caps"], gba_scene["cam"], cpu_mesh(n_shards)
    eager = global_ba.global_bundle_adjust_mesh(port_copy(gba_scene["host"]), caps, cam, 0, mesh)
    m = port_copy(gba_scene["host"])
    prog = global_ba.program(global_ba.MapOwner(m), caps, cam, None, mesh)
    got, outs = prog.run((cam, None, torch.zeros((), dtype=torch.int32)), m)
    assert outs == () and prog.name == "global_ba_mesh"
    assert _differ(got, eager) == []
    assert_gba_contract(got, gba_scene)


def test_mesh_programs_raise_over_two_devices(synth, gba_scene):  # noqa: F811
    two = parallel.make_obs_mesh(8, ["cpu", "meta"])
    assert two.n_devices == 2
    owner = global_ba.MapOwner(port_copy(synth["host"]))
    with pytest.raises(ValueError, match="2 devices"):
        local_ba.mesh_program(owner, MapCaps(**SYNTH_CAPS), synth["cam"], None, two)
    with pytest.raises(ValueError, match="2 devices"):
        global_ba.program(owner, gba_scene["caps"], gba_scene["cam"], None, two)
    assert graphs.programs() == []


def test_second_owner_replays_the_mesh_program(synth):
    caps, cam, mesh = MapCaps(**SYNTH_CAPS), synth["cam"], cpu_mesh()
    first, got1, _, _ = _run_local(synth["host"], cam, mesh)
    # a second owner, a mesh object of the same layout: no new entry, no warm-up
    second, got2, _, _ = _run_local(synth["host"], cam, cpu_mesh())
    assert second.step() is first.step() and second.step().hits == 1
    assert first.warm_s > 0 and (second.warm_s, second.capture_s) == (0.0, 0.0)
    assert second.replays == 0 and first.replays == 0  # the CPU never captures
    assert _differ(got2, got1) == []
    assert [k[1] for k, _ in graphs.programs()] == ["local_ba_mesh"]
    # another layout, and the global-BA programs with and without a mesh: new entries
    local_ba.mesh_program(global_ba.MapOwner(got1), caps, cam, None, cpu_mesh(4)).step()
    owner = global_ba.MapOwner(got1)
    global_ba.program(owner, caps, cam, None).step()
    global_ba.program(owner, caps, cam, None, mesh).step()
    keys = [k for k, _ in graphs.programs()]
    assert [k[1] for k in keys] == ["local_ba_mesh", "local_ba_mesh", "global_ba",
                                    "global_ba_mesh"]
    assert keys[0][3] == ("mesh", (8, (torch.device("cpu"),) * 8))
    assert keys[1][3] == ("mesh", (4, (torch.device("cpu"),) * 4))
    # with no mesh the key is the one-device program's; a mesh adds its layout
    assert len(keys[3]) == len(keys[2]) + 1 and keys[3][2:5] == keys[2][2:5]
    assert keys[3][5] == ("mesh", (8, (torch.device("cpu"),) * 8))
