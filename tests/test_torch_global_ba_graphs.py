"""Global BA as a step program (``solvers/global_ba.py::program``, the
counterpart of the JAX package's jitted ``global_bundle_adjust``): on the
CPU it runs in ``select`` mode under ``no_host_reads`` (the stand-in for a
replay), so nothing in it reads a value back.

On tests/test_local_ba.py::fabricate_map's scenes at the tests' caps and on
the same scene in caps with free keyframe and point slots: the program's
map equals eager ``global_bundle_adjust``'s bit for bit (every field), with
``fixed_kf`` a device int; against the JAX package's ``global_bundle_adjust``
it stays within tests/test_torch_global_ba.py's bounds (poses within 1e-2,
reprojection RMSE under 1.5x JAX's + 0.05). ``SlamSystem(graphs=True,
enable_global_ba=True)`` runs it from the process's program table: two
systems of one configuration share one entry, other caps get another, the
step function closes over no system, and the system's global BA equals the
eager system's. The JAX side runs once per file (module fixture).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.solvers.global_ba import global_bundle_adjust as j_gba
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import global_ba
from vo_slam_test_tpu_torch.utils import graphs
from test_local_ba import CAPS, fabricate_map, reproj_rmse
from test_torch_global_ba import CAM, P_CAPS, _Host
from torch_slam_helpers import port_map

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
CFG = SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
BIG_CAPS = MapCaps(max_kf=2 * P_CAPS.max_kf, max_pt=2 * P_CAPS.max_pt, max_obs=P_CAPS.max_obs,
                   n_feat=P_CAPS.n_feat)


def _outlier_scene():
    m, _, _, cam = fabricate_map(noise_px=0.2, pose_noise=0.02, seed=3)
    uv = np.array(m.kf_uv_und)
    uv[3, 10] += 120.0  # tests/test_global_ba.py's wildly wrong observation
    return m.replace(kf_uv_und=jnp.asarray(uv)), cam


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX map as numpy, JAX camera, JAX's global BA result as
    numpy)."""
    out = {}
    m, _, _, cam = fabricate_map(pose_noise=0.03, pt_noise=0.05, seed=3)
    for name, (jm, jcam) in {"geometry": (m, cam), "outlier": _outlier_scene()}.items():
        want = j_gba(jm, CAPS, jcam, jnp.asarray(0, jnp.int32))
        out[name] = (jax.device_get(jm), jcam, jax.device_get(want))
    return out


def _run_program(m, caps):
    owner = global_ba.MapOwner(m)
    prog = global_ba.program(owner, caps, CAM, None)
    got, outs = prog.run((CAM, None, torch.zeros((), dtype=torch.int32)), m)
    assert outs == () and prog.step().warmed
    return got


def _differ(a, b) -> list:
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


@pytest.mark.parametrize("name", ["geometry", "outlier"])
def test_program_equals_eager_and_stays_near_jax(scenes, name):
    m, jcam, want = scenes[name]
    pm = port_map(m)
    eager = global_ba.global_bundle_adjust(pm, P_CAPS, CAM, 0)
    got = _run_program(port_map(m), P_CAPS)
    assert _differ(got, eager) == []
    assert not torch.equal(got.kf_pose, pm.kf_pose)  # steps were taken
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-2)
    r_got, r_want = reproj_rmse(_Host(got), jcam, 6, 400), reproj_rmse(want, jcam, 6, 400)
    assert r_got < 1.5 * r_want + 0.05, (r_got, r_want)


def test_program_with_free_slots_equals_eager():
    """The scene in caps with twice the keyframe and point slots, all the
    added ones free: the free slots sort into the cut-off segments and add
    zeros to the per-keyframe sums."""
    big, _, cam = cs.gba_scene(BIG_CAPS, "cpu")
    eager = global_ba.global_bundle_adjust(big, BIG_CAPS, cam, 0)
    owner = global_ba.MapOwner(big)
    got, _ = global_ba.program(owner, BIG_CAPS, cam, None).run(
        (cam, None, torch.zeros((), dtype=torch.int32)), big)
    assert _differ(got, eager) == []
    assert not torch.equal(got.pt_pos, big.pt_pos)


def test_system_programs_share_the_table(scenes):
    graphs.clear_programs()
    systems = [SlamSystem(CFG, caps=caps, device="cpu", enable_global_ba=True, graphs=True)
               for caps in (P_CAPS, P_CAPS, BIG_CAPS)]
    steps = [s.gba_graph.step() for s in systems]
    assert steps[0] is steps[1] and steps[2] is not steps[0]
    keys = [key for key, _ in graphs.programs()]
    assert [k[1] for k in keys] == ["global_ba"] * 2
    assert {k[2] for k in keys} == {("caps", P_CAPS), ("caps", BIG_CAPS)}
    fn = steps[0].fn
    assert fn.func is global_ba.global_ba_step and sorted(fn.keywords) == [
        "caps", "cg_iters", "iters"]
    # the graph system's global BA runs the program: equal to the eager system's
    m = scenes["geometry"][0]
    eager = SlamSystem(CFG, caps=P_CAPS, device="cpu", enable_global_ba=True, graphs=False)
    for s in (eager, systems[0]):
        s.map = port_map(m)
        s._global_ba()
    assert _differ(systems[0].map, eager.map) == []
    assert not torch.equal(eager.map.kf_pose, port_map(m).kf_pose)
    graphs.clear_programs()
