"""Multi-device solvers: the port's ``parallel/`` and mesh BA on an 8-shard
CPU mesh, against the JAX package's 8-device CPU mesh (tests/conftest.py)
and against the port's single-device solvers.

- ``sharded_pose_gn_step``: 8 steps from the identity on tests/
  test_parallel.py's observations; within 1e-3 of the truth (that test's
  bound) and within 1e-5 of JAX's mesh, step by step (the same f32 formulas;
  only the partials' order of addition differs);
- ``sharded_ba_normal_equations``: JAX's mesh outputs within 1e-4 of their
  largest entry (tests/test_parallel.py's tolerance against its oracle);
- ``sharded_ba_schur_step``: on a window where every point is seen by every
  keyframe, damped, poses and points within 5e-5 of JAX's mesh (one f32
  Schur solve, steps of 2-6 cm; the first pose pinned);
- ``local_bundle_adjust_mesh`` against the port's ``local_bundle_adjust`` on
  tools/synth_map.py's map (built by JAX, carried across with
  ``convert.map_state_from_numpy``), as tests/test_parallel.py holds JAX's:
  ``pt_obs_cnt`` equal, poses within 5e-4, live points within 5e-3, the
  perturbed pose corrected; L = 1024 over 8 shards of 128 puts the window's
  live points in the first shards and leaves the last ones dead, as the JAX
  layout does;
- ``global_bundle_adjust_mesh`` against ``global_bundle_adjust`` under
  tests/test_global_ba.py:49-80's contract, with 8 shards (each holds two
  keyframes' runs of the [K*N] table) and 32 (each keyframe's run cut in two);
- the twins against JAX's mesh solvers themselves are ``slow``, as the JAX
  package's are (tests/test_parallel.py:121, tests/test_global_ba.py:62).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import parallel as jparallel
from vo_slam_test_tpu.parallel.sharded import shard_observations as jshard_observations
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.solvers import global_ba as jgba
from vo_slam_test_tpu.solvers import local_ba as jlba
from vo_slam_test_tpu_torch import convert, parallel
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import global_ba, local_ba
from vo_slam_test_tpu_torch.solvers.pose_only import PoseObs
from test_local_ba import CAPS, fabricate_map, reproj_rmse
from test_parallel import BF, CX, CY, FX, FY, make_obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)
from synth_map import build  # noqa: E402
from chip_smoke import ba_obs_instance, schur_instance  # noqa: E402

torch.set_num_threads(1)
NO_DIST = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)


def cpu_mesh(n=8):
    return parallel.make_obs_mesh(n, ["cpu"])


def port_obs(obs) -> PoseObs:
    return PoseObs(*[torch.as_tensor(np.array(f)) for f in obs])


def test_mesh_object():
    mesh = cpu_mesh()
    assert (mesh.n_shards, mesh.n_devices) == (8, 1)
    x = torch.arange(16.0).reshape(8, 2)
    parts = mesh.split(x)
    assert len(parts) == 8 and torch.equal(mesh.gather(parts), x)
    assert torch.equal(mesh.psum(parts), x.sum(0, keepdim=True))
    assert torch.equal(mesh.pmax(parts), x.max(0, keepdim=True).values)
    with pytest.raises(ValueError):
        mesh.split(torch.zeros(12))
    two = parallel.make_obs_mesh(3, ["cpu", "meta"])
    assert [d.type for d in two.shard_devices] == ["cpu", "meta", "cpu"] and two.n_devices == 2


def test_pose_gn_matches_jax_mesh():
    T_gt, jobs = make_obs(64)
    jmesh = jparallel.make_obs_mesh(8)
    jfn = jparallel.sharded_pose_gn_step(jmesh)
    jobs_sh = jshard_observations(jmesh, jobs)
    mesh = cpu_mesh()
    fn = parallel.sharded_pose_gn_step(mesh)
    obs = parallel.shard_observations(mesh, port_obs(jobs))
    T, jT = torch.eye(4), jnp.eye(4)
    for _ in range(8):
        T = fn(T, obs, FX, FY, CX, CY, BF)
        jT = jfn(jT, jobs_sh, FX, FY, CX, CY, BF)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=0, atol=1e-5)
    assert np.abs(T.numpy() - T_gt).max() < 1e-3
    # a whole PoseObs is split by the step itself
    np.testing.assert_array_equal(fn(torch.eye(4), port_obs(jobs), FX, FY, CX, CY, BF).numpy(),
                                  fn(torch.eye(4), obs, FX, FY, CX, CY, BF).numpy())


def test_ba_normal_equations_match_jax_mesh():
    W, L = 4, 32
    arrs = ba_obs_instance()
    want = jparallel.sharded_ba_normal_equations(jparallel.make_obs_mesh(8), W, L)(
        *[jnp.asarray(a) for a in arrs], FX, FY, CX, CY)
    got = parallel.sharded_ba_normal_equations(cpu_mesh(), W, L)(
        *[torch.as_tensor(a) for a in arrs], FX, FY, CX, CY)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1.0))


def test_ba_schur_step_matches_jax_mesh():
    """Damped (lam 100): monocular residuals leave the window's scale free,
    and at the default 1e-4 the step along it follows the rounding (one and
    eight shards of the port already part by metres there)."""
    W, L, lam = 4, 32, 100.0
    arrs = schur_instance()
    jp, jx = jparallel.sharded_ba_schur_step(jparallel.make_obs_mesh(8), W, L, lam)(
        *[jnp.asarray(a) for a in arrs], FX, FY, CX, CY)
    p, x = parallel.sharded_ba_schur_step(cpu_mesh(), W, L, lam)(
        *[torch.as_tensor(a) for a in arrs], FX, FY, CX, CY)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=5e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=5e-5)
    np.testing.assert_array_equal(p.numpy()[0], arrs[0][0])  # the pinned pose
    # the step moves the perturbed poses and points
    assert np.abs(p.numpy() - arrs[0]).max() > 1e-3 and np.abs(x.numpy() - arrs[1]).max() > 1e-3


SYNTH_CAPS = dict(max_kf=16, max_pt=1024, max_obs=8, n_feat=128)


@pytest.fixture(scope="module")
def synth():
    """tools/synth_map.py's map with two poses perturbed (tests/
    test_parallel.py's setup), and the port's camera."""
    m, _ = build(JMapCaps(**SYNTH_CAPS), n_kf=8, n_pt=300, seed=11)
    poses = np.asarray(m.kf_pose).copy()
    poses[7, 0, 3] += 0.04
    poses[6, 1, 3] -= 0.02
    m = m.replace(kf_pose=jnp.asarray(poses))
    host = convert.dataclass_to_numpy(jax.device_get(m))
    cam = Camera.from_config(SlamConfig(**NO_DIST), "cpu")
    return dict(jmap=m, host=host, poses=poses, cam=cam)


def port_copy(host):
    return convert.map_state_from_numpy(host, "cpu")


def assert_mesh_ba_close(m_mesh, m_single, poses_before):
    np.testing.assert_allclose(m_mesh.kf_pose.numpy(), m_single.kf_pose.numpy(), atol=5e-4)
    live = m_single.pt_valid.numpy() & m_mesh.pt_valid.numpy()
    np.testing.assert_allclose(m_mesh.pt_pos.numpy()[live], m_single.pt_pos.numpy()[live],
                               atol=5e-3)
    np.testing.assert_array_equal(m_mesh.pt_obs_cnt.numpy(), m_single.pt_obs_cnt.numpy())
    assert np.abs(m_mesh.kf_pose.numpy()[7] - poses_before[7]).max() > 1e-4


def test_local_ba_mesh_matches_single_device(synth):
    caps = MapCaps(**SYNTH_CAPS)
    m_single, n1, n2 = local_ba.local_bundle_adjust_iters(port_copy(synth["host"]), 7, caps,
                                                          synth["cam"])
    mesh = cpu_mesh()
    m_mesh, k1, k2 = local_ba.local_bundle_adjust_mesh_iters(port_copy(synth["host"]), 7, caps,
                                                             synth["cam"], mesh)
    assert_mesh_ba_close(m_mesh, m_single, synth["poses"])
    assert n1 > 0 and k1 > 0
    # the layout: live points first, 128 a shard, the last shards dead
    prob = local_ba.build_problem_ol(port_copy(synth["host"]), 7, caps)
    n = int((prob.pt_ids >= 0).sum())
    live = [int(p.sum()) for p in mesh.split(prob.pt_ids >= 0)]
    assert live == [min(max(n - 128 * s, 0), 128) for s in range(8)] and live[-1] == 0, live
    # the entry check skips the whole BA, as local_bundle_adjust's does
    skipped = local_ba.local_bundle_adjust_mesh(port_copy(synth["host"]), 7, caps, synth["cam"],
                                                mesh, stop=True)
    np.testing.assert_array_equal(skipped.kf_pose.numpy(), synth["host"]["kf_pose"])
    with pytest.raises(ValueError):
        local_ba.local_bundle_adjust_mesh(port_copy(synth["host"]), 7, caps, synth["cam"],
                                          cpu_mesh(3))


@pytest.fixture(scope="module")
def gba_scene():
    m, gt_poses, _, jcam = fabricate_map(pose_noise=0.03, pt_noise=0.05, seed=3)
    host = convert.dataclass_to_numpy(jax.device_get(m))
    cam = Camera.from_config(SlamConfig(**NO_DIST), "cpu")
    caps = MapCaps(CAPS.max_kf, CAPS.max_pt, CAPS.max_obs, CAPS.n_feat)
    m1 = global_ba.global_bundle_adjust(port_copy(host), caps, cam, 0)
    return dict(jmap=m, host=host, gt=gt_poses, jcam=jcam, cam=cam, caps=caps, single=m1)


def assert_gba_contract(m2, scene):
    """tests/test_global_ba.py:49-80 against the single-device run."""
    m1, gt = scene["single"], scene["gt"]
    np.testing.assert_allclose(m2.kf_pose.numpy(), m1.kf_pose.numpy(), atol=1e-2)
    np.testing.assert_allclose(m2.kf_pose.numpy()[0], gt[0], atol=1e-6)
    terr = np.linalg.norm(m2.kf_pose.numpy()[:6, :3, 3] - gt[:, :3, 3], axis=1)
    assert terr.max() < 0.01, terr
    r1 = reproj_rmse(m1, scene["jcam"], 6, 400)
    r2 = reproj_rmse(m2, scene["jcam"], 6, 400)
    assert r2 < 1.0 and r2 < r1 * 1.1, (r1, r2)


@pytest.mark.parametrize("n_shards", [8, 32])
def test_global_ba_mesh_matches_single_device(gba_scene, n_shards):
    m2 = global_ba.global_bundle_adjust_mesh(port_copy(gba_scene["host"]), gba_scene["caps"],
                                             gba_scene["cam"], 0, cpu_mesh(n_shards))
    assert_gba_contract(m2, gba_scene)
    # the shards' f64 partials: the same optimum as one shard within 1e-6
    np.testing.assert_allclose(m2.kf_pose.numpy(), gba_scene["single"].kf_pose.numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.slow  # compiles the JAX production BA on the mesh (~20 s)
def test_local_ba_mesh_matches_jax_mesh(synth):
    caps = MapCaps(**SYNTH_CAPS)
    m_jax = jax.device_get(jlba.local_bundle_adjust_mesh(
        synth["jmap"], jnp.asarray(7, jnp.int32), JMapCaps(**SYNTH_CAPS),
        _jax_cam(), jparallel.make_obs_mesh(8)))
    m_mesh = local_ba.local_bundle_adjust_mesh(port_copy(synth["host"]), 7, caps, synth["cam"],
                                               cpu_mesh())
    assert_mesh_ba_close(m_mesh, convert.map_state_from_numpy(
        convert.dataclass_to_numpy(m_jax), "cpu"), synth["poses"])


@pytest.mark.slow  # compiles the JAX Schur-CG core on the mesh
def test_global_ba_mesh_matches_jax_mesh(gba_scene):
    m_jax = jax.device_get(jgba.global_bundle_adjust_mesh(
        gba_scene["jmap"], CAPS, gba_scene["jcam"], jnp.asarray(0, jnp.int32),
        jparallel.make_obs_mesh(8)))
    m2 = global_ba.global_bundle_adjust_mesh(port_copy(gba_scene["host"]), gba_scene["caps"],
                                             gba_scene["cam"], 0, cpu_mesh())
    # the JAX package's f32 solve against the port's f64 (tests/test_torch_global_ba.py)
    np.testing.assert_allclose(m2.kf_pose.numpy(), np.asarray(m_jax.kf_pose), atol=1e-2)
    assert_gba_contract(m2, gba_scene)


def _jax_cam():
    from vo_slam_test_tpu.camera import Camera as JCamera
    from vo_slam_test_tpu.config import SlamConfig as JConfig

    return JCamera.from_config(JConfig(**NO_DIST))
