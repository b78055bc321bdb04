"""The port's global BA (solvers/global_ba.py::global_bundle_adjust) against
the JAX package's, on tests/test_local_ba.py::fabricate_map's scenes.

The three single-device cases of tests/test_global_ba.py run on the port with
their own bounds; the fourth, global_bundle_adjust_mesh (ported in
solvers/global_ba.py), is covered by
tests/test_torch_parallel.py::test_global_ba_mesh_matches_single_device (and
its -m slow twin against the JAX mesh, test_global_ba_mesh_matches_jax_mesh).
Against JAX the poses agree within 1e-2 and the reprojection RMSE within 50%:
the JAX package's f32 Schur CG over 24 iterations amplifies rounding (its own
tests/test_global_ba.py::TestGlobalBAMesh measured ~3e-3 between two
compilations of its core), most on the fabricated maps' points with a single
monocular observation, where the reduced camera system is indefinite in f32;
the port solves in f64 (solvers/global_ba.py, ROADMAP queue 3). Two port
runs give identical maps (every sum runs in a fixed order). The scene
chip_smoke.py solves on the card is fabricate_map's (held here), and free
slots change nothing in the solve (to 1e-6).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vo_slam_test_tpu.solvers.global_ba import global_bundle_adjust as j_gba
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers.global_ba import global_bundle_adjust
from test_local_ba import CAPS, fabricate_map, reproj_rmse
from torch_slam_helpers import port_map

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
P_CAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                 n_feat=CAPS.n_feat)
CAM = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                    camera_k3=0), "cpu")


class _Host:
    """A port map's fields as numpy, for tests/test_local_ba.py::reproj_rmse."""

    def __init__(self, m):
        self.__dict__.update(convert.map_state_to_numpy(m))


def _both(m, cam):
    pm = port_map(jax.device_get(m))
    got = global_bundle_adjust(pm, P_CAPS, CAM, 0)
    want = j_gba(m, CAPS, cam, jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-2)
    r_got, r_want = reproj_rmse(_Host(got), cam, 6, 400), reproj_rmse(want, cam, 6, 400)
    assert r_got < 1.5 * r_want + 0.05, (r_got, r_want)
    return pm, got


def test_recovers_geometry():
    m, gt_poses, gt_pts, cam = fabricate_map(pose_noise=0.03, pt_noise=0.05, seed=3)
    before = reproj_rmse(m, cam, 6, 400)
    pm, m2 = _both(m, cam)
    after = reproj_rmse(_Host(m2), cam, 6, 400)
    assert after < before * 0.1, (before, after)
    assert after < 1.0, after
    est = m2.kf_pose.numpy()[:6]
    terr = np.linalg.norm(est[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    assert terr.max() < 0.01, terr
    # gauge anchor untouched
    np.testing.assert_allclose(m2.kf_pose.numpy()[0], gt_poses[0], atol=1e-6)
    again = global_bundle_adjust(pm, P_CAPS, CAM, 0)
    assert torch.equal(again.kf_pose, m2.kf_pose) and torch.equal(again.pt_pos, m2.pt_pos)


def test_invalid_slots_untouched():
    m, *_, cam = fabricate_map(seed=3)
    pm, m2 = _both(m, cam)
    pv, kv = pm.pt_valid.numpy(), pm.kf_valid.numpy()
    np.testing.assert_array_equal(m2.pt_pos.numpy()[~pv], pm.pt_pos.numpy()[~pv])
    np.testing.assert_array_equal(m2.kf_pose.numpy()[~kv], pm.kf_pose.numpy()[~kv])


def test_robust_to_outlier():
    m, gt_poses, gt_pts, cam = fabricate_map(noise_px=0.2, pose_noise=0.02, seed=3)
    uv = np.array(m.kf_uv_und)
    uv[3, 10] += 120.0  # one wildly wrong observation
    m = m.replace(kf_uv_und=jnp.asarray(uv))
    _, m2 = _both(m, cam)
    est = m2.kf_pose.numpy()[:6]
    terr = np.linalg.norm(est[:, :3, 3] - gt_poses[:, :3, 3], axis=1)
    assert terr.max() < 0.02, terr


def test_chip_smoke_scene_is_fabricate_map():
    """chip_smoke.gba_scene (the card's global-BA scene) is
    tests/test_local_ba.py::fabricate_map of test_recovers_geometry."""
    m, gt_poses, _, _ = fabricate_map(pose_noise=0.03, pt_noise=0.05, seed=3)
    pm, p_gt, _ = cs.gba_scene(P_CAPS, "cpu")
    np.testing.assert_allclose(p_gt, gt_poses, atol=1e-6)
    got = convert.map_state_to_numpy(pm)
    for k, want in convert.dataclass_to_numpy(jax.device_get(m)).items():
        want = np.asarray(want)
        assert got[k].dtype == want.dtype, k
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[k], want, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_free_slots_do_not_change_the_solve():
    """The same scene in caps with more keyframe and point slots (all free):
    the same poses and points, to float64 rounding (the per-point sums leave
    the free slots out, the per-keyframe sums add their zeros)."""
    small, _, cam = cs.gba_scene(P_CAPS, "cpu")
    big_caps = MapCaps(max_kf=2 * P_CAPS.max_kf, max_pt=2 * P_CAPS.max_pt,
                       max_obs=P_CAPS.max_obs, n_feat=P_CAPS.n_feat)
    big, _, _ = cs.gba_scene(big_caps, "cpu")
    a = global_bundle_adjust(small, P_CAPS, cam, 0)
    b = global_bundle_adjust(big, big_caps, cam, 0)
    np.testing.assert_allclose(b.kf_pose.numpy()[:P_CAPS.max_kf], a.kf_pose.numpy(), atol=1e-6)
    np.testing.assert_allclose(b.pt_pos.numpy()[:P_CAPS.max_pt], a.pt_pos.numpy(), atol=1e-6)
    assert not torch.equal(a.kf_pose, small.kf_pose)  # steps were taken
