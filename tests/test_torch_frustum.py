"""The scale-invariance distance band of the frustum gates,
[0.8 * minDistance, 1.2 * maxDistance] (mappoint.cpp:391-401), in the port:
the twins of tests/test_frustum.py's three cases through the port's
slam_map/local_map.py::search_local_points, each against the JAX package's
answer on the same map, and the loop closer's projection gate
(pipeline/loop_closing.py::_project_points), which applies the same band,
at the same camera distances.

One octave-0 point 2 m from a camera at the origin (maxDistance exactly its
spawn distance); the camera backs away or moves toward it along z. Exact
answers (visible flags, matched keypoint).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.slam_map.local_map import search_local_points as j_search
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.slam_map.map_state import empty_map as j_empty_map
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.loop_closing import _project_points
from vo_slam_test_tpu_torch.slam_map.local_map import search_local_points
from torch_slam_helpers import port_map

torch.set_num_threads(1)
KW = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
CAPS = JMapCaps(max_kf=4, max_pt=64, max_obs=4, n_feat=64)
SPAWN = 2.0
DESC = 0xA5A5A5A5


def _jax_map(scale_factors):
    m = j_empty_map(CAPS)
    return m.replace(
        pt_valid=m.pt_valid.at[0].set(True),
        pt_pos=m.pt_pos.at[0].set(jnp.asarray([0.0, 0.0, SPAWN])),
        pt_normal=m.pt_normal.at[0].set(jnp.asarray([0.0, 0.0, 1.0])),
        pt_min_dist=m.pt_min_dist.at[0].set(SPAWN / float(scale_factors[-1])),
        pt_max_dist=m.pt_max_dist.at[0].set(SPAWN),
        pt_desc=m.pt_desc.at[0].set(jnp.full((8,), jnp.uint32(DESC))))


def _both(cam_z):
    """tests/test_frustum.py::_setup in both packages -> (port match, JAX
    match, the closer's gate on the port)."""
    jcam = JCamera.from_config(JConfig(**KW))
    pcam = Camera.from_config(SlamConfig(**KW), "cpu")
    scale_factors = np.asarray([1.2 ** i for i in range(8)], np.float32)
    jm = _jax_map(scale_factors)
    N = CAPS.n_feat
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = cam_z
    tgt_uv = np.zeros((N, 2), np.float32)
    tgt_uv[0] = (float(jcam.cx), float(jcam.cy))
    tgt_valid = np.zeros((N,), bool)
    tgt_valid[0] = True
    tgt_desc = np.zeros((N, 8), np.uint32)
    tgt_desc[0] = DESC
    args = (T, np.asarray(jm.pt_valid), tgt_uv, np.full((N,), -1.0, np.float32),
            np.zeros((N,), np.int32), tgt_desc, tgt_valid, np.zeros((N,), bool), scale_factors)
    want = j_search(jm, *(jnp.asarray(a) for a in args), th_radius=1.0, cam=jcam)
    pm = port_map(jax.device_get(jm))
    t = [torch.as_tensor(a) for a in args]
    t[5] = torch.as_tensor(tgt_desc.view(np.int32))
    got = search_local_points(pm, *t, th_radius=1.0, cam=pcam)
    np.testing.assert_array_equal(got.visible_mask.numpy(), np.asarray(want.visible_mask))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    _, closer_ok = _project_points(pm, pm.pt_valid, t[0], pcam, t[8])
    return got, bool(closer_ok[0])


def test_within_1p2_slack_is_visible_and_matched():
    # camera backed up 0.3 m: dist 2.3 <= 1.2 * 2.0
    lm, closer = _both(cam_z=0.3)
    assert bool(lm.visible_mask[0]) and closer
    assert int(lm.assign[0]) == 0


def test_beyond_1p2_slack_is_invisible():
    lm, closer = _both(cam_z=0.6)  # dist 2.6 > 2.4
    assert not bool(lm.visible_mask[0]) and not closer


@pytest.mark.parametrize("cam_z, visible", [(-1.5, True), (-1.6, False)])
def test_below_0p8_min_is_invisible(cam_z, visible):
    # 0.8 * min = 0.8 * 2 / 1.2^7 = 0.447: dist 0.5 inside the band, 0.4 below
    lm, closer = _both(cam_z=cam_z)
    assert bool(lm.visible_mask[0]) == visible == closer
