"""The benchmark's frozen renderer against the port's numpy renderer on a few
small frames of each scene: the same textures from the same seed, the same
trajectories and the same grey levels and depths."""

import numpy as np
import pytest

from slambench import scene
from vo_slam_test_tpu_torch.datasets.synthetic import SyntheticRGBD, room_orbit_trajectory

CAM = scene.Camera(160, 120, 517.3 / 4, 516.5 / 4, 318.6 / 4, 255.3 / 4)


def _port(kind, seed, poses=None):
    kw = dict(width=CAM.width, height=CAM.height, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
              seed=seed)
    if kind == "room":
        return SyntheticRGBD(trajectory=poses, scene="room", **kw)
    return SyntheticRGBD(n_frames=40, motion_scale=0.4, **kw)


def test_trajectories_match_the_port():
    assert np.array_equal(scene.room_orbit(240, 1.5), room_orbit_trajectory(240, 1.5))
    ours = scene.corner_trajectory(40, 0.4)
    assert np.abs(ours - _port("corner", 0).poses).max() < 1e-6
    # the corner trajectory is one period: the last frame repeats the first
    assert np.abs(ours[39] - ours[0]).max() < 1e-6


@pytest.mark.parametrize("kind,seed", [("room", 7), ("room", 2**31 + 5), ("corner", 0)])
def test_frames_match_the_port(kind, seed):
    poses = scene.room_orbit(240, 1.5) if kind == "room" else None
    port = _port(kind, seed, poses)
    idx = [0, 17, 39] if kind == "corner" else [0, 80, 161, 239]
    gray, depth = scene.render(scene.scene_planes(kind, seed), port.poses[idx], CAM, "cpu")
    assert gray.dtype.is_floating_point is False and gray.shape == (len(idx), 120, 160)
    for k, i in enumerate(idx):
        g, d, _ = port[i]
        assert np.abs(gray[k].numpy().astype(int) - g.astype(int)).max() <= 1
        assert (gray[k].numpy() != g).mean() < 1e-3
        assert np.allclose(depth[k].numpy(), d, rtol=1e-6, atol=1e-6)


def test_seed_changes_the_textures_only():
    a, b = scene.scene_planes("room", 1), scene.scene_planes("room", 2)
    assert a.planes == b.planes and a.bounds == b.bounds
    assert not np.array_equal(a.textures, b.textures)
    assert np.array_equal(a.textures, scene.scene_planes("room", 1).textures)
