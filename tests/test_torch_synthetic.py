"""The port's room scene and room-orbit trajectory against the JAX
renderer's: the trajectory is numpy on both sides and the scene's textures
come from the same seeded draws, so poses, gray and depth must be equal."""

import numpy as np
import pytest

from vo_slam_test_tpu.datasets import synthetic as jsynthetic
from vo_slam_test_tpu_torch.datasets import synthetic

KW = dict(width=160, height=120, fx=517.3 * 0.25, fy=516.5 * 0.25, cx=318.6 * 0.25,
          cy=255.3 * 0.25, scene="room", seed=7)


@pytest.mark.parametrize("n,loops", [(240, 1.5), (60, 1.0)])
def test_room_orbit_trajectory_matches_jax(n, loops):
    np.testing.assert_array_equal(synthetic.room_orbit_trajectory(n, loops=loops),
                                  jsynthetic.room_orbit_trajectory(n, loops=loops))


def test_room_scene_renders_jax_pixels():
    traj = jsynthetic.room_orbit_trajectory(240, loops=1.5)
    js = jsynthetic.SyntheticRGBD(trajectory=traj, **KW)
    ps = synthetic.SyntheticRGBD(trajectory=synthetic.room_orbit_trajectory(240, loops=1.5), **KW)
    assert ps.n_frames == js.n_frames == 240
    np.testing.assert_array_equal(ps.poses, js.poses)
    for i in (0, 7, 39, 180):
        (gj, dj, tj), (gp, dp, tp) = js[i], ps[i]
        assert tj == tp
        np.testing.assert_array_equal(gp, gj)
        np.testing.assert_array_equal(dp, dj)
        assert (dp > 0).all()  # a closed room: every ray hits a wall


def test_unknown_scene_raises():
    with pytest.raises(ValueError, match="unknown scene"):
        synthetic.SyntheticRGBD(scene="garden")
