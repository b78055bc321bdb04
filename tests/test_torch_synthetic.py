"""The port's scenes and trajectories against the JAX renderer's: the room
scene, the room orbit and the pan-return trajectory, the texture density and
the moving patch. Trajectories are numpy on both sides and the textures come
from the same seeded draws, so poses, gray and depth must be equal."""

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


@pytest.mark.parametrize("n,kw", [(60, {}), (37, dict(recede=1.8, yaw_max=1.2, z0=1.1))])
def test_pan_return_trajectory_matches_jax(n, kw):
    got = synthetic.pan_return_trajectory(n, **kw)
    np.testing.assert_array_equal(got, jsynthetic.pan_return_trajectory(n, **kw))
    assert got.shape == (n, 4, 4) and got.dtype == np.float32


@pytest.mark.parametrize("scene,tc,patch", [
    ("corner", 0.03, None),              # texture-poor (fr3_nstr_tex_near analogue)
    ("corner", 1.0, (0.6, 0.04)),        # a moving object on the back wall
    ("room", 0.5, (0.5, 0.03)),          # the patch on the room's far wall
])
def test_texture_and_moving_patch_render_jax_pixels(scene, tc, patch):
    kw = dict(KW, scene=scene, seed=5, texture_corners=tc, moving_patch=patch)
    traj = (jsynthetic.pan_return_trajectory(30) if scene == "room"
            else jsynthetic.SyntheticRGBD(n_frames=30, seed=5).poses)
    js = jsynthetic.SyntheticRGBD(trajectory=traj, **kw)
    ps = synthetic.SyntheticRGBD(trajectory=traj, **kw)
    for i in (0, 9, 29):
        (gj, dj, tj), (gp, dp, tp) = js[i], ps[i]
        assert tj == tp
        np.testing.assert_array_equal(gp, gj)
        np.testing.assert_array_equal(dp, dj)
    if patch is not None:
        # the patch is in view at frame 0: the frame differs from the scene's
        np.testing.assert_array_equal(ps.tex_patch, js.tex_patch)
        plain = synthetic.SyntheticRGBD(trajectory=traj, **dict(kw, moving_patch=None))
        assert (plain[0][0] != ps[0][0]).any()
