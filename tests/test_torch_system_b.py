"""Twin of tests/test_system.py (Milestone B end to end: tracking, mapping
and local BA on synthetic data): the port's ``SlamSystem(device="cpu")``
beside the JAX SlamSystem at 640x480 with MapCaps(max_kf=32, max_pt=8192),
no vocabulary, on the same (JAX-rendered) frames.

Each test asserts the JAX test's own gates on the port's run, the same
keyframe frames as JAX's, and the per-frame matches and inliers within the
f32 band observed between the packages here: one match on one frame
(SyntheticRGBD(n_frames=10, seed=21, motion_scale=0.5), frame 7: 424
against 423; from JAX's own state and map just before frame 7 the port
gives JAX's 423 and 531 exactly, so the difference is accumulated f32
rounding), inliers equal; on the export sequence (n_frames=6, seed=22,
motion_scale=0.3) every count is equal. That sequence loses tracking from
frame 2 on in both packages alike (its per-frame motion scales with
1/n_frames), which the JAX test does not gate on; the twin asserts the
agreement, not tracking.

``slow``, as the JAX file is (~1 min per package and sequence on the CPU).
The runs are shared by the file (module fixture).
"""

import numpy as np
import pytest

from torch_slam_helpers import assert_scene_parity, scene_runs

pytestmark = pytest.mark.slow  # two SlamSystems over two 640x480 sequences

SEQS = {"b": dict(n_frames=10, seed=21, motion_scale=0.5),
        "export": dict(n_frames=6, seed=22, motion_scale=0.3)}
MATCH_BAND = 1   # observed |port - JAX| per frame
INLIER_BAND = 0


@pytest.fixture(scope="module")
def runs():
    return scene_runs(SEQS)


def assert_parity(r):
    assert_scene_parity(r, MATCH_BAND, INLIER_BAND)


class TestSlamSystem:
    def test_tracks_and_maps(self, runs):
        r = runs["b"]
        assert_parity(r)
        p = r["port"]
        assert all(p["ok"]), p["ok"]
        assert p["n_keyframes"] >= 1
        assert p["n_points"] > 300
        assert p["ate"] < 0.02, p["ate"]
        # observed-map inliers should dominate once the map exists
        assert np.median(p["n_inliers"][1:]) > 100
        assert (p["n_keyframes"], p["n_points"]) == (r["jax"]["n_keyframes"], r["jax"]["n_points"])

    def test_keyframe_trajectory_exported(self, runs):
        r = runs["export"]
        assert_parity(r)
        p = r["port"]
        assert p["n_kf_traj"] == p["n_keyframes"] == r["jax"]["n_keyframes"]
        assert p["kf_traj_first"].shape == (4, 4)
        np.testing.assert_allclose(p["kf_traj_first"], r["jax"]["kf_traj_first"], atol=1e-5)
