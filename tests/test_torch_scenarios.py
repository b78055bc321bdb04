"""Twin of tests/test_scenarios.py: the off-nominal scenes of the reference's
TUM sequences (README.md:19-26) through the port's ``SlamSystem(device=
"cpu")`` beside the JAX SlamSystem, at 640x480 with MapCaps(max_kf=32,
max_pt=8192), no vocabulary, local BA on, on the same (JAX-rendered) frames:

- the moving object (fr3_sit_halfsph analogue: a textured patch slides
  across the back wall with consistent depth): the chi^2/Huber gates must
  reject its matches;
- sparse texture (fr3_nstr_tex_near analogue, ``texture_corners=0.06``):
  no frame lost, and the keyframe policy's tracking-weak branch still makes
  keyframes.

Each test asserts the JAX test's own gates on the port's run, the same
keyframe frames as JAX's, and the per-frame matches and inliers within the
f32 band observed between the packages on these sequences: none. Every
count is equal on every frame of both scenes (the 640x480 band documented
elsewhere, 1-3 matches, comes from the pose solver's rounding order; here it
did not show). Before the port's quad-tree cell keys were computed as XLA
compiles the JAX package's (``ops/distribute_device.py``), frame 0 of the
moving object kept another of two equal-response candidates at level 3, and
the counts parted by up to 3 matches and 10 inliers.

``slow``, as the JAX file is: each package runs both 12-frame sequences
(~1 min each on the CPU). The runs are shared by the file (module fixture).
"""

import numpy as np
import pytest

from torch_slam_helpers import assert_scene_parity, scene_runs

pytestmark = pytest.mark.slow  # two SlamSystems over two 640x480 sequences

SEQS = {"moving": dict(n_frames=12, seed=41, motion_scale=0.5, moving_patch=(0.9, 0.06)),
        "sparse": dict(n_frames=12, seed=43, motion_scale=0.4, texture_corners=0.06)}
MATCH_BAND = 0   # observed |port - JAX| per frame, both scenes
INLIER_BAND = 0


@pytest.fixture(scope="module")
def runs():
    return scene_runs(SEQS)


def assert_parity(r):
    assert_scene_parity(r, MATCH_BAND, INLIER_BAND)


class TestDynamicScene:
    def test_moving_object_tracked_and_rejected(self, runs):
        r = runs["moving"]
        assert_parity(r)
        p = r["port"]
        assert all(p["ok"]), p["ok"]
        assert p["ate"] < 0.04, p["ate"]
        # the static world still dominates the inlier set
        assert np.median(p["n_inliers"][1:]) > 80

    def test_moving_object_outliers_actually_culled(self, runs):
        r = runs["moving"]
        assert_parity(r)
        p = r["port"]
        rej = [m - i for m, i in zip(p["n_matches"][1:], p["n_inliers"][1:])]
        assert max(rej) > 20, rej


class TestTexturePoorScene:
    def test_sparse_texture_tracks_without_loss(self, runs):
        r = runs["sparse"]
        assert_parity(r)
        p = r["port"]
        assert all(p["ok"]), p["ok"]
        assert p["ate"] < 0.04, p["ate"]
        assert p["n_keyframes"] >= 1
        # genuinely feature-sparse: median matches well under the budget
        assert np.median(p["n_matches"][1:]) < 600
