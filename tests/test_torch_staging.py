"""The port's benchmark staging (``datasets/staging.py``): the frame cache
round trip and its fingerprint, and the scene vocabulary against the JAX
package's (the same host-path descriptors into the same k-means: centroids,
idf and node validity equal) and its cache. The cache directory is a test
temporary directory."""

import numpy as np
import pytest

from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import staging as jstaging
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD, staging

W, H = 320, 240


def small_seq(seed=11):
    return SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                         cy=255.3 * 0.5, n_frames=8, seed=seed, motion_scale=0.5)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(staging, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jstaging, "CACHE_DIR", str(tmp_path / "jax"))
    (tmp_path / "jax").mkdir()
    return tmp_path


def test_render_all_caches_frames(cache):
    seq = small_seq()
    grays, depths, times = staging.render_all(seq, 3, "t")
    files = list(cache.glob("pilot_frames_t_3_*.npz"))
    assert len(files) == 1
    for i in range(3):
        g, d, t = seq[i]
        np.testing.assert_array_equal(grays[i], g)
        np.testing.assert_array_equal(depths[i], d)
        assert times[i] == t
    again = staging.render_all(seq, 3, "t")  # from the cache
    for a, b in zip(again[0] + again[1], grays + depths):
        np.testing.assert_array_equal(a, b)
    assert again[2] == times


def test_fingerprint_follows_the_scene():
    fp = staging._scene_fingerprint
    assert fp(small_seq()) == fp(small_seq())
    assert fp(small_seq(seed=12)) != fp(small_seq())
    moved = small_seq()
    moved.poses = moved.poses.copy()
    moved.poses[3, 0, 3] += 0.01  # a trajectory change under an unchanged tag
    assert fp(moved) != fp(small_seq())


def test_scene_vocabulary_equal_jax(cache):
    seq = small_seq()
    grays, depths, _ = staging.render_all(seq, 5, "v")
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H)
    voc = staging.scene_vocabulary(SlamConfig(**kw), grays, depths, "v", k=4, levels=2,
                                   device="cpu")
    jvoc = jstaging.scene_vocabulary(JConfig(**kw), grays, depths, "v", k=4, levels=2)
    got = voc.to_numpy()
    assert (voc.k, voc.levels) == (jvoc.k, jvoc.levels) == (4, 2)
    for c, jc in zip(got["centroids"], jvoc.centroids):
        np.testing.assert_array_equal(c, np.asarray(jc))
    for v, jv in zip(got["node_valid"], jvoc.node_valid):
        np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(got["idf"], np.asarray(jvoc.idf))
    assert len(list(cache.glob("pilot_voc_v_4_2_*.npz"))) == 1
    cached = staging.scene_vocabulary(SlamConfig(**kw), grays, depths, "v", k=4, levels=2,
                                      device="cpu")
    np.testing.assert_array_equal(cached.to_numpy()["idf"], got["idf"])
