"""The port's host-path ``OrbExtractor`` (stage A on the device, one host read
of the candidates, the host quad-tree, stage B) against the JAX package's, on
frames 0 and 5 of the JAX package's ``SyntheticRGBD(seed=11)`` at 320x240, 4
levels, 500 features.

Tolerances: the candidates, the host quad-tree's selection (levels, x, y,
responses, validity), uv, octave, depth and the descriptors must be equal;
angles within 1e-3 deg (cos/sin may differ by an ulp between the
libraries); uv_und and u_right equal without distortion and within 2e-4 px
with it (10 f32 fixed-point undistortion iterations on both sides), the
tolerances of ``tests/test_torch_frontend.py``. Then the twins of
``tests/test_extractor.py::TestExtractorEndToEnd`` at 640x480.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.frontend.extractor import OrbExtractor as JOrbExtractor
from vo_slam_test_tpu.frontend.extractor import _stage_a as j_stage_a
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.frontend.extractor import OrbExtractor
from vo_slam_test_tpu_torch.ops import hamming

W, H = 320, 240
FRAMES = (0, 5)


def ang_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 360 - d).max()


@pytest.fixture(scope="module")
def seq():
    return SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                         cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)


def extractors(seq, distorted):
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_width=W, camera_height=H)
    if not distorted:
        kw.update(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    je = JOrbExtractor(JCamera.from_config(JConfig(**kw)), n_features=500, n_levels=4)
    pe = OrbExtractor(Camera.from_config(SlamConfig(**kw), device="cpu"), n_features=500,
                      n_levels=4)
    return je, pe


@pytest.mark.parametrize("i", FRAMES)
def test_candidates_and_selection_equal_jax(seq, i):
    je, pe = extractors(seq, False)
    gray, _, _ = seq[i]
    _, jc = j_stage_a(jnp.asarray(gray), je.spec, je.fast_hi, je.fast_lo, je.cell_top_k)
    jc = jax.device_get(jc)
    _, pc = pe.candidates(gray)
    for name in ("ys", "xs", "response", "valid"):
        np.testing.assert_array_equal(getattr(pc, name), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    got, want = pe._distribute(pc), je._distribute(jc)
    for name, g, w in zip(("level", "y", "x", "response", "valid"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    assert 0 < got[4].sum() <= 500 + 2 * 4


@pytest.mark.parametrize("distorted", [False, True])
@pytest.mark.parametrize("i", FRAMES)
def test_features_equal_jax(seq, i, distorted):
    je, pe = extractors(seq, distorted)
    gray, depth, _ = seq[i]
    want = je(gray, depth)
    got = pe(gray, depth)
    for name in ("uv", "response", "octave", "depth", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.desc.numpy().view(np.uint32), np.asarray(want.desc))
    tol = dict(atol=2e-4) if distorted else dict(atol=0, rtol=0)
    np.testing.assert_allclose(got.uv_und.numpy(), np.asarray(want.uv_und), **tol)
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right), **tol)
    assert ang_err(got.angle.numpy(), want.angle) <= 1e-3


@pytest.fixture(scope="module")
def full_width():
    """The JAX package's conftest ``synthetic_seq`` (640x480, seed 3) and the
    fr1-width extractor of ``tests/test_extractor.py``."""
    s = SyntheticRGBD(n_frames=8, seed=3)
    cfg = SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    cam = Camera.from_config(cfg, device="cpu")
    return s, cam, OrbExtractor(cam, n_features=1000)


def test_synthetic_frame(full_width):
    s, cam, ext = full_width
    gray, depth, _ = s[0]
    feats = ext(gray, depth)
    v = feats.valid.numpy()
    n = int(v.sum())
    assert 700 <= n <= 1024, n
    uv = feats.uv.numpy()[v]
    assert uv[:, 0].min() >= 0 and uv[:, 0].max() < 640
    # spatial spread: keypoints cover at least half the 8x8 coarse grid
    assert len(set(map(tuple, (uv // 80).astype(int)))) >= 32
    assert len(set(feats.octave.numpy()[v])) >= 6  # all levels represented
    d = feats.depth.numpy()[v]
    assert (d > 0).mean() > 0.9  # dense synthetic depth
    ur = feats.u_right.numpy()[v]
    uu = feats.uv_und.numpy()[v][:, 0]
    ok = d > 0
    np.testing.assert_allclose(ur[ok], uu[ok] - float(cam.bf) / d[ok], atol=1e-3)
    desc = feats.desc.numpy()[v]
    assert len({tuple(r) for r in desc[:200]}) > 190  # descriptors are diverse


def test_matching_across_frames(full_width):
    """Consecutive frames give many low-distance mutual matches."""
    s, _, ext = full_width
    f0 = ext(*s[0][:2])
    f1 = ext(*s[1][:2])
    D = hamming.distance_matrix(f0.desc, f1.desc).numpy().astype(np.float32)
    v0, v1 = f0.valid.numpy(), f1.valid.numpy()
    D[~v0] = 1e9
    D[:, ~v1] = 1e9
    best01 = D.argmin(1)
    best10 = D.argmin(0)
    mutual = [i for i in range(len(best01))
              if v0[i] and best10[best01[i]] == i and D[i, best01[i]] < 50]
    assert len(mutual) > 300, len(mutual)


def test_runs_where_its_camera_is():
    cam = Camera.from_config(SlamConfig(camera_width=W, camera_height=H), device="cpu")
    ext = OrbExtractor(cam, n_features=500, n_levels=4)
    f = ext(np.zeros((H, W), np.uint8), np.zeros((H, W), np.float32))
    assert f.desc.device.type == "cpu" and int(f.valid.sum()) == 0
    assert torch.equal(f.depth, torch.full_like(f.depth, -1.0))
