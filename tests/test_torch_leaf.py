"""The leaf functions of otherwise ported modules against the JAX package,
each with the tolerance of the JAX test that uses it:

- ``gaussian.gaussian_kernel_1d`` equal; ``gaussian_blur_7x7`` within 1e-5 of
  JAX's (the same f32 taps and order of sums) and within tests/test_ops.py:
  63's 2e-2 of cv2;
- ``undistort.distort_points`` within 1e-4 px of JAX's, and the round trip of
  tests/test_ops.py:116-122 within 1e-2 px;
- ``orientation.ic_angle_conv``: the moments are integers below 2**24, so its
  angles equal JAX's conv version within 1e-3 deg; against the gather version
  tests/test_extractor.py:84's median < 0.1 deg and max < 1 deg;
- ``Camera.world2pixel`` (round trip of tests/test_foundation.py:83 within
  1e-2 px, JAX's within 1e-3 px), ``u_right`` equal to JAX's with its -1
  sentinel, the grid constants;
- ``hamming.unpack_bits`` equal, ``distance_matrix_mxu`` equal to the numpy
  popcount (tests/test_ops.py TestHamming);
- ``PyramidSpec.inv_scales`` and ``level_valid_mask`` equal,
  ``_resize_linear`` within 1e-4; ``FrameFeatures.n``;
- the flat local-BA ``build_problem`` equal to JAX's on the fabricated map of
  tests/test_local_ba.py (integer fields equal, floats within 1e-6) with
  tests/test_local_ba.py:117's structure.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import camera as jcamera
from vo_slam_test_tpu import config as jconfig
from vo_slam_test_tpu import lie as jlie
from vo_slam_test_tpu.ops import gaussian as jgaussian
from vo_slam_test_tpu.ops import hamming as jhamming
from vo_slam_test_tpu.ops import orientation as jorientation
from vo_slam_test_tpu.ops import pyramid as jpyramid
from vo_slam_test_tpu.ops import undistort as jundistort
from vo_slam_test_tpu.solvers import local_ba as jlba
from vo_slam_test_tpu_torch import camera, config, lie
from vo_slam_test_tpu_torch.frontend.frame import FrameFeatures
from vo_slam_test_tpu_torch.ops import gaussian, hamming, orientation, pyramid, undistort
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import local_ba
from test_local_ba import CAPS, fabricate_map
from torch_slam_helpers import port_map

torch.set_num_threads(1)
FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3
DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633], np.float32)


@pytest.fixture(scope="module")
def gray(synthetic_seq):
    return synthetic_seq[0][0]


def test_gaussian_blur_matches_jax_and_cv2(gray):
    np.testing.assert_array_equal(gaussian.gaussian_kernel_1d(7, 2.0),
                                  jgaussian.gaussian_kernel_1d(7, 2.0))
    img = gray.astype(np.float32)
    got = gaussian.gaussian_blur_7x7(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgaussian.gaussian_blur_7x7(jnp.asarray(img))),
                               rtol=0, atol=1e-5)
    ref = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
    np.testing.assert_allclose(got, ref, atol=2e-2)
    batch = np.stack([img[:100, :120], img[100:200, :120]])
    np.testing.assert_allclose(gaussian.gaussian_blur_7x7(torch.as_tensor(batch)).numpy(),
                               np.asarray(jgaussian.gaussian_blur_7x7(jnp.asarray(batch))),
                               rtol=0, atol=1e-5)


def test_distort_points_round_trip():
    rng = np.random.default_rng(1)
    pts = rng.uniform([100, 100], [540, 380], size=(100, 2)).astype(np.float32)
    dist = torch.as_tensor(DIST)
    und = undistort.undistort_points(torch.as_tensor(pts), FX, FY, CX, CY, dist)
    back = undistort.distort_points(und, FX, FY, CX, CY, dist)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-2)
    want = jundistort.distort_points(jnp.asarray(und.numpy()), FX, FY, CX, CY, jnp.asarray(DIST))
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_ic_angle_conv(gray):
    spec = jpyramid.PyramidSpec(640, 480, 2, 1.2)
    raw = np.array(jpyramid.build_pyramid(jnp.asarray(gray), spec).raw)
    rng = np.random.default_rng(3)
    n = 64
    ys = rng.integers(20, 380, n).astype(np.int32)
    xs = rng.integers(20, 500, n).astype(np.int32)
    lv = rng.integers(0, 2, n).astype(np.int32)
    args = [torch.as_tensor(a) for a in (raw, lv, ys, xs)]
    a_conv = orientation.ic_angle_conv(*args).numpy()
    a_gather = orientation.ic_angle(*args).numpy()
    j_conv = np.asarray(jorientation.ic_angle_conv(*[jnp.asarray(a) for a in (raw, lv, ys, xs)]))

    def ang_diff(a, b):
        d = np.abs(a - b)
        return np.minimum(d, 360 - d)

    assert ang_diff(a_conv, j_conv).max() <= 1e-3
    diff = ang_diff(a_gather, a_conv)
    assert np.median(diff) < 0.1 and diff.max() < 1.0, (np.median(diff), diff.max())
    np.testing.assert_array_equal(orientation._moment_kernels(), jorientation._moment_kernels())


def test_camera_leaves():
    kw = dict(camera_fx=FX, camera_fy=FY, camera_cx=CX, camera_cy=CY, camera_bf=40.0)
    cam = camera.Camera.from_config(config.SlamConfig(**kw), "cpu")
    jcam = jcamera.Camera.from_config(jconfig.SlamConfig(**kw))
    assert (cam.grid_per_pixel_w, cam.grid_per_pixel_h) == (jcam.grid_per_pixel_w,
                                                            jcam.grid_per_pixel_h)
    xi = np.asarray([0.1, -0.2, 0.3, 0.05, -0.02, 0.01], np.float32)
    T = lie.se3_exp(torch.as_tensor(xi))
    rng = np.random.default_rng(1)
    uv = torch.as_tensor(rng.uniform(100, 500, size=(50, 2)).astype(np.float32))
    depth = torch.as_tensor(rng.uniform(1.0, 4.0, size=(50,)).astype(np.float32))
    pw = cam.pixel2world(uv, depth, T)
    uv2 = cam.world2pixel(pw, T)
    np.testing.assert_allclose(uv2.numpy(), uv.numpy(), atol=1e-2)
    want = jcam.world2pixel(jnp.asarray(pw.numpy()), jlie.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(uv2.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    u = np.asarray([100.0, 200.0, 300.0, 50.0], np.float32)
    d = np.asarray([2.0, 0.0, -1.0, 3.5], np.float32)
    ur = cam.u_right(torch.as_tensor(u), torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(ur, np.asarray(jcam.u_right(jnp.asarray(u), jnp.asarray(d))))
    assert ur[0] == pytest.approx(100.0 - 40.0 / 2.0) and ur[1] == ur[2] == -1.0


def test_hamming_leaves():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(96, 8), dtype=np.uint32)
    ta, tb = torch.as_tensor(a.view(np.int32)), torch.as_tensor(b.view(np.int32))
    np.testing.assert_array_equal(hamming.unpack_bits(ta).numpy(),
                                  np.asarray(jhamming.unpack_bits(jnp.asarray(a))))
    ref = np.stack([np.unpackbits((a[i][None] ^ b).view(np.uint8), axis=1).sum(1)
                    for i in range(64)]).astype(np.int32)
    np.testing.assert_array_equal(hamming.distance_matrix_mxu(ta, tb).numpy(), ref)


def test_pyramid_leaves(gray):
    spec, jspec = pyramid.PyramidSpec(640, 480, 8, 1.2), jpyramid.PyramidSpec(640, 480, 8, 1.2)
    np.testing.assert_array_equal(spec.inv_scales, jspec.inv_scales)
    np.testing.assert_array_equal(pyramid.level_valid_mask(spec, 16),
                                  jpyramid.level_valid_mask(jspec, 16))
    img = gray.astype(np.float32)
    for hw in ((400, 533), (123, 77), (480, 640)):
        got = pyramid._resize_linear(torch.as_tensor(img), hw).numpy()
        np.testing.assert_allclose(got, np.asarray(jpyramid._resize_linear(jnp.asarray(img), hw)),
                                   rtol=0, atol=1e-4)
    assert FrameFeatures.empty(torch.device("cpu"), 37).n == 37


def test_flat_build_problem_matches_jax():
    m, *_ = fabricate_map()
    jp = jax.device_get(jax.jit(jlba.build_problem, static_argnums=(2,))(
        m, jnp.asarray(5, jnp.int32), CAPS))
    caps = MapCaps(CAPS.max_kf, CAPS.max_pt, CAPS.max_obs, CAPS.n_feat)
    pm = port_map(jax.device_get(m))
    pp = local_ba.build_problem(pm, 5, caps)
    for f in jlba.BAProblem._fields:
        want = np.asarray(getattr(jp, f))
        got = getattr(pp, f).numpy()
        assert got.shape == want.shape, f
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    # tests/test_local_ba.py:117's structure
    kf_ids = pp.kf_ids.numpy()
    assert kf_ids[0] == 5 and (kf_ids[:6] >= 0).sum() == 6
    assert int(pp.o_valid.sum()) > 1000
    expect = len({p for row in pm.kf_mp.numpy()[:6] for p in row if p >= 0})
    assert int((pp.pt_ids >= 0).sum()) == expect
