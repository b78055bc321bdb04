"""Port ORB front end vs the JAX package, on a SyntheticRGBD frame rendered by
the JAX package (320x240, 4 levels).

Tolerances: the pyramid, blur, FAST scores, CellCandidates and the quad-tree
keep masks are integer or exact-in-f32 stages and must be bit-identical.
Angles within 1e-3 deg and at most 2 flipped descriptor bits: cos/sin of the
angle may differ by an ulp between the two libraries, which can move a
rotated sample across a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.frontend.extractor import extract_fused as j_extract_fused
from vo_slam_test_tpu.ops import brief as jbrief
from vo_slam_test_tpu.ops import fast as jfast
from vo_slam_test_tpu.ops import orientation as jorientation
from vo_slam_test_tpu.ops import undistort as jundistort
from vo_slam_test_tpu.ops.distribute_device import distribute_level as j_distribute_level
from vo_slam_test_tpu.ops.fast_pallas import fast_score_nms_pallas
from vo_slam_test_tpu.ops.gaussian import gaussian_blur_7x7_u8 as j_blur
from vo_slam_test_tpu.ops.orb_pallas import orb_angle_desc_pallas
from vo_slam_test_tpu.ops.pyramid import PyramidSpec as JSpec
from vo_slam_test_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from vo_slam_test_tpu.ops.pyramid import interior as j_interior
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.frontend.extractor import extract_fused, select_keypoints
from vo_slam_test_tpu_torch.ops import brief, fast, orb_cuda, orientation, undistort
from vo_slam_test_tpu_torch.ops.distribute_device import distribute_level
from vo_slam_test_tpu_torch.ops.gaussian import gaussian_blur_7x7_u8
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior

W, H, LEVELS = 320, 240, 4
j_build_pyramid = jax.jit(j_build_pyramid, static_argnums=1)  # eager op-by-op is slow


def t(a):
    return torch.as_tensor(np.array(a))


def flips(a, b):
    x = (np.asarray(a).astype(np.uint32) ^ np.asarray(b).astype(np.uint32)).view(np.uint8)
    return np.unpackbits(x, axis=1).sum(1)


def ang_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 360 - d).max()


@pytest.fixture(scope="module")
def frame():
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    return seq, seq[0]


@pytest.fixture(scope="module")
def pyramids(frame):
    _, (gray, _, _) = frame
    jspec, spec = JSpec(W, H, LEVELS, 1.2), PyramidSpec(W, H, LEVELS, 1.2)
    jp = j_build_pyramid(jnp.asarray(gray), jspec)
    pp = build_pyramid(torch.as_tensor(gray), spec)
    return jspec, spec, jp, pp


def test_spec_tables_equal():
    jspec, spec = JSpec(640, 480, 8, 1.2), PyramidSpec(640, 480, 8, 1.2)
    assert jspec.sizes == spec.sizes and jspec.canvas_hw == spec.canvas_hw
    assert jspec.budget(1000) == spec.budget(1000)
    np.testing.assert_array_equal(jspec.inv_level_sigma2, spec.inv_level_sigma2)


def test_blur_bit_identical():
    img = np.random.default_rng(0).integers(0, 256, (37, 53)).astype(np.float32)
    np.testing.assert_array_equal(gaussian_blur_7x7_u8(t(img)).numpy(),
                                  np.asarray(j_blur(jnp.asarray(img))))


@pytest.mark.parametrize("canvas", ["raw", "blur"])
def test_pyramid_bit_identical(pyramids, canvas):
    _, _, jp, pp = pyramids
    np.testing.assert_array_equal(getattr(pp, canvas).numpy(), np.asarray(getattr(jp, canvas)))


def test_fast_scores_bit_identical(pyramids):
    jspec, spec, jp, pp = pyramids
    want = np.asarray(jax.jit(jfast.fast_score)(j_interior(jp.raw, jspec)))
    np.testing.assert_array_equal(fast.fast_score(interior(pp.raw, spec)).numpy(), want)


def test_plain_fast_vs_pallas_interpret(frame):
    _, (gray, _, _) = frame
    levels = np.stack([gray, gray[::-1]]).astype(np.float32)  # [2, 240, 320]
    ours = fast.fast_score(t(levels)).numpy()
    theirs = np.asarray(fast_score_nms_pallas(jnp.asarray(levels), interpret=True, with_nms=False))
    b = 5  # the Pallas kernel zero-pads rows; both wrap columns
    np.testing.assert_array_equal(ours[:, b:-b, b:-b], theirs[:, b:-b, b:-b])


def test_cell_candidates_bit_identical(pyramids):
    jspec, spec, jp, pp = pyramids
    want = jfast.detect_pyramid(j_interior(jp.raw, jspec), jspec, 20.0, 7.0, 8)
    got = fast.detect_pyramid(interior(pp.raw, spec), spec, 20.0, 7.0, 8)
    for name in ("ys", "xs", "response", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_distribute_level_keep_identical(pyramids):
    jspec, spec, jp, pp = pyramids
    cands = fast.detect_pyramid(interior(pp.raw, spec), spec, 20.0, 7.0, 8)
    budgets = spec.budget(500)
    b = float(fast.DETECT_BORDER)
    for lvl in range(LEVELS):
        h, w = spec.sizes[lvl]
        args = [getattr(cands, k)[lvl].reshape(-1) for k in ("xs", "ys", "response", "valid")]
        n_ini = max(int(round((w - 2 * b) / (h - 2 * b))), 1)
        bounds = (b, w - b, b, h - b)
        got = distribute_level(*args, bounds, budgets[lvl], n_ini=n_ini).numpy()
        want = np.asarray(j_distribute_level(*[jnp.asarray(a.numpy()) for a in args], bounds,
                                             budgets[lvl], n_ini=n_ini))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() <= budgets[lvl]


def test_angles_and_descriptors(pyramids):
    jspec, spec, jp, pp = pyramids
    sel = select_keypoints(pp, spec, spec.budget(500))
    lv, ys, xs = (jnp.asarray(a.numpy()) for a in (sel.level, sel.ys, sel.xs))
    ang_ref = jorientation.ic_angle(jp.raw, lv, ys, xs)
    desc_ref = np.asarray(jbrief.compute_descriptors(jp.blur, lv, ys, xs, ang_ref))
    ang, desc = orb_cuda.orb_angle_desc(pp.raw, pp.blur, sel.level, sel.ys, sel.xs)
    assert ang_err(ang.numpy(), ang_ref) <= 1e-3
    assert flips(desc.numpy(), desc_ref).max() <= 2
    # the plain functions by name, as the wrapper calls them on the CPU
    np.testing.assert_array_equal(
        orientation.ic_angle(pp.raw, sel.level, sel.ys, sel.xs).numpy(), ang.numpy())
    np.testing.assert_array_equal(
        brief.compute_descriptors(pp.blur, sel.level, sel.ys, sel.xs, ang).numpy(), desc.numpy())


def test_orb_vs_pallas_interpret(frame):
    _, (gray, _, _) = frame
    jspec, spec = JSpec(W, H, 2, 1.2), PyramidSpec(W, H, 2, 1.2)
    jp = j_build_pyramid(jnp.asarray(gray), jspec)
    pp = build_pyramid(torch.as_tensor(gray), spec)
    rng = np.random.default_rng(5)
    n = 64
    ys = rng.integers(16, 180, n).astype(np.int32)
    xs = rng.integers(16, 250, n).astype(np.int32)
    lv = rng.integers(0, 2, n).astype(np.int32)
    ang_ref, desc_ref = orb_angle_desc_pallas(jp.raw, jp.blur, jnp.asarray(lv), jnp.asarray(ys),
                                              jnp.asarray(xs), interpret=True)
    ang, desc = orb_cuda.orb_angle_desc(pp.raw, pp.blur, t(lv), t(ys), t(xs))
    assert ang_err(ang.numpy(), ang_ref) <= 1e-3
    assert flips(desc.numpy(), desc_ref).max() <= 2


def test_undistort_matches_jax():
    cfg = JConfig()
    dist = np.array([cfg.camera_k1, cfg.camera_k2, cfg.camera_p1, cfg.camera_p2, cfg.camera_k3],
                    np.float32)
    uv = np.random.default_rng(2).uniform([0, 0], [640, 480], (500, 2)).astype(np.float32)
    k = [np.float32(v) for v in (cfg.camera_fx, cfg.camera_fy, cfg.camera_cx, cfg.camera_cy)]
    want = np.asarray(jundistort.undistort_points(jnp.asarray(uv), *k, jnp.asarray(dist)))
    got = undistort.undistort_points(t(uv), *[t(v) for v in k], t(dist)).numpy()
    # 10 f32 fixed-point iterations on both sides; agreement to ~1e-4 px
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("distorted", [False, True])
def test_extract_fused_matches_jax(frame, distorted):
    seq, (gray, depth, _) = frame
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_width=W, camera_height=H)
    if not distorted:
        kw.update(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    jspec, spec = JSpec(W, H, LEVELS, 1.2), PyramidSpec(W, H, LEVELS, 1.2)
    budgets = spec.budget(500)
    want = j_extract_fused(jnp.asarray(gray), jnp.asarray(depth), JCamera.from_config(JConfig(**kw)),
                           jspec, budgets, 20.0, 7.0)
    cam = Camera.from_config(SlamConfig(**kw), device="cpu")
    got = extract_fused(torch.as_tensor(gray), torch.as_tensor(depth), cam, spec, budgets, 20.0, 7.0)
    for name in ("uv", "response", "octave", "depth", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    tol = dict(atol=2e-4) if distorted else dict(atol=0, rtol=0)
    np.testing.assert_allclose(got.uv_und.numpy(), np.asarray(want.uv_und), **tol)
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right), **tol)
    assert ang_err(got.angle.numpy(), want.angle) <= 1e-3
    assert flips(got.desc.numpy(), want.desc).max() <= 2
    assert int(got.valid.sum()) == 500
