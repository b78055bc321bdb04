"""Port matching vs the JAX package: popcount/Hamming, the masked top-2 plain
version (exactly equal to masked_top2_xla and to the Pallas kernel in
interpret mode), the rotation filter, and search_by_projection_frame on a
real frame pair. All integer or exact-compare stages: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.frontend.extractor import extract_fused as j_extract_fused
from vo_slam_test_tpu.matching import matcher as jmatcher
from vo_slam_test_tpu.matching import rotation as jrotation
from vo_slam_test_tpu.ops import hamming as jhamming
from vo_slam_test_tpu.ops import match_pallas as jmp
from vo_slam_test_tpu.ops.pyramid import PyramidSpec as JSpec
from vo_slam_test_tpu.pipeline.tracking import _spawn_temp_points as j_spawn
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.matching import matcher, rotation
from vo_slam_test_tpu_torch.ops import hamming, match_cuda, match_pallas
from vo_slam_test_tpu_torch.pipeline.tracking import _spawn_temp_points

NAMES = ("best_i", "best_d", "second_i", "second_d")


def random_instance(seed, M, N, stereo=True):
    """numpy arrays in the JAX argument order; descriptors uint32, with
    duplicated target descriptors (ties) and 16 rows with nothing allowed."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(M, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(N, 8), dtype=np.uint32)
    b[1::3] = b[0::3][: len(b[1::3])]
    a[5] = b[7]                                 # an exact match (distance 0)
    row_ok = rng.random(M) < 0.85
    row_ok[:16] = False
    lo = rng.integers(-1, 4, M).astype(np.int32)
    rur = rng.uniform(5, 120, M) if stereo else np.full(M, np.inf)
    return [
        a, b,
        rng.uniform(0, 640, M).astype(np.float32), rng.uniform(0, 480, M).astype(np.float32),
        rng.uniform(0.5, 120, M).astype(np.float32), rng.uniform(-10, 640, M).astype(np.float32),
        rur.astype(np.float32), lo, (lo + rng.integers(0, 3, M)).astype(np.int32), row_ok,
        rng.uniform(0, 640, N).astype(np.float32), rng.uniform(0, 480, N).astype(np.float32),
        np.where(rng.random(N) < 0.4, -1.0, rng.uniform(0, 640, N)).astype(np.float32),
        rng.integers(0, 8, N).astype(np.int32), rng.random(N) < 0.9,
    ]


def to_port(args):
    out = [torch.as_tensor(np.ascontiguousarray(args[0]).view(np.int32)),
           torch.as_tensor(np.ascontiguousarray(args[1]).view(np.int32))]
    return out + [torch.as_tensor(np.array(x)) for x in args[2:]]


def test_popcount_and_distance_matrix():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(40, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(33, 8), dtype=np.uint32)
    a[0] = 0xFFFFFFFF
    b[0] = 0
    ta, tb = torch.as_tensor(a.view(np.int32)), torch.as_tensor(b.view(np.int32))
    want = np.asarray(jhamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(hamming.distance_matrix(ta, tb).numpy(), want)
    assert want[0, 0] == 256
    # the batched form (refresh_points: every observer pair of each point)
    got = hamming.distance_matrix(ta.reshape(5, 8, 8), ta.reshape(5, 8, 8)).numpy()
    for s in range(5):
        np.testing.assert_array_equal(got[s], np.asarray(jhamming.distance_matrix(
            jnp.asarray(a[8 * s:8 * s + 8]), jnp.asarray(a[8 * s:8 * s + 8]))))


@pytest.mark.parametrize("seed,stereo", [(0, True), (1, False), (2, True)])
def test_top2_plain_equals_xla_and_pallas(seed, stereo):
    args = random_instance(seed, 256, 256, stereo)
    jargs = [jnp.asarray(x) for x in args]
    want = jmp.masked_top2_xla(*jargs)
    pallas = jmp.masked_top2_pallas(*jargs, interpret=True)
    got = match_cuda.masked_top2(*to_port(args))   # CPU tensors: the plain version
    for g, w, p, name in zip(got, want, pallas, NAMES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), err_msg=name)
    assert (got[1][:16] == match_pallas.BIG).all() and (got[0][:16] == 0).all()
    assert (got[3][:16] == match_pallas.BIG).all() and (got[2][:16] == 0).all()


def test_top2_single_allowed_and_ties():
    # row 0: exactly one allowed column (7); rows 1..: all columns allowed
    # with identical descriptors, so every distance ties
    M, N = 128, 128
    args = random_instance(3, M, N)
    args[0][:] = 0
    args[1][:] = 0
    args[4][:] = 1e6                     # window radius: everything
    args[6][:] = np.inf
    args[7][:], args[8][:] = 0, 8
    args[9][:] = True
    args[14][:] = True
    args[12][:] = -1.0
    args[4][0] = 0.5
    args[2][0], args[3][0] = args[10][7], args[11][7]
    args[10][(np.abs(args[10] - args[10][7]) < 0.5) & (np.arange(N) != 7)] += 2.0
    jargs = [jnp.asarray(x) for x in args]
    want = jmp.masked_top2_xla(*jargs)
    got = match_pallas.masked_top2_plain(*to_port(args))
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0][0] == 7 and got[2][0] == 0 and got[3][0] == match_pallas.BIG
    assert (got[0][1:] == 0).all() and (got[2][1:] == 1).all()


def test_rotation_filter_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 360, 700).astype(np.float32)
    b = (a - rng.choice([0.0, 12.0, 24.0, 180.0], 700, p=[0.7, 0.15, 0.1, 0.05])
         + rng.normal(0, 2, 700)).astype(np.float32) % 360
    matched = rng.random(700) < 0.8
    bins_j = jrotation.rotation_bins(jnp.asarray(a), jnp.asarray(b))
    bins_p = rotation.rotation_bins(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(bins_p.numpy(), np.asarray(bins_j))
    np.testing.assert_array_equal(
        rotation.rotation_consistency_mask(bins_p, torch.as_tensor(matched)).numpy(),
        np.asarray(jrotation.rotation_consistency_mask(bins_j, jnp.asarray(matched))))


@pytest.mark.parametrize("radius", [15.0, 30.0])
def test_search_by_projection_frame_matches_jax(radius):
    W, H = 320, 240
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H)
    jcam = JCamera.from_config(JConfig(**kw))
    cam = Camera.from_config(SlamConfig(**kw), device="cpu")
    spec = JSpec(W, H, 4, 1.2)
    feats = [j_extract_fused(jnp.asarray(g), jnp.asarray(d), jcam, spec, spec.budget(500), 20.0, 7.0)
             for g, d, _ in (seq[0], seq[1])]
    T_last = np.eye(4, dtype=np.float32)
    T_pred = np.asarray(seq.gt_T_c_w(1), np.float32) @ np.asarray(seq.poses[0], np.float32)
    pts_j, ok_j = j_spawn(feats[0], jnp.asarray(T_last), jcam)
    last, curr = (convert.frame_features_from_numpy(convert.dataclass_to_numpy(f), "cpu")
                  for f in feats)
    pts, ok = _spawn_temp_points(last, torch.as_tensor(T_last), cam)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_j), rtol=1e-6, atol=1e-6)

    f0, f1 = feats
    want = jmatcher.search_by_projection_frame(
        pts_j, f0.desc, f0.octave, f0.angle, ok_j, f1.uv_und, f1.u_right, f1.octave, f1.angle,
        f1.desc, f1.valid, jnp.zeros_like(f1.valid), jnp.asarray(T_pred), jnp.asarray(T_last),
        jnp.asarray(spec.scales), jcam.fx, jcam.fy, jcam.cx, jcam.cy, jcam.bf, jcam.b,
        width=float(W), height=float(H), radius=radius)
    got = matcher.search_by_projection_frame(
        torch.as_tensor(np.asarray(pts_j)), last.desc, last.octave, last.angle, ok,
        curr.uv_und, curr.u_right, curr.octave, curr.angle, curr.desc, curr.valid,
        torch.zeros_like(curr.valid), torch.as_tensor(T_pred), torch.as_tensor(T_last),
        torch.as_tensor(spec.scales), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.b,
        width=float(W), height=float(H), radius=radius)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert int(got.count) == int(want.count) > 100
