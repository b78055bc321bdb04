"""The port's relocalization matchers against the JAX package's on a real
frame pair: search_by_bow_kf_frame (matching/bow_match.py, ratios 0.7 of
trackReferenceKeyFrame and 0.75 of relocalization) and search_by_projection_kf
(matching/matcher.py, the top-ups at radius 10 / threshold 100 and radius 3 /
threshold 60).

Inputs: the JAX front end's features of frames 0 (the keyframe side) and 2
(the frame side) of the room orbit at 320x240 (tests/torch_slam_helpers.py),
a 4-level vocabulary built from both frames (so the featVec buckets split the
keypoints into groups), map-point bindings and liveness drawn from a seed,
and frame 0's keypoints back-projected with their depth into the world. Both
matchers are integer or exact-compare throughout: assign / idx, dist, count
and the per-target source must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.bow import vocabulary as JV
from vo_slam_test_tpu.frontend.extractor import extract_fused as j_extract_fused
from vo_slam_test_tpu.matching import bow_match as j_bow_match
from vo_slam_test_tpu.matching import matcher as jmatcher
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.matching import bow_match, matcher
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from torch_slam_helpers import jax_system, room_kw, room_sequence


@pytest.fixture(scope="module")
def pair():
    seq = room_sequence()
    js = jax_system(seq)
    feats = []
    for i in (0, 2):
        g, d, _ = seq[i]
        feats.append(j_extract_fused(jnp.asarray(g), jnp.asarray(d), js.camera, js.spec,
                                     js.budgets, js.fast_hi, js.fast_lo))
    descs = np.concatenate([np.asarray(f.desc)[np.asarray(f.valid)] for f in feats])
    jvoc = JV.build_vocabulary(descs, k=6, levels=4, seed=3)
    ps = SlamSystem(SlamConfig(**room_kw(seq)), device="cpu")
    return dict(seq=seq, js=js, ps=ps, jf=feats,
                pf=[convert.frame_features_from_numpy(convert.dataclass_to_numpy(f), "cpu")
                    for f in feats],
                jvoc=jvoc, voc=convert.vocabulary_from_jax(jvoc, "cpu"))


def _bindings(n, seed):
    rng = np.random.default_rng(seed)
    mp = np.where(rng.random(n) < 0.8, rng.permutation(n), -1).astype(np.int32)
    return mp, rng.random(n) < 0.9


@pytest.mark.parametrize("ratio", [0.7, 0.75])
def test_search_by_bow_kf_frame_equal_jax(pair, ratio):
    jf0, jf2 = pair["jf"]
    pf0, pf2 = pair["pf"]
    jvoc, voc = pair["jvoc"], pair["voc"]
    n = pf0.valid.shape[0]
    mp, live = _bindings(n, 5)
    jw0 = JV.transform(jvoc, jf0.desc, jf0.valid)
    jw2 = JV.transform(jvoc, jf2.desc, jf2.valid)
    g0 = V.feature_groups(voc, V.transform(voc, pf0.desc, pf0.valid))
    g2 = V.feature_groups(voc, V.transform(voc, pf2.desc, pf2.valid))
    jg0, jg2 = JV.feature_groups(jvoc, jw0), JV.feature_groups(jvoc, jw2)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(jg0))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(jg2))
    assert len(np.unique(g0.numpy()[g0.numpy() >= 0])) > 1  # real buckets
    want = j_bow_match.search_by_bow_kf_frame(
        jf0.desc, jg0, jnp.asarray(mp), jf0.angle, jnp.asarray(live),
        jf2.desc, jg2, jf2.angle, jf2.valid, ratio=ratio)
    got = bow_match.search_by_bow_kf_frame(
        pf0.desc, g0, torch.as_tensor(mp), pf0.angle, torch.as_tensor(live),
        pf2.desc, g2, pf2.angle, pf2.valid, ratio=ratio)
    for name in ("assign", "count", "src_kp"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.count) > 20


@pytest.mark.parametrize("radius,th", [(10.0, 100.0), (3.0, 60.0)])
def test_search_by_projection_kf_equal_jax(pair, radius, th):
    seq, js, ps = pair["seq"], pair["js"], pair["ps"]
    jf0, jf2 = pair["jf"]
    pf0, pf2 = pair["pf"]
    n = pf0.valid.shape[0]
    rng = np.random.default_rng(8)
    # frame 0's keypoints in the world (its pose is the identity frame of
    # the map: T_c_w of frame 0 from the ground truth)
    T0 = np.linalg.inv(seq.poses[0]).astype(np.float32)
    T2 = np.linalg.inv(seq.poses[2]).astype(np.float32)
    uv = np.asarray(jf0.uv_und)
    depth = np.asarray(jf0.depth)
    z = np.where(depth > 0, depth, 1.0)
    pc = np.stack([(uv[:, 0] - seq.cx) * z / seq.fx, (uv[:, 1] - seq.cy) * z / seq.fy, z], -1)
    Tw = np.linalg.inv(T0)
    p_world = (pc @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)
    dist = np.linalg.norm(p_world - Tw[:3, 3], axis=-1)
    sf = np.asarray(js.scale_factors)
    max_d = (dist * sf[np.asarray(jf0.octave)]).astype(np.float32)
    min_d = (max_d / sf[-1]).astype(np.float32)
    src_pt = np.where(rng.random(n) < 0.9, np.arange(n), -1).astype(np.int32)
    src_valid = (src_pt >= 0) & np.asarray(jf0.valid) & (depth > 0)
    blocked = rng.random(n) < 0.1
    # a pose a few millimetres off frame 2's, as a relocalization's would be
    T_in = T2.copy()
    T_in[:3, 3] += np.float32([0.004, -0.003, 0.002])
    j_args = (jnp.asarray(p_world), jf0.desc, jf0.angle, jnp.asarray(min_d), jnp.asarray(max_d),
              jnp.asarray(src_pt), jnp.asarray(src_valid), jf2.uv_und, jf2.angle, jf2.octave,
              jf2.desc, jf2.valid, jnp.asarray(blocked), jnp.asarray(T_in), js.scale_factors)
    cam = js.camera
    want = jmatcher.search_by_projection_kf(*j_args, cam.fx, cam.fy, cam.cx, cam.cy,
                                            float(cam.width), float(cam.height), radius, th)
    pcam = ps.camera
    got = matcher.search_by_projection_kf(
        torch.as_tensor(p_world), pf0.desc, pf0.angle, torch.as_tensor(min_d),
        torch.as_tensor(max_d), torch.as_tensor(src_pt), torch.as_tensor(src_valid),
        pf2.uv_und, pf2.angle, pf2.octave, pf2.desc, pf2.valid, torch.as_tensor(blocked),
        torch.as_tensor(T_in), ps.scale_factors, pcam.fx, pcam.fy, pcam.cx, pcam.cy,
        float(pcam.width), float(pcam.height), radius, th)
    for name in ("idx", "dist", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.count) > 20
