"""Relocalization end to end: the port's SlamSystem(vocabulary=...) against
the JAX package's on the reference's kidnap scenario (tests/test_reloc.py):
frames 0-7 of SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3) build the
map, three black frames lose tracking, frames 2-5 return to a mapped view.

Fast tier: the kidnap at 320x240 (4 levels, 500 features, MapCaps(max_kf=16,
max_pt=4096)) with a vocabulary built by both packages from frames 0-2's
descriptors (the same numpy k-means, checked equal). The JAX run is the
session's one (tests/torch_slam_helpers.py::jax_kidnap_run), with loop closing
on, as tests/test_reloc.py leaves it, and so is the port's; neither closes a
loop (the kidnap keeps fewer than MIN_KF_GAP keyframes). Frame by frame, each
port step starts from the JAX system's exact state and map before that frame
(tracking, the fallback chain, the keyframe insert and the mapping chain):
ok, relocalized, the feature, match and inlier counts and the keyframe
decision equal, the pose within FLOAT_TOL (both sides round in f32 but sum in
another order), and the map after the step against JAX's: integer fields
equal, float fields within FLOAT_TOL. tests/test_torch_reloc_run.py runs the
port free over the same frames. A lost textured frame with no BoW candidate
(every keyframe's BoW vector cleared) evaluates the slot top_k returns first,
as the JAX package does: the same BoW match count, flags and pose.

Slow tier (-m slow): twins of tests/test_reloc.py's cases at 640x480 with the
vocabulary built once in JAX (OrbExtractor, as that file builds it) and
converted; each compares the relocalization frames and the relocalized poses
with the JAX run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.bow import vocabulary as JV
from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.frontend.extractor import OrbExtractor
from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from torch_slam_helpers import (FLOAT_TOL, J_CAPS, P_CAPS, assert_maps_agree, jax_kidnap_run,
                                kidnap_frames, kidnap_small, per_frame_rows)

@pytest.fixture(scope="module")
def small():
    k = kidnap_small()
    k["voc"] = V.build_vocabulary(k["descs"], k=8, levels=3, seed=2, device="cpu")
    k["jvoc"] = JV.build_vocabulary(k["descs"], k=8, levels=3, seed=2)
    return k


def test_small_vocabularies_equal(small):
    for c, jc in zip(small["voc"].centroids, small["jvoc"].centroids):
        np.testing.assert_array_equal(c.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(small["voc"].idf.numpy(), np.asarray(small["jvoc"].idf))


KEYS = ("ok", "relocalized", "n_features", "n_matches", "n_inliers", "made_kf")


def test_kidnap_step_by_step_matches_jax(small, tmp_path_factory):
    jr = jax_kidnap_run(tmp_path_factory)
    assert jr["loop_closures"] == []
    rows, pre = jr["rows"], jr["pre"]
    # the scenario itself (tests/test_reloc.py's asserts)
    oks = [r["ok"] for r in rows]
    assert all(oks[:8]) and not any(oks[8:11]) and any(oks[11:]), oks
    assert jr["reloc_frames"] and jr["reloc_frames"][0] >= 11
    for k, (g, d, ts) in enumerate(small["frames"]):
        ps = SlamSystem(SlamConfig(**small["kw"]), caps=P_CAPS, device="cpu",
                        vocabulary=small["voc"])
        if k:
            ps.state = convert.slam_track_state_from_numpy(pre[k][0], "cpu")
            ps.map = convert.map_state_from_numpy(pre[k][1], "cpu")
        ps.track(g, d, ts)
        p, j = per_frame_rows(ps._outs)[0], rows[k]
        assert tuple(p[x] for x in KEYS) == tuple(j[x] for x in KEYS), (k, p, j)
        if j["ok"]:
            np.testing.assert_allclose(p["T"], j["T"], err_msg=f"frame {k}", **FLOAT_TOL)
        after = pre[k + 1][1] if k + 1 < len(pre) else jr["post"]
        assert_maps_agree(ps.map, after, f"map after frame {k}")
        assert ps.loop_closures == []
        if j["relocalized"]:
            ps.results()  # folds the device winner
            slot, n_bow, n_ransac, n_obs = ps._outs[0].reloc_winner
            assert n_bow >= 15 and n_ransac >= 10 and n_obs >= 50


def _jax_state(d):
    """A SlamTrackState numpy dict -> the JAX package's SlamTrackState."""
    from vo_slam_test_tpu.frontend.frame import FrameFeatures as JFrameFeatures
    from vo_slam_test_tpu.pipeline.system import SlamTrackState as JSlamTrackState

    return JSlamTrackState(**{k: JFrameFeatures(**{f: jnp.asarray(a) for f, a in v.items()})
                              if k == "feats" else jnp.asarray(v) for k, v in d.items()})


def test_no_candidate_reports_jax_bow_count(small, tmp_path_factory):
    """Frame 9's state (lost after the first black frame) with every
    keyframe's BoW vector cleared: a textured frame has features but no BoW
    candidate, so both packages evaluate the slot top_k returns first and
    report its BoW matches as the frame's match count, with ok false."""
    from vo_slam_test_tpu.slam_map.map_state import MapState as JMapState

    jr = jax_kidnap_run(tmp_path_factory)
    st, mp = jr["pre"][9]
    mp = dict(mp, kf_bow_word=np.full_like(mp["kf_bow_word"], 1 << 30),
              kf_bow_weight=np.zeros_like(mp["kf_bow_weight"]))
    assert bool(st["lost"])
    g, d, _ = small["seq"][3]
    js = JSlamSystem(JConfig(**small["kw"]), caps=J_CAPS, vocabulary=small["jvoc"])
    js.state = _jax_state(st)
    js.map = JMapState(**{k: jnp.asarray(v) for k, v in mp.items()})
    js.track(g, d, 9.5)
    ps = SlamSystem(SlamConfig(**small["kw"]), caps=P_CAPS, device="cpu", vocabulary=small["voc"])
    ps.state = convert.slam_track_state_from_numpy(st, "cpu")
    ps.map = convert.map_state_from_numpy(mp, "cpu")
    ps.track(g, d, 9.5)
    p, j = per_frame_rows(ps._outs)[0], per_frame_rows(js._outs)[0]
    assert tuple(p[x] for x in KEYS) == tuple(j[x] for x in KEYS), (p, j)
    assert not p["ok"] and not p["relocalized"] and p["n_features"] > 100 and p["n_matches"] > 0
    ps.results()  # folds the device winner
    assert ps._outs[0].reloc_winner is None
    np.testing.assert_allclose(p["T"], j["T"], **FLOAT_TOL)


# ---------------------------------------------------------------------------
# slow tier: tests/test_reloc.py's cases at 640x480, compared with JAX
# ---------------------------------------------------------------------------


def full_kw(seq):
    return dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)


@pytest.fixture(scope="module")
def scene_voc():
    """tests/test_reloc.py's vocabulary: OrbExtractor descriptors of frames
    0-2, build_vocabulary(k=8, levels=3, seed=2), in JAX."""
    seq = SyntheticRGBD(n_frames=3, seed=31, motion_scale=0.3)
    ext = OrbExtractor(JCamera.from_config(JConfig(**full_kw(seq))), n_features=1000)
    descs = []
    for i in range(3):
        g, d, _ = seq[i]
        f = ext(g, d)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    jvoc = JV.build_vocabulary(np.concatenate(descs), k=8, levels=3, seed=2)
    return jvoc, convert.vocabulary_from_jax(jvoc, "cpu")


def run_full(scene_voc, frames, parity=False, before_return=None):
    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    kw = full_kw(seq)
    jvoc, voc = scene_voc
    js = JSlamSystem(JConfig(**kw), caps=JMapCaps(max_kf=32, max_pt=8192), vocabulary=jvoc,
                     reloc_parity=parity)
    ps = SlamSystem(SlamConfig(**kw), caps=MapCaps(max_kf=32, max_pt=8192), device="cpu",
                    vocabulary=voc, reloc_parity=parity)
    for k, (g, d, ts) in enumerate(frames):
        if k == 11 and before_return is not None:
            before_return(js, ps)
        js.track(g, d, ts)
        ps.track(g, d, ts)
    j_traj, j_stats, _ = js.results()
    p_traj, p_stats, _ = ps.results()
    assert js.loop_closures == [] == ps.loop_closures
    return js, ps, j_traj, p_traj, [s.ok for s in p_stats]


def assert_relocalized_like_jax(js, ps, j_traj, p_traj, oks, first=None):
    assert ps.reloc_frames == js.reloc_frames
    assert any(oks[11:]) and ps.reloc_frames and ps.reloc_frames[0] >= 11, (oks, ps.reloc_frames)
    if first is not None:
        assert ps.reloc_frames[0] == first
    first_ok = 11 + oks[11:].index(True)
    rel = np.linalg.norm(p_traj[first_ok][:3, 3] - p_traj[first_ok - 9][:3, 3])
    assert rel < 0.05, rel
    for f in ps.reloc_frames:
        np.testing.assert_allclose(p_traj[f], j_traj[f], atol=1e-3)


@pytest.mark.slow
def test_kidnap_recovery(scene_voc):
    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    js, ps, j_traj, p_traj, oks = run_full(scene_voc, kidnap_frames(seq))
    assert all(oks[:8]) and not any(oks[8:11])
    assert_relocalized_like_jax(js, ps, j_traj, p_traj, oks)


@pytest.mark.slow
def test_kidnap_recovery_depth_poor(scene_voc):
    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    js, ps, j_traj, p_traj, oks = run_full(scene_voc, kidnap_frames(seq, depth_poor=True))
    assert_relocalized_like_jax(js, ps, j_traj, p_traj, oks)


@pytest.mark.slow
def test_kidnap_recovery_decoy_best_candidate(scene_voc):
    """A decoy keyframe carries the first return frame's exact BoW vector (it
    ranks first) but random descriptors and no map point; relocalization
    still succeeds at frame 11 through the genuine keyframe."""
    from vo_slam_test_tpu.bow import retrieval as j_ret
    from vo_slam_test_tpu_torch.bow import retrieval

    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    jvoc, voc = scene_voc
    ext = OrbExtractor(JCamera.from_config(JConfig(**full_kw(seq))), n_features=1000)
    g2, d2, _ = seq[2]
    f2 = ext(g2, d2)
    uniq, wgt = j_ret.bow_vector(JV.transform(jvoc, f2.desc, f2.valid), jvoc.idf)
    def plant(js, ps):
        decoy = np.random.default_rng(5).integers(0, 2**32, size=(js.map.kf_desc.shape[1], 8),
                                                  dtype=np.uint32)
        slot = int(np.asarray(js.map.n_kf))
        assert slot == int(ps.map.n_kf)
        m = js.map
        js.map = m.replace(kf_valid=m.kf_valid.at[slot].set(True),
                           kf_bow_word=m.kf_bow_word.at[slot].set(uniq),
                           kf_bow_weight=m.kf_bow_weight.at[slot].set(wgt),
                           kf_desc=m.kf_desc.at[slot].set(jnp.asarray(decoy)),
                           kf_kp_valid=m.kf_kp_valid.at[slot].set(True))
        p = ps.map
        p = p.replace(kf_valid=p.kf_valid.clone(), kf_bow_word=p.kf_bow_word.clone(),
                      kf_bow_weight=p.kf_bow_weight.clone(), kf_desc=p.kf_desc.clone(),
                      kf_kp_valid=p.kf_kp_valid.clone())
        p.kf_valid[slot] = True
        p.kf_bow_word[slot] = torch.as_tensor(np.asarray(uniq))
        p.kf_bow_weight[slot] = torch.as_tensor(np.asarray(wgt))
        p.kf_desc[slot] = torch.as_tensor(decoy.view(np.int32))
        p.kf_kp_valid[slot] = True
        ps.map = p
        assert retrieval.PAD_WORD == int(j_ret.PAD_WORD)

    js, ps, j_traj, p_traj, oks = run_full(scene_voc, kidnap_frames(seq), before_return=plant)
    assert_relocalized_like_jax(js, ps, j_traj, p_traj, oks, first=11)


@pytest.mark.slow
def test_reloc_parity_mode_same_trigger_frame(scene_voc):
    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3)
    first = {}
    for parity in (False, True):
        js, ps, j_traj, p_traj, oks = run_full(scene_voc, kidnap_frames(seq), parity=parity)
        assert_relocalized_like_jax(js, ps, j_traj, p_traj, oks)
        first[parity] = ps.reloc_frames[0]
    assert first[False] == first[True], first


@pytest.mark.slow
def test_vocabulary_includes_lost_frame_descriptors():
    """tests/test_reloc.py's case on the port: a textured frame of another
    scene is lost, and its descriptors reach create_vocabulary."""
    seq = SyntheticRGBD(n_frames=4, seed=33, motion_scale=0.3)
    ps = SlamSystem(SlamConfig(**full_kw(seq)), caps=MapCaps(max_kf=16, max_pt=4096),
                    device="cpu")
    for i in range(3):
        ps.track(*seq[i])
    g2, d2, _ = SyntheticRGBD(n_frames=2, seed=77, motion_scale=2.5)[1]
    ps.track(g2, d2, 99.0)
    _, stats, _ = ps.results()
    assert not stats[3].ok
    kf_descs, lost_descs = ps._vocabulary_descriptors()
    assert len(lost_descs) >= 1 and sum(d.shape[0] for d in lost_descs) > 100
    assert ps.create_vocabulary(k=6, levels=2) is not None
