"""The port's SlamSystem(vocabulary=...) run free over the 320x240 kidnap
(tests/torch_slam_helpers.py::kidnap_small) against the session's JAX run of
the same frames (jax_kidnap_run; loop closing on in both, closing no loop),
and the vocabulary options of SlamSystem, loop closing among them.

The free run holds ok, relocalized, the keyframe events, the relocalization
frames and the match counts equal. Frame 1's local BA rounds in another order
(its LM decisions are rounding-sensitive, ROADMAP queue 3), so the runs' poses
differ by ~1e-5 from frame 2 on, which moves one observation across the chi2
gate at frame 4 (372 against 371 inliers with one PyTorch thread; that frame's
pose 0.45 mm apart). So the free run holds inlier counts within 1 and poses
within 1e-3; tests/test_torch_reloc.py holds every count of every frame
exactly, each step from the JAX system's state."""

import numpy as np
import pytest
import torch

from vo_slam_test_tpu_torch.bow import vocabulary as V
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
from vo_slam_test_tpu_torch.pipeline.system import DESC_ARCHIVE_CAP, SlamSystem
from torch_slam_helpers import P_CAPS, jax_kidnap_run, kidnap_small, per_frame_rows

FREE_RUN_POSE_TOL = 1e-3


@pytest.fixture(scope="module")
def small():
    k = kidnap_small()
    k["voc"] = V.build_vocabulary(k["descs"], k=8, levels=3, seed=2, device="cpu")
    return k


def port(small, **kw):
    return SlamSystem(SlamConfig(**small["kw"]), caps=P_CAPS, device="cpu", **kw)


def test_kidnap_free_run_matches_jax(small, tmp_path_factory):
    ps = port(small, vocabulary=small["voc"])
    for g, d, ts in small["frames"]:
        ps.track(g, d, ts)
    jr = jax_kidnap_run(tmp_path_factory)
    assert jr["loop_closures"] == []
    for i, (p, j) in enumerate(zip(per_frame_rows(ps._outs), jr["rows"])):
        assert (p["ok"], p["relocalized"], p["made_kf"], p["n_features"], p["n_matches"]) == \
            (j["ok"], j["relocalized"], j["made_kf"], j["n_features"], j["n_matches"]), (i, p, j)
        assert abs(p["n_inliers"] - j["n_inliers"]) <= 1, (i, p, j)
        if j["ok"]:
            np.testing.assert_allclose(p["T"], j["T"], atol=FREE_RUN_POSE_TOL, err_msg=f"frame {i}")
    assert ps.reloc_frames == jr["reloc_frames"] == [11]
    assert ps.loop_closures == [] and ps.loop_attempts == []
    traj, stats, _ = ps.results()
    # tests/test_reloc.py's gauge: the relocalized pose against frame 2's
    assert np.linalg.norm(traj[11][:3, 3] - traj[2][:3, 3]) < 0.05


@pytest.mark.parametrize("chunk", [1, 2])
def test_loop_closing_runs_by_default(small, chunk, monkeypatch):
    """With a vocabulary, loop closing is on (the JAX package's default):
    per frame and with chunk=2, detect_step runs on every keyframe event and
    nowhere else, and a confirmed candidate's Sim3 attempt lands in
    loop_attempts and loop_gates. The kidnap's first keyframes are too few to
    confirm one, so the second event's detection is handed keyframe 0 as a
    confirmed candidate: its attempt fails the >= 10 keyframe gap (a gate
    value), and the map equals that of a run without it."""
    from vo_slam_test_tpu_torch.pipeline import loop_closing

    orig = loop_closing.detect_step
    calls = []

    def forced(m, ls, did_kf, kf_id, caps):
        ls, cands, gens = orig(m, ls, did_kf, kf_id, caps)
        calls.append((did_kf, kf_id))
        if kf_id == 1:
            cands = torch.tensor([0] + [-1] * (loop_closing.MAX_CANDS - 1), dtype=torch.int32)
            gens = torch.where(cands >= 0, m.kf_gen[0], -1)
        return ls, cands, gens

    plain = port(small, vocabulary=small["voc"], chunk=chunk)
    for g, d, ts in small["frames"][:2]:
        plain.track(g, d, ts)
    monkeypatch.setattr(loop_closing, "detect_step", forced)
    ps = port(small, vocabulary=small["voc"], chunk=chunk)
    assert ps.enable_loop_closing and not ps.enable_global_ba
    for g, d, ts in small["frames"][:2]:
        ps.track(g, d, ts)
    ps.results()
    plain.results()
    kf_frames = [i for i, o in enumerate(ps._outs) if o.made_kf]
    assert kf_frames[:2] == [0, 1] and calls == [(True, i) for i in range(len(kf_frames))]
    assert ps.loop_attempts == [(1, -1, False)] and ps.loop_closures == []
    (frame, cand, accepted, gates), = ps.loop_gates
    assert (frame, cand, accepted, gates["gap_ok"], gates["gen_ok"]) == (1, 0, False, 0, 1)
    assert gates["n_bow"] > 20 and gates["kf_seq"] == 1
    for f in ps.map.__dataclass_fields__:
        assert torch.equal(getattr(ps.map, f), getattr(plain.map, f)), f


def test_no_vocabulary_never_relocalizes(small):
    """tests/test_reloc.py::test_no_bow_system_never_relocalizes at 320x240
    (its scene, seed 33, four frames): no vocabulary, no loop closing, no
    relocalization, and every flag a device bool."""
    seq = SyntheticRGBD(n_frames=4, seed=33, motion_scale=0.3, width=320, height=240,
                        fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5, cy=255.3 * 0.5)
    ps = SlamSystem(SlamConfig(**dict(small["kw"], camera_fx=seq.fx)), caps=P_CAPS, device="cpu")
    assert not ps.use_bow and not ps.enable_loop_closing and ps.loop_attempts == []
    for i in range(4):
        ps.track(*seq[i])
    assert ps.reloc_frames == []
    assert all(isinstance(o.relocalized, torch.Tensor) and o.reloc_winner is None
               for o in ps._outs)


def test_create_vocabulary_reads_lost_frames(small):
    """The lost black frames add nothing (no descriptor); a lost textured
    frame of another scene adds its descriptors (map.cpp:79-83)."""
    ps = port(small, vocabulary=small["voc"])
    for g, d, ts in small["frames"][:2] + small["frames"][8:9]:
        ps.track(g, d, ts)
    kf_descs, lost = ps._vocabulary_descriptors()
    assert not bool(ps._outs[-1].ok)
    assert len(kf_descs) == ps.n_keyframes and lost == []
    other = SyntheticRGBD(n_frames=2, seed=77, motion_scale=2.5, width=320, height=240,
                          fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5, cy=255.3 * 0.5)
    ps.track(*other[1])
    assert not bool(ps._outs[-1].ok)
    kf_descs, lost = ps._vocabulary_descriptors()
    assert len(lost) == 1 and lost[0].shape[0] > 100 and lost[0].dtype == np.uint32
    voc = ps.create_vocabulary(k=6, levels=2)
    assert voc.n_words == 36 and voc.device.type == "cpu"
    assert len(ps._frame_desc) == 4 <= DESC_ARCHIVE_CAP
