"""Slow twins of tests/test_loop_e2e.py and tests/test_churn.py: the pan loop
through the port's SlamSystem and the JAX package's on the CPU, compared.

The pan loop (tests/test_loop_e2e.py::pan_trajectory, SyntheticRGBD(seed=41),
640x480, camera_fps=3, chunk=4) with the vocabulary build_vocabulary(k=8,
levels=3, seed=3) of the port's extract_fused descriptors (both packages read
it from one .npz; the reference test builds it with the host OrbExtractor,
not ported):

- the drift of tests/test_loop_e2e.py injected by each package's
  inject_drift (the JAX package's one-sided sever): both track the same
  frames and close the same loops (none: the frame-36 keyframe's local BA
  pulls the island back first, ROADMAP queue 3), with the same Sim3 attempts;
- main path 5's drift (inject_drift, then chip_smoke.pan_sever_old): both
  reject a Sim3 attempt at frame 36, close one loop (JAX at frame 40) and
  track within 5 cm of each other after alignment to the ground truth (each
  closure moves the whole map by its own correction). Their maps part at
  the frame-36 event's local BA, whose LM path follows f32 rounding
  (perf/local_ba_sensitivity.py), so the closing frame, the winner and the
  island's later course may differ; stepped from the JAX package's own state at each
  keyframe event from frame 40 on, the port reproduces its closure, winner
  and island residual (within 1 mm), the frame-48 event that moves the
  JAX package's island 0.66 m included (ROADMAP queue 3);
- MapCaps(max_kf=14) without drift (tests/test_churn.py): the port meets that
  test's asserts (cap exceeded, slots recycled, finite trajectory) and tracks
  the frames JAX tracks; its map invariants (no live binding to an erased
  point, every observer bound back) are held against JAX's map, which on this
  run keeps one live binding to an erased point (ROADMAP queue 3).

Trajectories are held to each other, not to ATE < 8 cm (ROADMAP queue 3):
every frame both track within 5 cm of JAX's position and the ATEs within
1 cm (local BA's LM decisions follow f32 rounding, so the runs drift apart
by millimetres over 60 frames). ~10 minutes each on the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.utils.drift import inject_drift as j_inject_drift
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.datasets import ate_rmse
from vo_slam_test_tpu_torch.pipeline import loop_closing
from vo_slam_test_tpu_torch.pipeline import system as psystem
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.utils.drift import inject_drift

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.slow  # as tests/test_loop_e2e.py and tests/test_churn.py
POS_TOL = 0.05
ATE_TOL = 0.01
# stepped from the JAX package's state: local BA's LM decisions follow f32
# rounding (a 2-iteration pass against a 10-iteration one at frame 40)
STEP_POSE_TOL = 1e-2
STEP_RESIDUAL_TOL = 1e-3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    seq, cfg = cs.pan_sequence()
    voc = cs.pan_vocabulary(seq, cfg, "cpu")
    path = tmp_path_factory.mktemp("voc") / "pan_voc.npz"
    voc.save(str(path))
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")})
    return dict(seq=seq, cfg=cfg, voc=voc, jcfg=jcfg, jvoc=JVocabulary.load(str(path)),
                frames=[seq[i] for i in range(len(seq))],
                gt=np.stack([seq.poses[i] for i in range(len(seq))]))


def _aligned(xyz, gt_xyz):
    """Positions [F,3] after the rigid (Horn) alignment to the ground truth
    that ate_rmse applies."""
    mx, my = xyz.mean(0), gt_xyz.mean(0)
    U, _, Vt = np.linalg.svd((gt_xyz - my).T @ (xyz - mx))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return (xyz - mx) @ (U @ S @ Vt).T + my


def _run_both(scene, max_kf, drift, sever=False, record_from=None):
    """Both packages over the pan loop in lock step (the drift after frame
    PAN_DRIFT_FRAME; ``sever``: then chip_smoke.pan_sever_old); frames
    tracked equal, positions within POS_TOL (``sever``: after each run's
    alignment to the ground truth), ATEs within ATE_TOL.
    ``record_from``: the JAX package's background_chunk calls from that
    frame on, their inputs and output map as numpy -> js, ps, the port's
    trajectory and oks, the records, the JAX package's (pre-drift poses,
    pre-drift valid, kf_cut)."""
    js = JSlamSystem(scene["jcfg"], caps=JMapCaps(max_kf=max_kf, max_pt=8192),
                     vocabulary=scene["jvoc"], chunk=cs.PAN_CHUNK)
    ps = SlamSystem(scene["cfg"], caps=MapCaps(max_kf=max_kf, max_pt=8192), device="cpu",
                    vocabulary=scene["voc"], chunk=cs.PAN_CHUNK)
    D = cs.pan_drift()
    calls, island = [], None
    orig = jsystem.background_chunk

    def recording(m, ls, did_kf, kf_id, interrupt_ba, *a, **k):
        rec = None
        if record_from is not None and js._frame_id >= record_from:
            rec = dict(m=jax.device_get(m), ls=jax.device_get(ls),
                       did=[bool(x) for x in np.asarray(did_kf)],
                       kf_id=np.asarray(kf_id).tolist(), stop=bool(np.asarray(interrupt_ba)),
                       bgd=int(np.asarray(a[0])))
        out = orig(m, ls, did_kf, kf_id, interrupt_ba, *a, **k)
        if rec is not None:
            rec.update(m_out=jax.device_get(out[0]), packed=np.asarray(out[6]).tolist())
            calls.append(rec)
        return out

    jsystem.background_chunk = recording
    try:
        for i, (g, d, ts) in enumerate(scene["frames"]):
            js.track(g, d, ts)
            ps.track(g, d, ts)
            if drift and i == cs.PAN_CUT_FRAME:
                cuts = (max(int(np.asarray(js.map.n_kf)), 1), max(int(ps.map.n_kf), 1))
            if drift and i == cs.PAN_DRIFT_FRAME:
                island = (np.asarray(js.map.kf_pose).copy(), np.asarray(js.map.kf_valid).copy(),
                          cuts[0])
                js.map, ar = j_inject_drift(js.map, js.state.assign_real,
                                            jnp.asarray(cuts[0], jnp.int32), jnp.asarray(D))
                js.state = js.state.replace(assign_real=ar)
                ps.map, ps.state.assign_real = inject_drift(ps.map, ps.state.assign_real,
                                                            cuts[1], torch.as_tensor(D))
                if sever:
                    js.map = js.map.replace(**{k: jnp.asarray(v) for k, v in
                                               cs.pan_sever_old(js.map, cuts[0]).items()})
                    ps.map = ps.map.replace(**{k: torch.as_tensor(v) for k, v in
                                               cs.pan_sever_old(ps.map, cuts[1]).items()})
        j_traj, j_stats, _ = js.results()
        p_traj, p_stats, _ = ps.results()
    finally:
        jsystem.background_chunk = orig
    j_ok = np.array([s.ok for s in j_stats])
    p_ok = np.array([s.ok for s in p_stats])
    np.testing.assert_array_equal(p_ok, j_ok)
    both = p_ok & j_ok
    p_xyz, j_xyz = np.stack(p_traj)[both][:, :3, 3], np.stack(j_traj)[both][:, :3, 3]
    if sever:  # a closure moves the whole map rigidly, by its own correction in each run
        gt_xyz = scene["gt"][both][:, :3, 3]
        p_xyz, j_xyz = _aligned(p_xyz, gt_xyz), _aligned(j_xyz, gt_xyz)
    gap = np.linalg.norm(p_xyz - j_xyz, axis=1)
    assert gap.max() < POS_TOL, gap.max()
    ts = ps.timestamps
    p_ate = ate_rmse(ts, scene["gt"], ts, p_traj)
    j_ate = ate_rmse(ts, scene["gt"], ts, j_traj)
    assert abs(p_ate - j_ate) < ATE_TOL, (p_ate, j_ate)
    return js, ps, p_traj, p_ok, calls, island


def test_pan_loop_matches_jax(scene):
    js, ps, _, p_ok, _, _ = _run_both(scene, 32, drift=True)
    assert p_ok.sum() > 0.9 * len(p_ok)
    assert ps.loop_closures == js.loop_closures
    assert ps.loop_attempts == [tuple(a) for a in js.loop_attempts]


def test_pan_loop_two_sided_sever_against_jax(scene):
    js, ps, _, p_ok, calls, (pre, pre_valid, kf_cut) = _run_both(
        scene, 32, drift=True, sever=True, record_from=40)
    assert p_ok.sum() > 0.9 * len(p_ok)
    # the whole runs: the first attempt (frame 36, rejected) and one closure
    # each; where the port's closure falls follows its map's rounding since
    # frame 36 (frame 40 on candidate 7 with 4 intra-op threads,
    # perf/loop_path5_split.py --port-run; frame 52 in this test's process)
    assert js.loop_closures == [40] and len(ps.loop_closures) == 1, (js.loop_closures,
                                                                      ps.loop_closures)
    assert ps.loop_attempts[0] == tuple(js.loop_attempts[0]) == (36, -1, False)
    events = [rec for rec in calls if any(rec["did"])]
    assert events and events[0]["did"][0]  # the closing event at frame 40 comes first
    for rec in events:
        kids = [int(k) if d else -1 for d, k in zip(rec["did"], rec["kf_id"])]
        m, _, outs = psystem.background_chunk(
            convert.map_state_from_numpy(convert.dataclass_to_numpy(rec["m"]), "cpu"),
            loop_closing.LoopState(**{k: torch.as_tensor(np.array(getattr(rec["ls"], k)))
                                      for k in ("groups", "counts", "n_groups", "last_loop_seq")}),
            rec["did"], kids, rec["stop"], ps.caps, ps.camera, ps.scale_factors, True,
            rec["bgd"])
        got = [(int(o.closed), o.which, int(o.attempted)) for o, d in zip(outs, rec["did"]) if d]
        want = [tuple(r[:3]) for r, d in zip(rec["packed"], rec["did"]) if d]
        assert got == want, (rec["kf_id"], got, want)
        kv = np.asarray(rec["m_out"].kf_valid)
        np.testing.assert_array_equal(m.kf_valid.numpy(), kv)
        j_pose = np.asarray(rec["m_out"].kf_pose)
        np.testing.assert_allclose(m.kf_pose.numpy()[kv], j_pose[kv], atol=STEP_POSE_TOL)
        np.testing.assert_allclose(cs.island_residual(pre, pre_valid, kf_cut, m.kf_pose.numpy()),
                                   cs.island_residual(pre, pre_valid, kf_cut, j_pose),
                                   atol=STEP_RESIDUAL_TOL)


def test_pan_under_tight_kf_cap(scene):
    js, ps, p_traj, p_ok, _, _ = _run_both(scene, 14, drift=False)
    assert p_ok.sum() >= 0.9 * len(p_ok)
    m = ps.map
    ever, live = int(m.n_kf_ever), int(m.kf_valid.sum())
    assert ever > 14 and live <= 14, (ever, live)
    assert (m.kf_gen > 1).sum() > 0, m.kf_gen.tolist()
    assert (ever, live) == (int(np.asarray(js.map.n_kf_ever)),
                            int(np.asarray(js.map.kf_valid).sum()))
    assert np.isfinite(np.stack(p_traj)[p_ok]).all()
    # tests/test_churn.py's map invariants, held against JAX's map: on this run
    # both packages keep the same few live bindings to erased points (from the
    # frame-27 keyframe event on; a reference fault, ROADMAP queue 3)
    port = [a.numpy() for a in (m.kf_mp, m.pt_valid, m.kf_valid, m.pt_obs_kf, m.pt_obs_kp)]
    jax_ = [np.asarray(a) for a in (js.map.kf_mp, js.map.pt_valid, js.map.kf_valid,
                                    js.map.pt_obs_kf, js.map.pt_obs_kp)]
    np.testing.assert_array_equal(_dead_bindings(*port[:3]), _dead_bindings(*jax_[:3]))
    assert _unbound_observers(*port) == _unbound_observers(*jax_)


def _dead_bindings(kf_mp, pt_valid, kf_valid):
    """(keyframe, keypoint) pairs of live keyframes bound to an erased point."""
    bad = (kf_mp >= 0) & kf_valid[:, None] & ~pt_valid[np.maximum(kf_mp, 0)]
    return np.argwhere(bad)


def _unbound_observers(kf_mp, pt_valid, kf_valid, obs_kf, obs_kp):
    """(point, keyframe, keypoint) observer entries of the first 300 live
    points that their live keyframe does not bind back."""
    out = []
    for p in np.nonzero(pt_valid)[0][:300]:
        for kf, kp in zip(obs_kf[p], obs_kp[p]):
            if kf >= 0 and kf_valid[kf] and kf_mp[kf, kp] != p:
                out.append((int(p), int(kf), int(kp)))
    return out
