"""End to end: the port's FusedTracker vs the JAX FusedTracker on the same
frames (the JAX package's SyntheticRGBD, 320x240, 4 levels, 500 features,
seed 11, motion 0.5), plus one-step parity from the JAX tracker's exact state.

Per frame: n_features, n_matches and n_inliers equal, poses within 1e-4. The
two sides share every integer stage bit for bit; the float solver sums in a
different order, so poses agree to f32 rounding (observed ~2e-6).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.datasets.tum import ate_rmse as j_ate_rmse
from vo_slam_test_tpu.datasets.tum import write_trajectory_tum as j_write
from vo_slam_test_tpu.pipeline.tracking import FusedTracker as JFusedTracker
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import ate_rmse, write_trajectory_tum
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker, track_step

W, H = 320, 240
STATE_AFTER = 3  # the one-step test starts from the JAX state after this frame


@pytest.fixture(scope="module")
def run():
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)
    frames = [seq[i] for i in range(len(seq))]
    jt = JFusedTracker(JConfig(**kw))
    state = None
    for i, (g, d, ts) in enumerate(frames):
        jt.track(g, d, ts)
        if i == STATE_AFTER:
            state = convert.dataclass_to_numpy(jt._state)
    j_traj, j_stats = jt.results()
    j_T = [np.asarray(o.T_c_w) for o in jt._outs]

    pt = FusedTracker(SlamConfig(**kw), device="cpu")
    for g, d, ts in frames:
        pt.track(g, d, ts)
    p_traj, p_stats = pt.results()
    p_T = [o.T_c_w.numpy() for o in pt._outs]
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    return dict(seq=seq, frames=frames, cfg=SlamConfig(**kw), jt=jt, state=state,
                j=(j_traj, j_stats, j_T), p=(p_traj, p_stats, p_T), gt=gt, pt=pt)


def test_fused_tracker_matches_jax_per_frame(run):
    j_traj, j_stats, j_T = run["j"]
    p_traj, p_stats, p_T = run["p"]
    assert all(s.ok for s in p_stats) and len(p_stats) == 8
    for i, (a, b) in enumerate(zip(j_stats, p_stats)):
        assert (b.n_features, b.n_matches, b.n_inliers, b.ok) == \
            (a.n_features, a.n_matches, a.n_inliers, a.ok), i
        np.testing.assert_allclose(p_T[i], j_T[i], atol=1e-4, err_msg=f"frame {i}")
    np.testing.assert_allclose(p_traj, j_traj, atol=1e-4)
    ate_p = ate_rmse(run["pt"].timestamps, run["gt"], run["pt"].timestamps, p_traj)
    ate_j = j_ate_rmse(run["jt"].timestamps, run["gt"], run["jt"].timestamps, j_traj)
    assert abs(ate_p - ate_j) < 1e-4 and ate_p < 0.03


def test_one_step_from_jax_state(run):
    """Start the port from the JAX tracker's exact state after frame k and
    compare frame k+1 alone (isolates per-step parity from drift)."""
    pt = FusedTracker(run["cfg"], device="cpu")
    state = convert.track_state_from_numpy(run["state"], "cpu")
    back = convert.track_state_to_numpy(state)
    for k, v in run["state"]["feats"].items():
        np.testing.assert_array_equal(back["feats"][k], v, err_msg=k)
    g, d, _ = run["frames"][STATE_AFTER + 1]
    new_state, out = track_step(
        torch.as_tensor(g), torch.as_tensor(d), state, pt.camera, pt.spec, pt.budgets,
        pt.scale_factors, pt.inv_level_sigma2, pt.fast_hi, pt.fast_lo)
    _, j_stats, j_T = run["j"]
    want = j_stats[STATE_AFTER + 1]
    assert (int(out.n_features), int(out.n_matches), int(out.n_inliers), bool(out.ok)) == \
        (want.n_features, want.n_matches, want.n_inliers, want.ok)
    np.testing.assert_allclose(out.T_c_w.numpy(), j_T[STATE_AFTER + 1], atol=1e-4)
    assert bool(new_state.motion_valid) and new_state.initialized


def test_trajectory_export_matches_jax(run, tmp_path):
    traj = run["p"][0]
    ts = run["pt"].timestamps
    write_trajectory_tum(os.fspath(tmp_path / "port.txt"), ts, traj)
    j_write(os.fspath(tmp_path / "jax.txt"), ts, jnp.asarray(traj))
    port = np.loadtxt(tmp_path / "port.txt")
    ref = np.loadtxt(tmp_path / "jax.txt")
    assert port.shape == (8, 8)
    np.testing.assert_allclose(port, ref, atol=2e-7)
