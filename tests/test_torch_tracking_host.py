"""The port's host-synchronous ``FrameToFrameTracker`` against the JAX
package's over the same frames (the JAX package's ``SyntheticRGBD``, 320x240,
4 levels, 500 features, seed 11, motion 0.5).

Per frame n_features, n_matches, n_inliers and ok must be equal and the poses
within 1e-4 (the tolerance of ``tests/test_torch_tracking.py``: every integer
stage is shared bit for bit, the float solver sums in another order). The
640x480 twin of ``tests/test_tracking.py::TestFrameToFrame`` is slow, as that
file is.
"""

import numpy as np
import pytest

from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.pipeline.tracking import FrameToFrameTracker as JFrameToFrameTracker
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import ate_rmse
from vo_slam_test_tpu_torch.pipeline.tracking import FrameToFrameTracker, TrackStats

W, H = 320, 240


def small_cfg_kw(seq):
    return dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)


@pytest.fixture(scope="module")
def run():
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    kw = small_cfg_kw(seq)
    frames = [seq[i] for i in range(len(seq))]
    jt = JFrameToFrameTracker(JConfig(**kw))
    pt = FrameToFrameTracker(SlamConfig(**kw), device="cpu")
    j_stats = [jt.track(*f) for f in frames]
    p_stats = [pt.track(*f) for f in frames]
    return dict(seq=seq, jt=jt, pt=pt, j_stats=j_stats, p_stats=p_stats)


def test_counts_equal_jax(run):
    got = [(s.n_features, s.n_matches, s.n_inliers, s.ok) for s in run["p_stats"]]
    want = [(s.n_features, s.n_matches, s.n_inliers, s.ok) for s in run["j_stats"]]
    assert got == want
    assert all(ok for *_, ok in got)
    assert all(isinstance(s, TrackStats) for s in run["p_stats"])


def test_poses_within_1e4(run):
    np.testing.assert_allclose(np.stack(run["pt"].trajectory), np.stack(run["jt"].trajectory),
                               atol=1e-4)
    assert run["pt"].trajectory[0].dtype == np.float32


def test_attributes_as_jax(run):
    pt, jt = run["pt"], run["jt"]
    assert pt.timestamps == jt.timestamps
    assert pt.states == jt.states
    assert pt.stats == run["p_stats"]
    assert pt.motion_valid == jt.motion_valid
    gt = np.stack([run["seq"].poses[i] for i in range(len(run["seq"]))])
    assert ate_rmse(pt.timestamps, gt, pt.timestamps, np.stack(pt.trajectory)) < 0.03


def test_lost_frame_holds_the_prediction():
    """A black frame has no features: not ok, and the pose stays at the
    motion model's prediction (no relocalization on this path)."""
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    pt = FrameToFrameTracker(SlamConfig(**small_cfg_kw(seq)), device="cpu")
    for i in range(3):
        assert pt.track(*seq[i]).ok
    T_pred = (pt.T_cl @ pt.T_last).numpy()
    st = pt.track(np.zeros((H, W), np.uint8), np.zeros((H, W), np.float32), 0.1)
    assert (st.n_features, st.n_matches, st.ok) == (0, 0, False)
    np.testing.assert_allclose(np.linalg.inv(pt.trajectory[-1]), T_pred, atol=1e-6)
    assert pt.motion_valid is False


@pytest.mark.slow
def test_tracks_synthetic_sequence_full_width():
    """The twin of tests/test_tracking.py::TestFrameToFrame::test_tracks_synthetic_sequence."""
    seq = SyntheticRGBD(n_frames=12, seed=11, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    tracker = FrameToFrameTracker(cfg, device="cpu")
    for i in range(len(seq)):
        st = tracker.track(*seq[i])
        assert st.ok, (i, st)
        if i > 0:
            assert st.n_matches >= 100, (i, st)
            assert st.n_inliers >= 50, (i, st)
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    rmse = ate_rmse(tracker.timestamps, gt, tracker.timestamps, np.stack(tracker.trajectory))
    assert rmse < 0.03, rmse
