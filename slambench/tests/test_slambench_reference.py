"""The plain reference against the port on the CPU: its pyramid equals the
port's, the port's keypoints pass its check on every count, the bf16 control
and planted faults fail it, and the reprojection and ATE arithmetic."""

import numpy as np
import pytest
import torch

from slambench import reference as R
from slambench import scene
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
from vo_slam_test_tpu_torch.ops import pattern
from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid

W, H = 320, 240
CAM = scene.Camera(W, H, 517.306408 / 2, 516.469215 / 2, 318.643040 / 2, 255.313989 / 2)


@pytest.fixture(scope="module")
def frame():
    torch.manual_seed(0)
    g, d = scene.render(scene.scene_planes("room", 11), scene.room_orbit(240, 1.5)[[30]], CAM, "cpu")
    cfg = SlamConfig(camera_fx=CAM.fx, camera_fy=CAM.fy, camera_cx=CAM.cx, camera_cy=CAM.cy,
                     camera_width=W, camera_height=H, camera_k1=0, camera_k2=0, camera_p1=0,
                     camera_p2=0, camera_k3=0)
    spec = PyramidSpec(W, H, 8, 1.2)
    f = extract_fused(g[0], d[0], Camera.from_config(cfg, "cpu"), spec, spec.budget(1000), 20.0, 7.0)
    v = f.valid
    return g[0], d[0], spec, (f.uv[v], f.octave[v], f.angle[v], f.desc[v], f.depth[v])


def _check(frame, kp, control=None):
    g, d, _, _ = frame
    return R.orb_check(g, d, *kp[:4], kp[4], 8, 1.2, 7.0, control)


def test_disc_and_pyramid_equal_the_port(frame):
    g, _, spec, _ = frame
    assert (R.disc_mask() == pattern.circular_patch_mask()).all()
    pyr = build_pyramid(g, spec)
    for lvl, (raw, blur) in enumerate(R.pyramid(g, 8, 1.2)):
        h, w = raw.shape
        assert torch.equal(raw, pyr.raw[lvl, :h, :w]) and torch.equal(blur, pyr.blur[lvl, :h, :w])


def test_the_ports_keypoints_pass(frame):
    out = _check(frame, frame[3])
    assert out["keypoints"] > 300 and out["bad"] == 0 and out["flipped_bits"] == 0


def test_the_bf16_control_fails(frame):
    out = _check(frame, frame[3], control=torch.bfloat16)
    assert out["bad"] > 0.5 * out["keypoints"]


@pytest.mark.parametrize("fault", ["bit", "angle", "shift", "depth"])
def test_planted_faults_are_counted(frame, fault):
    uv, octave, angle, desc, depth = (t.clone() for t in frame[3])
    n = 10
    if fault == "bit":
        desc[:n, 3] ^= 1 << 7
    elif fault == "angle":
        angle[:n] = (angle[:n] + 20.0) % 360.0
    elif fault == "shift":
        uv[:n] += torch.tensor([3.0, 0.0]) * (1.2 ** octave[:n].float())[:, None]
    else:
        depth[:n] = depth[:n] + 0.01
    out = _check(frame, (uv, octave, angle, desc, depth))
    assert out["bad"] >= n if fault != "shift" else out["bad"] >= n // 2
    key = {"bit": "desc_off", "angle": "angle_off", "depth": "depth_off"}.get(fault)
    if key:
        assert out[key] >= n


def test_fast_corner_on_a_drawn_square():
    img = torch.full((60, 60), 100.0)
    img[20:40, 20:40] = 200.0
    raw = img[R._reflect(60, R.HALO, "cpu")][:, R._reflect(60, R.HALO, "cpu")]
    ys = torch.tensor([20, 30, 5])
    xs = torch.tensor([20, 30, 5])
    # the square's corner is a corner; its centre and flat ground are not
    assert R.is_fast_corner(raw, ys, xs, 7.0).tolist() == [True, False, False]


def _map(rng, n_kf=4, n_pt=50):
    poses = np.tile(np.eye(4), (n_kf, 1, 1))
    poses[:, 0, 3] = np.arange(n_kf) * 0.1
    X = np.c_[rng.uniform(-1, 1, n_pt), rng.uniform(-1, 1, n_pt), rng.uniform(2, 4, n_pt)]
    uv = np.zeros((n_kf, n_pt, 2))
    for k in range(n_kf):
        Xc = X + poses[k, :3, 3]
        uv[k, :, 0] = 500 * Xc[:, 0] / Xc[:, 2] + 320
        uv[k, :, 1] = 500 * Xc[:, 1] / Xc[:, 2] + 240
    octave = rng.integers(0, 3, (n_kf, n_pt))
    kf, kp = np.meshgrid(np.arange(n_kf), np.arange(n_pt), indexing="ij")
    return poses, uv, octave, X, kf.ravel(), kp.ravel()


def test_reprojection_is_zero_on_exact_observations_and_grows_with_noise():
    rng = np.random.default_rng(0)
    poses, uv, octave, X, kf, kp = _map(rng)
    err = R.reprojection_px(poses, uv, octave, X[kp], kf, kp, 500, 500, 320, 240, 1.2)
    assert err.max() < 1e-6
    uv2 = uv.copy()
    uv2[..., 0] += 1.2 ** octave  # one pixel of each keypoint's level
    err = R.reprojection_px(poses, uv2, octave, X[kp], kf, kp, 500, 500, 320, 240, 1.2)
    assert np.allclose(err, 1.0)


def test_ate_is_rigid_invariant():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(50, 3))
    c, s = np.cos(0.7), np.sin(0.7)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    assert R.ate(gt, gt @ Rz.T + [1.0, -2.0, 0.5]) < 1e-9
    noisy = gt + rng.normal(scale=0.01, size=gt.shape)
    assert 0.005 < R.ate(gt, noisy) < 0.02
