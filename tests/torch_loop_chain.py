"""tests/test_loop_close.py's hand-built drifted keyframe chain and
tests/test_torch_loop_background.py's shared-place BoW words, built with
numpy and the port alone (no JAX), for the card's tests: ten keyframes, KF0
and KF9 revisit one place, the stored chain drifts with the index, KF0 and
KF9 share 40 BoW words and one featVec bucket, every point found once per
visible once. ``tests/test_torch_loop_system_graphs.py`` holds it against
the JAX-built map."""

import numpy as np
import torch

from vo_slam_test_tpu_torch import lie
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps, MapState, empty_map

CAPS = MapCaps(max_kf=16, max_pt=512, max_obs=8, n_feat=128)
NP_PTS = 80
KW = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
SCALES = np.asarray(1.2 ** np.arange(8), np.float32)
GROUP_DIV = 1000


def se3(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0) -> np.ndarray:
    return lie.se3_exp(torch.tensor([tx, ty, tz, rx, ry, rz], dtype=torch.float32)).numpy()


def drifted_chain(device) -> MapState:
    """The place map on ``device`` (the same construction, field for field,
    as the two test files' JAX-built maps)."""
    cam = Camera.from_config(SlamConfig(**KW), "cpu")
    rng = np.random.default_rng(7)
    gt = [np.eye(4, dtype=np.float32)] + [se3(tx=0.02 * i, ry=0.01 * i) for i in range(1, 9)]
    gt = np.stack(gt + [se3(tx=0.05)])
    drift = [se3(tx=0.03 * i, ty=0.015 * i, ry=0.008 * i) for i in range(10)]
    stored = np.stack([gt[i] @ drift[i] for i in range(10)]).astype(np.float32)
    p_true = np.stack([rng.uniform(-0.8, 0.8, NP_PTS), rng.uniform(-0.6, 0.6, NP_PTS),
                       rng.uniform(1.5, 2.5, NP_PTS)], axis=1).astype(np.float32)
    descs = rng.integers(0, 2**32, size=(NP_PTS, 8), dtype=np.uint32)

    def project(T_c_w, pw):
        pc = pw @ T_c_w[:3, :3].T + T_c_w[:3, 3]
        u = float(cam.fx) * pc[:, 0] / pc[:, 2] + float(cam.cx)
        v = float(cam.fy) * pc[:, 1] / pc[:, 2] + float(cam.cy)
        return np.stack([u, v], axis=1).astype(np.float32), pc

    uv0, pc0 = project(gt[0], p_true)
    uv9, pc9 = project(gt[9], p_true)
    inv9 = np.linalg.inv(stored[9])
    p_dup = p_true @ gt[9][:3, :3].T + gt[9][:3, 3]
    p_dup = p_dup @ inv9[:3, :3].T + inv9[:3, 3]

    K, N, P, O = CAPS.max_kf, CAPS.n_feat, CAPS.max_pt, CAPS.max_obs
    f = {}
    f["kf_pose"] = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    f["kf_pose"][:10] = stored
    f["kf_valid"] = np.arange(K) < 10
    f["kf_uv_und"] = np.zeros((K, N, 2), np.float32)
    f["kf_uv_und"][0, :NP_PTS], f["kf_uv_und"][9, :NP_PTS] = uv0, uv9
    f["kf_desc"] = np.zeros((K, N, 8), np.uint32)
    f["kf_desc"][0, :NP_PTS] = f["kf_desc"][9, :NP_PTS] = descs
    f["kf_kp_valid"] = np.zeros((K, N), bool)
    f["kf_kp_valid"][0, :NP_PTS] = f["kf_kp_valid"][9, :NP_PTS] = True
    f["kf_mp"] = np.full((K, N), -1, np.int32)
    f["kf_mp"][0, :NP_PTS] = np.arange(NP_PTS)
    f["kf_mp"][9, :NP_PTS] = NP_PTS + np.arange(NP_PTS)
    f["covis"] = np.zeros((K, K), np.int32)
    for i in range(9):
        f["covis"][i, i + 1] = f["covis"][i + 1, i] = 120
    f["parent"] = np.full(K, -1, np.int32)
    f["parent"][1:10] = np.arange(9)
    f["pt_pos"] = np.zeros((P, 3), np.float32)
    f["pt_pos"][:NP_PTS], f["pt_pos"][NP_PTS:2 * NP_PTS] = p_true, p_dup
    f["pt_desc"] = np.zeros((P, 8), np.uint32)
    f["pt_desc"][:NP_PTS] = f["pt_desc"][NP_PTS:2 * NP_PTS] = descs
    f["pt_valid"] = np.arange(P) < 2 * NP_PTS
    f["pt_ref_kf"] = np.full(P, -1, np.int32)
    f["pt_ref_kf"][:NP_PTS], f["pt_ref_kf"][NP_PTS:2 * NP_PTS] = 0, 9
    d0, d9 = np.linalg.norm(pc0, axis=1), np.linalg.norm(pc9, axis=1)
    f["pt_min_dist"] = np.zeros(P, np.float32)
    f["pt_max_dist"] = np.zeros(P, np.float32)
    f["pt_min_dist"][:NP_PTS], f["pt_max_dist"][:NP_PTS] = 0.5 * d0, 1.02 * d0
    f["pt_min_dist"][NP_PTS:2 * NP_PTS], f["pt_max_dist"][NP_PTS:2 * NP_PTS] = 0.5 * d9, 1.02 * d9
    f["pt_obs_kf"] = np.full((P, O), -1, np.int32)
    f["pt_obs_kp"] = np.full((P, O), -1, np.int32)
    f["pt_obs_kf"][:NP_PTS, 0], f["pt_obs_kf"][NP_PTS:2 * NP_PTS, 0] = 0, 9
    f["pt_obs_kp"][:NP_PTS, 0] = f["pt_obs_kp"][NP_PTS:2 * NP_PTS, 0] = np.arange(NP_PTS)
    f["pt_obs_cnt"] = (np.arange(P) < 2 * NP_PTS).astype(np.int32)
    f["kf_seq"] = np.full(K, -1, np.int32)
    f["kf_seq"][:10] = 10 + np.arange(10)
    f["n_kf_ever"], f["n_kf"], f["n_pt"] = np.int32(20), np.int32(10), np.int32(2 * NP_PTS)

    # tests/test_torch_loop_background.py's place: KF0 and KF9 share 40 words
    rng = np.random.default_rng(3)
    words = np.full((K, N), 1 << 30, np.int32)
    weights = np.zeros((K, N), np.float32)
    place = np.sort(rng.choice(4096, 40, replace=False))
    for k in range(10):
        words[k, :40] = place if k in (0, 9) else np.sort(rng.choice(4096, 40, replace=False))
        weights[k, :40] = 1.0 / 40
    f["kf_bow_word"], f["kf_bow_weight"] = words, weights
    m = empty_map(CAPS, "cpu")
    f["kf_word"] = m.kf_word.numpy().copy()
    f["kf_word"][0, :NP_PTS] = f["kf_word"][9, :NP_PTS] = 0
    f["pt_found"] = f["pt_visible"] = f["pt_valid"].astype(np.int32)
    for k in ("kf_desc", "pt_desc"):
        f[k] = f[k].view(np.int32)
    m = m.replace(**{k: torch.as_tensor(np.array(v)).to(getattr(m, k).dtype)
                     for k, v in f.items()})
    return m.replace(**{k: getattr(m, k).to(device) for k in vars(m)})
