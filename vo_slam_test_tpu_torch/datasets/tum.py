"""TUM trajectory export and ATE (port of the ``write_trajectory_tum`` /
``ate_rmse`` half of ``vo_slam_test_tpu/datasets/tum.py``; the dataset reader
is not ported yet)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def write_trajectory_tum(path: str, timestamps: List[float], T_w_c: np.ndarray) -> None:
    """Write ``t tx ty tz qx qy qz qw`` per row; ``T_w_c`` is (N, 4, 4)
    camera-to-world."""
    from .. import lie

    T = torch.as_tensor(np.asarray(T_w_c, dtype=np.float32))
    quat = lie.mat_to_quat(T[:, :3, :3]).numpy()
    trans = T[:, :3, 3].numpy()
    with open(path, "w") as f:
        for i, t in enumerate(timestamps):
            tx, ty, tz = trans[i]
            qx, qy, qz, qw = quat[i]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def ate_rmse(gt_times, gt_T_w_c, est_times, est_T_w_c, max_dt: float = 0.02) -> float:
    """Absolute trajectory error RMSE after SE3 (Horn) alignment, as the TUM
    benchmark's evaluate_ate.py computes it."""
    gt_times = np.asarray(gt_times)
    gt_xyz, est_xyz = [], []
    for i, t in enumerate(np.asarray(est_times)):
        j = int(np.argmin(np.abs(gt_times - t)))
        if abs(gt_times[j] - t) <= max_dt:
            gt_xyz.append(gt_T_w_c[j][:3, 3])
            est_xyz.append(est_T_w_c[i][:3, 3])
    if len(gt_xyz) < 3:
        return float("nan")
    X = np.stack(est_xyz).T
    Y = np.stack(gt_xyz).T
    mx, my = X.mean(1, keepdims=True), Y.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd((Y - my) @ (X - mx).T)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    err = R @ X + (my - R @ mx) - Y
    return float(np.sqrt((err**2).sum(0).mean()))
