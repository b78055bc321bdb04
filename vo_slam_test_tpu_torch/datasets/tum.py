"""TUM RGB-D dataset I/O (port of ``vo_slam_test_tpu/datasets/tum.py``):
``associate.txt`` parsing (vo_run.cpp:28-58), image loading (:105-123) and
TUM-format trajectory export (:161-232), plus the ATE of the TUM benchmark.

Images are decoded on the host: by the native C++ loader when it builds and
access is sequential, else by ``cv2``, else by ``imageio``. Depth leaves as
f32 meters (the 16-bit value over the depth scale).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class AssociatedFrame:
    rgb_time: str
    rgb_path: str
    depth_time: str
    depth_path: str


def read_associate(dataset_dir: str, limit: int = 0) -> List[AssociatedFrame]:
    """Parse associate.txt: lines of ``t_rgb rgb_path t_depth depth_path``;
    blank lines, ``#`` comments and lines of fewer than four fields are
    skipped. ``limit`` is the reference's ``data_num`` loop bound; 0 means all
    lines."""
    path = os.path.join(dataset_dir, "associate.txt")
    frames: List[AssociatedFrame] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            frames.append(AssociatedFrame(
                rgb_time=parts[0], rgb_path=os.path.join(dataset_dir, parts[1]),
                depth_time=parts[2], depth_path=os.path.join(dataset_dir, parts[3]),
            ))
            if limit and len(frames) >= limit:
                break
    return frames


def python_reader() -> str:
    """The Python decoder that serves when the native one does not."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        return "imageio"


def _imread_gray(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        import imageio.v3 as iio

        img = iio.imread(path)
        if img.ndim == 3:
            # ITU-R BT.601 luma, matching cv2.cvtColor RGB2GRAY
            img = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.uint8)
        return img


def _imread_depth(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        import imageio.v3 as iio

        return iio.imread(path)


class TumDataset:
    """Iterates (gray u8 HxW, depth f32 HxW in meters, timestamp) triples.

    Sequential access uses the native C++ prefetching decoder when it builds;
    random access or a missing toolchain falls back to cv2/imageio on the
    Python thread. ``reader`` names the decoder that served the last frame
    (before any, the one that will serve the first); ``native_error`` says
    why the native one is not used ("" when it is)."""

    def __init__(
        self,
        dataset_dir: str,
        depth_scale: float = 5000.0,
        limit: int = 0,
        use_native: bool = True,
        width: int = 640,
        height: int = 480,
    ):
        self.dataset_dir = dataset_dir
        self.depth_scale = depth_scale
        self.frames = read_associate(dataset_dir, limit=limit)
        self._native = None
        self.native_error = "" if use_native else "use_native=False"
        if use_native and self.frames:
            from ..native import NativeTumLoader

            try:
                self._native = NativeTumLoader(
                    [f.rgb_path for f in self.frames],
                    [f.depth_path for f in self.frames],
                    [float(f.rgb_time) for f in self.frames],
                    depth_scale=depth_scale, width=width, height=height,
                )
            except RuntimeError as e:
                self.native_error = str(e)
        self.reader = "native" if self._native is not None else python_reader()

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, float]:
        if self._native is not None:
            try:
                out = self._native[i]
                self.reader = "native"
                return out
            except ValueError:
                pass  # non-sequential access: fall back
        fr = self.frames[i]
        gray = _imread_gray(fr.rgb_path)
        depth_raw = _imread_depth(fr.depth_path).astype(np.float32)
        depth = depth_raw / self.depth_scale  # visualOdometry.cpp:162-166
        self.reader = python_reader()
        return gray, depth, float(fr.rgb_time)


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
