"""ORB constant tables (port of ``vo_slam_test_tpu/ops/pattern.py``).

- ``bit_pattern_31``: the 256-pair rBRIEF sampling pattern (OpenCV's public
  table), this package's own copy in ``data/orb_pattern.npy``.
- ``umax_table``: the eighth-circle patch-boundary table of the intensity
  centroid orientation (integer circle of radius 15 with symmetry enforced).
"""

from __future__ import annotations

import os

import numpy as np

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
EDGE_THRESHOLD = 19

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def bit_pattern_31() -> np.ndarray:
    """(256, 4) int32 array of (x1, y1, x2, y2) sample offsets."""
    return np.load(os.path.join(_DATA_DIR, "orb_pattern.npy"))


def umax_table() -> np.ndarray:
    """(HALF_PATCH_SIZE+1,) int32: max |x| for each |y| in the circular patch."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = float(hp * hp)
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    # enforce symmetry under the 45-degree reflection
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def circular_patch_mask() -> np.ndarray:
    """(31, 31) bool mask of the orientation patch (rows clipped by umax)."""
    umax = umax_table()
    hp = HALF_PATCH_SIZE
    ys, xs = np.mgrid[-hp : hp + 1, -hp : hp + 1]
    return np.abs(xs) <= umax[np.abs(ys)]
