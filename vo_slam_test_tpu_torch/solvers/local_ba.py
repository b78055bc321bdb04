"""Local bundle adjustment (port of the entry of
``vo_slam_test_tpu/solvers/local_ba.py``).

Only the interruptBA entry skip is ported so far: with ``stop`` raised the
whole local BA is skipped and the map passes through untouched, the
reference's ``if (stopFlag) return;`` (optimizer_ceres.cpp:594). The solve
itself runs three TPU kernels (``ba_accumulate``, ``ba_cost``,
``ba_backsub``) that are not ported yet, so a call that would run it raises.
"""

from __future__ import annotations

from typing import Tuple

from ..camera import Camera
from ..slam_map.map_state import MapCaps, MapState


def local_bundle_adjust_iters(
    m: MapState,
    center_kf: int,
    caps: MapCaps,
    cam: Camera,
    inv_level_sigma2=None,
    stop: bool = False,
) -> Tuple[MapState, int, int]:
    """Returns (map, n_iter_pass1, n_iter_pass2): the map untouched and
    (0, 0) when ``stop`` is raised."""
    if stop:
        return m, 0, 0
    raise NotImplementedError("local BA: slice 3, ROADMAP queue 2 rows 7-9")
