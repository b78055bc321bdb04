"""Map snapshot save/load (port of ``vo_slam_test_tpu/slam_map/serialize.py``).

One compressed ``.npz`` holds the whole map: every ``MapState`` field under
its name with the JAX package's dtypes (descriptors as uint32) plus ``_caps``
= (max_kf, max_pt, max_obs, n_feat) as int64. A map saved by either package
loads in the other, and a loaded map can be tracked against at once.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..convert import map_state_from_numpy, map_state_to_numpy
from .map_state import MapCaps, MapState


def save_map(path: str, m: MapState, caps: MapCaps) -> None:
    data = map_state_to_numpy(m)
    data["_caps"] = np.array([caps.max_kf, caps.max_pt, caps.max_obs, caps.n_feat], np.int64)
    np.savez_compressed(path, **data)


def load_map(path: str, device: Optional[Union[str, torch.device]] = None
             ) -> Tuple[MapState, MapCaps]:
    """Returns (MapState on ``device``, MapCaps); ``device=None`` is the card."""
    with np.load(path) as z:
        caps = MapCaps(*[int(v) for v in z["_caps"]])
        fields = {k: z[k] for k in z.files if k != "_caps"}
    return map_state_from_numpy(fields, resolve_device(device)), caps
