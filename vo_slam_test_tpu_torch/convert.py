"""Carry state between the JAX package and this port as numpy.

The system has no learned weights; its state is the config, the camera, the
pattern tables and the tracking state. These helpers move ``FrameFeatures``
and ``TrackState`` across as dicts of numpy arrays with the JAX layouts
(``desc`` as uint32 [N, 8]), so a test can start the port from the JAX
tracker's exact state after frame k and compare frame k+1 alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .frontend.frame import FrameFeatures
from .pipeline.tracking import TrackState

_FEATURE_DTYPES = {
    "uv": np.float32, "uv_und": np.float32, "response": np.float32, "angle": np.float32,
    "octave": np.int32, "depth": np.float32, "u_right": np.float32, "valid": np.bool_,
}


def frame_features_from_numpy(d: Dict[str, Any], device) -> FrameFeatures:
    """JAX FrameFeatures fields as numpy (``desc`` uint32 [N, 8]) -> port."""
    kw = {k: torch.as_tensor(np.array(d[k], dtype=dt)).to(device)
          for k, dt in _FEATURE_DTYPES.items()}
    desc = np.array(d["desc"], dtype=np.uint32).view(np.int32)
    return FrameFeatures(desc=torch.as_tensor(desc).to(device), **kw)


def frame_features_to_numpy(f: FrameFeatures) -> Dict[str, np.ndarray]:
    out = {k: getattr(f, k).cpu().numpy() for k in _FEATURE_DTYPES}
    out["desc"] = f.desc.cpu().numpy().view(np.uint32)
    return out


def track_state_from_numpy(d: Dict[str, Any], device) -> TrackState:
    """{"feats": {...}, "T_c_w", "T_cl", "motion_valid", "initialized"} ->
    port TrackState on ``device``."""
    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32)).to(device)

    return TrackState(
        feats=frame_features_from_numpy(d["feats"], device),
        T_c_w=f32(d["T_c_w"]),
        T_cl=f32(d["T_cl"]),
        motion_valid=torch.as_tensor(bool(d["motion_valid"])).to(device),
        initialized=bool(d["initialized"]),
    )


def track_state_to_numpy(s: TrackState) -> Dict[str, Any]:
    return {
        "feats": frame_features_to_numpy(s.feats),
        "T_c_w": s.T_c_w.cpu().numpy(),
        "T_cl": s.T_cl.cpu().numpy(),
        "motion_valid": bool(s.motion_valid),
        "initialized": bool(s.initialized),
    }


def dataclass_to_numpy(obj) -> Dict[str, Any]:
    """Fields of a dataclass of arrays as numpy, recursively (for example the
    JAX package's FrameFeatures / TrackState, whose arrays convert with
    ``np.asarray``)."""
    return {f.name: (dataclass_to_numpy(v) if dataclasses.is_dataclass(v) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}
