"""Carry state between the JAX package and this port as numpy.

The system has no learned weights; its state is the config, the camera, the
pattern tables, the tracking state and the map. These helpers move
``FrameFeatures``, ``TrackState``, ``SlamTrackState``, ``MapState`` and a BoW
``Vocabulary`` across as numpy arrays with the JAX layouts (descriptors and
centroids as uint32), so a test can start the port from the JAX system's
exact state after frame k and compare frame k+1 alone, or run both packages
on one vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .bow.vocabulary import Vocabulary
from .frontend.frame import FrameFeatures
from .pipeline.system import SlamTrackState
from .pipeline.tracking import TrackState
from .slam_map.map_state import MapState

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


_DESC_FIELDS = ("kf_desc", "pt_desc")  # uint32 in the JAX map, int32 here


def map_state_from_numpy(d: Dict[str, Any], device) -> MapState:
    """JAX MapState fields as numpy (``kf_desc``/``pt_desc`` uint32) -> the
    port's MapState on ``device``."""
    kw = {}
    for f in dataclasses.fields(MapState):
        a = np.asarray(d[f.name])
        if f.name in _DESC_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        kw[f.name] = torch.as_tensor(np.array(a)).to(device)
    return MapState(**kw)


def map_state_to_numpy(m: MapState) -> Dict[str, np.ndarray]:
    out = {f.name: getattr(m, f.name).cpu().numpy() for f in dataclasses.fields(MapState)}
    for k in _DESC_FIELDS:
        out[k] = out[k].view(np.uint32)
    return out


def slam_track_state_from_numpy(d: Dict[str, Any], device) -> SlamTrackState:
    """The JAX SlamTrackState's fields as numpy -> the port's
    SlamTrackState (the frame counters stay device tensors; the host-known
    flag ``initialized`` becomes a Python value)."""
    def dev(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype)).to(device)

    return SlamTrackState(
        frame_id=dev(d["frame_id"], np.int32), feats=frame_features_from_numpy(d["feats"], device),
        assign_real=dev(d["assign_real"], np.int32), assign_gen=dev(d["assign_gen"], np.int32),
        T_cr=dev(d["T_cr"], np.float32), ref_kf=dev(d["ref_kf"], np.int32),
        T_cl=dev(d["T_cl"], np.float32), motion_valid=dev(d["motion_valid"], np.bool_),
        initialized=bool(d["initialized"]), lost=dev(d["lost"], np.bool_),
        last_kf_frame=dev(d["last_kf_frame"], np.int32),
        last_was_kf=dev(d["last_was_kf"], np.bool_),
        last_reloc_frame=dev(d["last_reloc_frame"], np.int32),
    )


def dataclass_to_numpy(obj) -> Dict[str, Any]:
    """Fields of a dataclass of arrays as numpy, recursively (for example the
    JAX package's FrameFeatures / TrackState, whose arrays convert with
    ``np.asarray``)."""
    return {f.name: (dataclass_to_numpy(v) if dataclasses.is_dataclass(v) else np.asarray(v))
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def vocabulary_from_jax(voc, device) -> Vocabulary:
    """A JAX package ``Vocabulary`` (any object with its fields: ``k``,
    ``levels``, ``centroids``, ``idf``, ``node_valid``, arrays that convert
    with ``np.asarray``) -> the port's on ``device``."""
    return Vocabulary.from_numpy(voc.k, voc.levels, [np.asarray(c) for c in voc.centroids],
                                 np.asarray(voc.idf), [np.asarray(v) for v in voc.node_valid],
                                 device)
