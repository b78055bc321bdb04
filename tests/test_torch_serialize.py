"""Map save/load across the packages: the port's ``save_map`` read by the
JAX ``load_map`` and the JAX ``save_map`` read by the port's ``load_map``,
every field equal (exact: the map is copied, never recomputed) and in the
JAX package's dtypes. Then one frame resumed on the CPU from a loaded map, as
``tests/test_serialize.py`` resumes it. The map comes from the port's
``SlamSystem`` over the room orbit at 320x240 (no JAX system is compiled)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map import map_state as jmap_state
from vo_slam_test_tpu.slam_map import serialize as jserialize
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps, MapState
from vo_slam_test_tpu_torch.slam_map.serialize import load_map, save_map

from torch_slam_helpers import room_kw, room_sequence

N_FRAMES = 8
CAPS = MapCaps(max_kf=16, max_pt=4096)


@pytest.fixture(scope="module")
def run():
    seq = room_sequence()
    frames = [seq[i] for i in range(N_FRAMES + 1)]
    s = SlamSystem(SlamConfig(**room_kw(seq)), caps=CAPS, device="cpu")
    for f in frames[:N_FRAMES]:
        s.track(*f)
    s.results()
    return s, frames


def jax_dtypes():
    m = jmap_state.empty_map(jmap_state.MapCaps(*dataclasses.astuple(CAPS)))
    return {k: np.asarray(getattr(m, k)).dtype for k in m.__dataclass_fields__}


def test_port_save_loads_in_jax(run, tmp_path):
    s, _ = run
    assert s.n_keyframes >= 2 and s.n_points > 100
    path = str(tmp_path / "port_map.npz")
    save_map(path, s.map, s.caps)
    with np.load(path) as z:
        assert set(z.files) == {f.name for f in dataclasses.fields(MapState)} | {"_caps"}
        assert z["_caps"].dtype == np.int64
        want_dtypes = jax_dtypes()
        for k in z.files:
            if k != "_caps":
                assert z[k].dtype == want_dtypes[k], k
    jm, jcaps = jserialize.load_map(path)
    assert dataclasses.astuple(jcaps) == dataclasses.astuple(CAPS)
    want = convert.map_state_to_numpy(s.map)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(jm, k)), v, err_msg=k)


def test_jax_save_loads_in_port(run, tmp_path):
    s, _ = run
    host = convert.map_state_to_numpy(s.map)
    jm = jmap_state.MapState(**{k: jnp.asarray(v) for k, v in host.items()})
    path = str(tmp_path / "jax_map.npz")
    jserialize.save_map(path, jm, jmap_state.MapCaps(*dataclasses.astuple(CAPS)))
    m, caps = load_map(path, device="cpu")
    assert caps == CAPS
    for f in dataclasses.fields(MapState):
        got, want = getattr(m, f.name), getattr(s.map, f.name)
        assert got.dtype == want.dtype and got.device.type == "cpu", f.name
        assert torch.equal(got, want), f.name


def test_resume_from_loaded_map(run, tmp_path):
    s, frames = run
    path = str(tmp_path / "map.npz")
    save_map(path, s.map, s.caps)
    m2, caps2 = load_map(path, device="cpu")
    for f in ("kf_pose", "pt_pos", "kf_mp", "covis", "pt_desc"):
        assert torch.equal(getattr(m2, f), getattr(s.map, f)), f
    # a fresh system adopts the loaded map and keeps tracking
    s2 = SlamSystem(s.cfg, caps=caps2, device="cpu")
    s2.map = m2
    s2.state = s.state
    s2._frame_id = s._frame_id
    s2.track(*frames[N_FRAMES])
    _, stats, _ = s2.results()
    assert stats[-1].ok and stats[-1].n_inliers >= 10


def test_load_map_defaults_to_the_card(run, tmp_path, monkeypatch):
    """``device=None`` is the card: without one, load_map raises rather than
    falling back to the CPU."""
    s, _ = run
    path = str(tmp_path / "m.npz")
    save_map(path, s.map, s.caps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_map(path)
