"""The port's map state, keyframe insertion, point refresh and local-map
search against the JAX package, from the JAX system's map after the room
orbit's keyframe events at frames 0 and 1 (320x240, 4 levels, 500 features,
MapCaps(max_kf=16, max_pt=4096), interruptBA forced; the session's one JAX
run, tests/torch_slam_helpers.py).

Integer and bool fields and the search's assign / n_matches / visible_mask
must be equal. Float fields agree to rtol 1e-4 / atol 1e-5: both sides round
in f32 but sum norms and products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.pipeline.system import _observed as j_observed
from vo_slam_test_tpu.slam_map import insert as jinsert
from vo_slam_test_tpu.slam_map import local_map as jlocal
from vo_slam_test_tpu.slam_map import map_state as jms
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem, _observed
from vo_slam_test_tpu_torch.slam_map import insert, local_map, map_state
from torch_slam_helpers import (J_CAPS, MAP_AT, P_CAPS, assert_maps_agree, jax_map_fresh,
                                jax_room_run, jax_system, port_map, room_kw, room_sequence)


def feats_to_port(f):
    return convert.frame_features_from_numpy(convert.dataclass_to_numpy(f), "cpu")


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """The JAX state and map after frames 0-4, frame 5's features from the
    JAX front end and the pose JAX tracked for frame 5."""
    run = jax_room_run(tmp_path_factory)
    seq = room_sequence()
    state, m_host = run["pre"][MAP_AT]
    ps = SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu")
    return dict(js=jax_system(seq), ps=ps, m_host=m_host, state=state, feats5=run["feats"],
                T5=run["stats"][MAP_AT]["T"])


def test_empty_map_matches_jax():
    assert_maps_agree(map_state.empty_map(P_CAPS, "cpu"), jms.empty_map(J_CAPS), "empty map")


def test_map_round_trip(snap):
    m = port_map(snap["m_host"])
    assert_maps_agree(m, snap["m_host"], "round trip")
    assert int(m.n_kf) == 2 and m.kf_desc.dtype == torch.int32


def test_add_observations_matches_jax(snap):
    rng = np.random.default_rng(3)
    m_host = snap["m_host"]
    live = np.flatnonzero(np.asarray(m_host.pt_valid))
    pts = rng.choice(live, 200, replace=False).astype(np.int32)
    kps = rng.integers(0, 1024, 200).astype(np.int32)
    mask = rng.random(200) < 0.8
    want = jms.add_observations(jax_map_fresh(m_host), jnp.asarray(pts), 3, jnp.asarray(kps),
                                jnp.asarray(mask))
    got = map_state.add_observations(port_map(m_host), torch.as_tensor(pts), 3,
                                     torch.as_tensor(kps), torch.as_tensor(mask))
    assert_maps_agree(got, jax.device_get(want), "add_observations")
    member = rng.random(m_host.pt_valid.shape[0]) < 0.3
    np.testing.assert_array_equal(
        map_state.covis_row_for(got, torch.as_tensor(member)).numpy(),
        np.asarray(jms.covis_row_for(want, jnp.asarray(member))))


def test_insert_keyframe_matches_jax(snap):
    """Frame 4's features inserted as a keyframe with its real bindings (the
    state's assign) and the depth-sorted spawn mask; then refresh_points."""
    js, ps, m_host, state = snap["js"], snap["ps"], snap["m_host"], snap["state"]
    assign = np.array(state.assign_real)
    T = np.asarray(state.T_cr) @ np.asarray(m_host.kf_pose)[int(state.ref_kf)]
    j_feats = state.feats
    p_feats = feats_to_port(j_feats)

    jm = jax_map_fresh(m_host)
    j_create = jinsert.spawn_mask_depth_sorted(j_feats, j_observed(jm, jnp.asarray(assign)),
                                               js.camera.th_depth)
    pm = port_map(m_host)
    p_create = insert.spawn_mask_depth_sorted(p_feats, _observed(pm, torch.as_tensor(assign)),
                                              ps.camera.th_depth)
    np.testing.assert_array_equal(p_create.numpy(), np.asarray(j_create))
    assert 0 < int(p_create.sum()) < int(p_feats.valid.sum())

    # the JAX functions jitted, as the system's steps run them
    jm2, j_kf = jax.jit(lambda m, f, T, a, c: jinsert.insert_keyframe(
        m, J_CAPS, f, T, jnp.asarray(0.125, jnp.float32), jnp.asarray(4, jnp.int32), a, c,
        js.camera, js.scale_factors))(jm, j_feats, jnp.asarray(T), jnp.asarray(assign), j_create)
    pm2, p_kf = insert.insert_keyframe(
        pm, P_CAPS, p_feats, torch.as_tensor(T), 0.125, 4, torch.as_tensor(assign), p_create,
        ps.camera, ps.scale_factors)
    assert p_kf == int(j_kf) == 2
    jm2 = jax.device_get(jm2)
    assert_maps_agree(pm2, jm2, "insert_keyframe")

    # refresh the points the keyframe touched, on the map after the insert
    touched = np.zeros(m_host.pt_valid.shape[0], bool)
    touched[assign[assign >= 0]] = True
    want = jax.jit(lambda m, t: jinsert.refresh_points(m, t, js.scale_factors))(
        jax_map_fresh(jm2), jnp.asarray(touched))
    got = insert.refresh_points(pm2, torch.as_tensor(touched), ps.scale_factors)
    assert_maps_agree(got, jax.device_get(want), "refresh_points")


def test_allocate_point_slots_matches_jax(snap):
    m_host = snap["m_host"]
    want = np.random.default_rng(4).random(1024) < 0.5
    np.testing.assert_array_equal(
        insert.allocate_point_slots(port_map(m_host), torch.as_tensor(want)).numpy(),
        np.asarray(jinsert.allocate_point_slots(jax_map_fresh(m_host), jnp.asarray(want))))


def test_local_map_search_matches_jax(snap):
    """trackLocalMap's selection and search for frame 5 against the map
    after frame 4: local keyframes from frame 4's bindings, their points,
    the frustum check, and the [4096 x 1024] search."""
    js, ps, m_host, state = snap["js"], snap["ps"], snap["m_host"], snap["state"]
    assign = np.array(state.assign_real)
    jm, pm = jax_map_fresh(m_host), port_map(m_host)
    j_local, j_ref = jlocal.local_keyframe_mask(jm, jnp.asarray(assign))
    p_local, p_ref = local_map.local_keyframe_mask(pm, torch.as_tensor(assign))
    np.testing.assert_array_equal(p_local.numpy(), np.asarray(j_local))
    assert int(p_ref) == int(j_ref)
    j_pts = jlocal.local_point_mask(jm, j_local)
    p_pts = local_map.local_point_mask(pm, p_local)
    np.testing.assert_array_equal(p_pts.numpy(), np.asarray(j_pts))
    member = np.zeros(m_host.pt_valid.shape[0], bool)
    member[assign[assign >= 0]] = True
    cand = np.asarray(j_pts) & ~member
    assert cand.sum() > 100

    T5 = snap["T5"]
    j_fr = jlocal.frustum_check(jm, jnp.asarray(T5), js.camera, js.scale_factors)
    p_fr = local_map.frustum_check(pm, torch.as_tensor(T5), ps.camera, ps.scale_factors)
    for f in ("in_frame", "pred_level"):
        np.testing.assert_array_equal(getattr(p_fr, f).numpy(), np.asarray(getattr(j_fr, f)))
    # pixels of magnitude ~1e2 from f32 products summed in another order
    for f in ("u", "v", "ur", "view_cos"):
        np.testing.assert_allclose(getattr(p_fr, f).numpy(), np.asarray(getattr(j_fr, f)),
                                   rtol=1e-4, atol=1e-3)

    jf, pf = snap["feats5"], feats_to_port(snap["feats5"])
    blocked = np.asarray(j_observed(jm, jnp.asarray(assign)))
    want = jax.jit(lambda *a: jlocal.search_local_points(*a, js.scale_factors, 3.0,
                                                        cam=js.camera))(
        jm, jnp.asarray(T5), jnp.asarray(cand), jf.uv_und, jf.u_right, jf.octave, jf.desc,
        jf.valid, jnp.asarray(blocked))
    got = local_map.search_local_points(
        pm, torch.as_tensor(T5), torch.as_tensor(cand), pf.uv_und, pf.u_right, pf.octave,
        pf.desc, pf.valid, torch.as_tensor(blocked), ps.scale_factors, 3.0, cam=ps.camera)
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(want.assign))
    np.testing.assert_array_equal(got.visible_mask.numpy(), np.asarray(want.visible_mask))
    assert int(got.n_matches) == int(want.n_matches) > 50
