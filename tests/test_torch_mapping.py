"""The port's local-mapping chain against the JAX package, one function at a
time: the JAX system runs the room orbit (320x240, 4 levels, 500 features,
MapCaps(max_kf=16, max_pt=4096)) to its keyframe insert at frame 12, then its
chain step by step (cull_map_points, create_new_map_points with the epipolar
search, search_in_neighbors with both fuses, cull_keyframes), all in the
session's one JAX run (tests/torch_slam_helpers.py). Each port function
starts from the converted JAX map its JAX counterpart got and must give the
JAX map that came out.

Integer and bool map fields must be equal. Float fields agree to rtol 1e-4 /
atol 1e-5: both sides round in f32 but sum in another order (the
triangulation's SVD and 3x3 products, norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map import culling as jculling
from vo_slam_test_tpu.slam_map import fuse as jfuse
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.ops import match_cuda
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map import culling, fuse, triangulate
from torch_slam_helpers import (J_CAPS, KF_FRAME, P_CAPS, assert_maps_agree, jax_map_fresh,
                                jax_room_run, jax_system, port_map, room_kw, room_sequence)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX map after frame 12's keyframe insert and after each step of
    the JAX chain in the reference order (local BA skipped at its entry)."""
    run = jax_room_run(tmp_path_factory)
    assert run["stats"][KF_FRAME]["made_kf"]
    seq = room_sequence()
    ps = SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu")
    return dict(js=jax_system(seq), ps=ps, maps=run["chain"], kf=run["kf"])


def run_port(chain, i, p_fn):
    """The port's chain step i from the JAX map before it -> (port map, the
    JAX map after it)."""
    return p_fn(port_map(chain["maps"][i]), chain["kf"]), chain["maps"][i + 1]


def test_cull_map_points_matches_jax(chain):
    got, want = run_port(chain, 0, lambda m, k: culling.cull_map_points(m, k, P_CAPS))
    assert_maps_agree(got, want, "cull_map_points")
    assert int(want.pt_valid.sum()) < int(chain["maps"][0].pt_valid.sum())  # it culls


def test_create_new_map_points_matches_jax(chain):
    ps = chain["ps"]
    launches = match_cuda.KERNEL_EPI.launches
    got, want = run_port(chain, 1, lambda m, k: triangulate.create_new_map_points(
        m, k, P_CAPS, ps.camera, ps.scale_factors))
    assert_maps_agree(got, want, "create_new_map_points")
    assert int(want.n_pt) > int(chain["maps"][1].n_pt)  # it triangulates new points
    assert match_cuda.KERNEL_EPI.launches == launches  # CPU tensors: the plain version


def test_search_in_neighbors_matches_jax(chain):
    ps = chain["ps"]
    got, want = run_port(chain, 2, lambda m, k: fuse.search_in_neighbors(
        m, k, P_CAPS, ps.camera, ps.scale_factors))
    assert_maps_agree(got, want, "search_in_neighbors")
    before = chain["maps"][2]
    assert int(want.pt_valid.sum()) < int(before.pt_valid.sum())  # it merges points


def test_fuse_parts_match_jax(chain):
    """The pieces of the fuse: the two-hop neighbour set, the free-slot order
    and each fuse on its own."""
    js, ps, m_host, kf = chain["js"], chain["ps"], chain["maps"][2], chain["kf"]
    jm, pm = jax_map_fresh(m_host), port_map(m_host)
    j_nb = jfuse.two_hop_neighbors(jm, jnp.asarray(kf, jnp.int32))
    p_nb = fuse.two_hop_neighbors(pm, kf)
    np.testing.assert_array_equal(p_nb.numpy(), np.asarray(j_nb))
    assert int(p_nb.sum()) >= 2
    free = np.random.default_rng(0).random((64, 24)) < 0.4
    order = fuse._free_slot_order(torch.as_tensor(free)).numpy()
    want = np.asarray(jfuse._free_slot_order(jnp.asarray(free)))
    nfree = free.sum(1)
    for r in range(64):  # defined for the first nfree ranks of a row
        np.testing.assert_array_equal(order[r, :nfree[r]], want[r, :nfree[r]])
    nb_ids = fuse.compact_ids(p_nb, 16)
    np.testing.assert_array_equal(nb_ids.numpy(), np.asarray(jfuse._compact_ids(j_nb, 16)))

    got = fuse.fuse_curr_into_neighbors(pm, kf, nb_ids, P_CAPS, ps.camera, ps.scale_factors)
    # the JAX functions jitted, as the system's mapping step runs them
    want = jax.jit(lambda m, k, nb: jfuse.fuse_curr_into_neighbors(
        m, k, nb, J_CAPS, js.camera, js.scale_factors))(
        jax_map_fresh(m_host), jnp.asarray(kf, jnp.int32), jnp.asarray(nb_ids.numpy()))
    assert_maps_agree(got, jax.device_get(want), "fuse_curr_into_neighbors")

    rows_on = np.asarray(m_host.kf_mp)[np.asarray(p_nb)]
    cand = np.zeros(m_host.pt_valid.shape[0], bool)
    cand[rows_on[rows_on >= 0]] = True
    got = fuse.fuse_into_keyframe(port_map(m_host), kf, torch.as_tensor(cand), P_CAPS,
                                  ps.camera, ps.scale_factors)
    want = jax.jit(lambda m, k, c: jfuse.fuse_into_keyframe(
        m, k, c, J_CAPS, js.camera, js.scale_factors))(
        jax_map_fresh(m_host), jnp.asarray(kf, jnp.int32), jnp.asarray(cand))
    assert_maps_agree(got, jax.device_get(want), "fuse_into_keyframe")


def test_cull_keyframes_matches_jax(chain):
    ps = chain["ps"]
    got, want = run_port(chain, 3, lambda m, k: culling.cull_keyframes(m, k, P_CAPS, ps.camera))
    assert_maps_agree(got, want, "cull_keyframes")


def test_cull_keyframes_culls_a_redundant_keyframe(chain):
    """A redundant keyframe is erased on both sides, with its observations,
    covisibility and spanning-tree edges: every point keyframe 2 binds is
    given four observers at octave 0 (keyframes 0-3, its own keypoint slot)."""
    js, ps, kf = chain["js"], chain["ps"], chain["kf"]
    m_np = jax.tree.map(np.array, chain["maps"][3])
    assert bool(m_np.kf_valid[:4].all()) and kf == 3
    m_np.kf_octave[:] = 0
    row = m_np.kf_mp[2]
    for kp in np.flatnonzero(row >= 0):
        m_np.pt_obs_kf[row[kp], :4] = [0, 1, 2, 3]
        m_np.pt_obs_kp[row[kp], :4] = kp
        m_np.pt_obs_cnt[row[kp]] = max(int(m_np.pt_obs_cnt[row[kp]]), 4)
    m_np.covis[kf, 2] = m_np.covis[2, kf] = 50
    k = jnp.asarray(kf, jnp.int32)
    want = jax.device_get(jax.jit(lambda m: jculling.cull_keyframes(m, k, J_CAPS, js.camera))(
        jax_map_fresh(m_np)))
    got = culling.cull_keyframes(port_map(m_np), kf, P_CAPS, ps.camera)
    assert_maps_agree(got, want, "cull_keyframes (redundant)")
    assert not bool(want.kf_valid[2]) and bool(m_np.kf_valid[2])
