"""Twin of tests/test_fuse_batched.py: the port's batched neighbour fuse
(``slam_map/fuse.py``) against the JAX package on the same maps.

- merge-free instance (the JAX test's ``_merge_free_instance``: the current
  keyframe's points fuse into unbound slots of its two-hop neighbours):
  ``fuse_curr_into_neighbors`` equals the sequential ``fuse_into_keyframe``
  loop in the port, as in JAX, and equals JAX's batched result;
- merge conflicts (:154-222, the same decoy bound at the same slot of
  several neighbours): ``fuse_curr_into_neighbors`` in both packages; the
  map equals JAX's and keeps the invariants (no binding to a dead point,
  every observation agreeing with ``kf_mp``, exact counts), and merges fire;
- the two-hop ``search_in_neighbors`` on an untouched map: equal to JAX's
  and consistent.

The neighbour ids are built here from the two-hop mask (the port has no
``_compact_ids``; they equal JAX's). Maps agree with integer and bool fields
exactly and float fields within rtol 1e-4 / atol 1e-5
(tests/test_torch_system.py's tolerance). The JAX side runs once per file.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map import fuse as jfuse
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map import fuse
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from test_fuse_batched import CAPS, SF, _merge_free_instance
from torch_slam_helpers import assert_maps_agree, jax_map_fresh, port_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from synth_map import build  # noqa: E402

PCAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                n_feat=CAPS.n_feat)
PCAM = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                     camera_k3=0), "cpu")
PSF = torch.as_tensor(np.array(SF))
KF = 11


def neighbour_ids(nb_mask, size=16):
    """[size] int32: the set keyframes of the mask in ascending order, -1
    padded."""
    ids = np.full(size, -1, np.int32)
    on = np.nonzero(np.asarray(nb_mask))[0][:size]
    ids[:on.size] = on
    return ids


def conflict_instance(m, nb_mask):
    """tests/test_fuse_batched.py:164-201: bind each engineered slot (>= 900)
    of every neighbour to a decoy point, the same decoy for the same slot
    offset across neighbours -> (map, live points before, slots bound)."""
    nb_np = np.nonzero(np.asarray(nb_mask))[0]
    kf_mp = np.array(m.kf_mp)
    obs_kf = np.array(m.pt_obs_kf)
    obs_kp = np.array(m.pt_obs_kp)
    valid = np.asarray(m.pt_valid)
    in_curr = np.zeros(valid.shape, bool)
    row = kf_mp[KF]
    in_curr[row[row >= 0]] = True
    in_nb = np.isin(obs_kf, nb_np).any(axis=1)
    pool = np.nonzero(valid & ~in_curr & ~in_nb)[0][:40]
    assert pool.size >= 8, pool.size
    n_bound = 0
    for nb in nb_np:
        sl = np.nonzero(np.asarray(m.kf_kp_valid)[nb, 900:])[0] + 900
        for j, s in enumerate(sl[:24]):
            q = pool[j % pool.size]
            free = np.nonzero(obs_kf[q] < 0)[0]
            if free.size == 0:
                continue
            kf_mp[nb, s] = q
            obs_kf[q, free[0]] = nb
            obs_kp[q, free[0]] = s
            n_bound += 1
    m = m.replace(kf_mp=kf_mp, pt_obs_kf=obs_kf, pt_obs_kp=obs_kp,
                  pt_obs_cnt=(obs_kf >= 0).sum(1).astype(np.int32))
    return m, int(valid.sum()), n_bound


@pytest.fixture(scope="module")
def run():
    jm, jcam, kf_id, nb_mask = _merge_free_instance()
    m = jax.device_get(jm)
    nb_mask = np.asarray(nb_mask)
    nb_ids = neighbour_ids(nb_mask)
    np.testing.assert_array_equal(nb_ids, np.asarray(jfuse._compact_ids(jnp.asarray(nb_mask), 16)))
    j_nb = jnp.asarray(nb_ids)
    out = dict(m=m, nb_mask=nb_mask, nb_ids=nb_ids)
    out["batched"] = jax.device_get(jfuse.fuse_curr_into_neighbors(
        jax_map_fresh(m), kf_id, j_nb, CAPS, jcam, SF))
    mc, live_before, n_bound = conflict_instance(m, nb_mask)
    out["conflict"] = (mc, live_before, n_bound, jax.device_get(jfuse.fuse_curr_into_neighbors(
        jax_map_fresh(mc), kf_id, j_nb, CAPS, jcam, SF)))
    m5, cam5 = build(CAPS, n_kf=12, n_pt=1200, seed=5)
    m5 = jax.device_get(m5)
    out["search"] = (m5, jax.device_get(jfuse.search_in_neighbors(
        jax_map_fresh(m5), jnp.asarray(KF, jnp.int32), CAPS, cam5, SF)))
    return out


def assert_consistent(m2, points=None):
    """Every observation of a live point agrees with the keyframe binding
    table, and its count is the number of its observations."""
    kf_mp, obs_kf, obs_kp = m2.kf_mp.numpy(), m2.pt_obs_kf.numpy(), m2.pt_obs_kp.numpy()
    cnt, valid = m2.pt_obs_cnt.numpy(), m2.pt_valid.numpy()
    for p in np.nonzero(valid)[0][:points]:
        for o in range(obs_kf.shape[1]):
            kf, kp = obs_kf[p, o], obs_kp[p, o]
            if kf >= 0:
                assert kf_mp[kf, kp] == p, (p, o, kf, kp, kf_mp[kf, kp])
        assert cnt[p] == (obs_kf[p] >= 0).sum(), p


def test_matches_sequential_loop_merge_free(run):
    m, nb_ids = run["m"], run["nb_ids"]
    assert int((nb_ids >= 0).sum()) >= 3, nb_ids
    pm = port_map(m)
    got = fuse.fuse_curr_into_neighbors(pm, KF, torch.as_tensor(nb_ids), PCAPS, PCAM, PSF)
    assert_maps_agree(got, run["batched"], "fuse_curr_into_neighbors (merge-free)")

    # sequential oracle: one neighbour at a time in ascending slot order
    row = pm.kf_mp[KF]
    curr_pts = torch.zeros(PCAPS.max_pt, dtype=torch.bool)
    curr_pts[row[row >= 0].long()] = True
    want = pm
    for nb in nb_ids.tolist():
        if nb >= 0:
            want = fuse.fuse_into_keyframe(want, nb, curr_pts, PCAPS, PCAM, PSF,
                                           max_cand=PCAPS.n_feat)
    for f in ("kf_mp", "pt_obs_cnt", "pt_obs_kf", "pt_obs_kp", "pt_valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # sanity: the fuse actually did something
    assert int((got.kf_mp != pm.kf_mp).sum()) > 0


def test_merge_conflicts_stay_consistent(run):
    mc, live_before, n_bound, want = run["conflict"]
    assert n_bound >= 16, n_bound
    got = fuse.fuse_curr_into_neighbors(port_map(mc), KF, torch.as_tensor(run["nb_ids"]), PCAPS,
                                        PCAM, PSF)
    assert_maps_agree(got, want, "fuse_curr_into_neighbors (merge conflicts)")
    valid2 = got.pt_valid.numpy()
    assert int(valid2.sum()) < live_before, "no merge fired"
    # 1. no keyframe slot binds a dead point
    bound = got.kf_mp.numpy()[got.kf_valid.numpy()]
    bound = bound[bound >= 0]
    assert valid2[bound].all(), "dangling binding to erased point"
    # 2./3. every observation agrees with kf_mp; counts exact
    assert_consistent(got)


def test_search_in_neighbors_still_consistent(run):
    m5, want = run["search"]
    got = fuse.search_in_neighbors(port_map(m5), KF, PCAPS, PCAM, PSF)
    assert_maps_agree(got, want, "search_in_neighbors")
    assert_consistent(got, points=400)
