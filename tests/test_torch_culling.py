"""Twin of tests/test_culling.py: point erasure and keyframe culling in the
port (``slam_map/culling.py``) against the JAX package on the same maps.

Each case builds its map with ``tools/synth_map.build`` (JAX), edits it as
the JAX test does, and feeds it to both packages (the port's copy through
``convert.map_state_from_numpy``). Each test asserts (a) the port's map
equals JAX's: integer and bool fields exactly, float fields within
rtol 1e-4 / atol 1e-5 (tests/test_torch_system.py's tolerance), and (b) the
JAX test's own assertions on the port's result, including the brute-force
redundancy oracle (``oracle_cull``, copied from the JAX test). The JAX side
runs once per file (module fixture).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map import culling as jculling
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map import culling
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from torch_slam_helpers import assert_maps_agree, jax_map_fresh, port_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from synth_map import build  # noqa: E402

CAPS = JMapCaps(max_kf=32, max_pt=1024, max_obs=8, n_feat=128)
PCAPS = MapCaps(max_kf=32, max_pt=1024, max_obs=8, n_feat=128)
PCAM = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                     camera_k3=0), "cpu")


def oracle_cull(m, curr_kf, cam):
    """Brute-force redundancy decision per reference semantics."""
    K, N = np.asarray(m.kf_mp).shape
    covis = np.asarray(m.covis)
    kf_valid = np.asarray(m.kf_valid)
    kf_mp = np.asarray(m.kf_mp)
    kp_valid = np.asarray(m.kf_kp_valid)
    depth = np.asarray(m.kf_depth)
    octv = np.asarray(m.kf_octave)
    obs_kf = np.asarray(m.pt_obs_kf)
    obs_kp = np.asarray(m.pt_obs_kp)
    obs_cnt = np.asarray(m.pt_obs_cnt)
    th = float(cam.th_depth)

    out = np.zeros(K, bool)
    for c in range(K):
        if c == 0 or c == curr_kf or not kf_valid[c] or covis[curr_kf, c] <= 0:
            continue
        mp_cnt = re_obs = 0
        for n in range(N):
            p = kf_mp[c, n]
            if p < 0 or not kp_valid[c, n]:
                continue
            d = depth[c, n]
            if not (0 < d <= th):
                continue
            mp_cnt += 1
            if obs_cnt[p] <= 3:
                continue
            lvl = octv[c, n] + 1
            cnt = 0
            for o in range(obs_kf.shape[1]):
                k = obs_kf[p, o]
                if k < 0 or k == c:
                    continue
                if octv[k, obs_kp[p, o]] <= lvl:
                    cnt += 1
            if cnt >= 3:
                re_obs += 1
        if mp_cnt > 0 and re_obs > 0.9 * mp_cnt:
            out[c] = True
    return out


def _host(n_kf, n_pt, seed):
    m, cam = build(CAPS, n_kf=n_kf, n_pt=n_pt, seed=seed)
    return jax.device_get(m), cam


def _force_redundant(m, cam):
    """tests/test_culling.py:110-126: the first connected keyframe c gets the
    coarsest octave and its weakly observed close points go past thDepth ->
    (map, c)."""
    curr = int(m.n_kf) - 1
    covis = np.asarray(m.covis)
    c = [k for k in range(1, curr) if covis[curr, k] > 0 and bool(m.kf_valid[k])][0]
    octv = np.array(m.kf_octave)
    octv[c] = 7
    depth = np.array(m.kf_depth)
    kf_mp = np.asarray(m.kf_mp)
    weak = (kf_mp[c] >= 0) & (np.asarray(m.pt_obs_cnt)[np.maximum(kf_mp[c], 0)] <= 3)
    depth[c, weak] = float(cam.th_depth) + 1.0
    return m.replace(kf_octave=octv, kf_depth=depth), c


def _chained_children(m, cam):
    """tests/test_culling.py:149-178: c forced redundant, with two children:
    x1 covisible with the grandparent g, x2 covisible only with x1 (and the
    dying c) -> (map, c, g, x1, x2)."""
    m, c = _force_redundant(m, cam)
    covis = np.array(m.covis)
    parent = np.array(m.parent)
    g = parent[c]
    assert g >= 0
    x1, x2 = [k for k in range(1, 10) if k not in (c, g)][:2]
    parent[x1] = c
    parent[x2] = c
    covis[x1, g] = covis[g, x1] = 50
    covis[x2, :] = covis[:, x2] = 0
    covis[x2, x1] = covis[x1, x2] = 40
    covis[x2, c] = covis[c, x2] = 30   # link to the dying KF: ignored
    return m.replace(parent=parent, covis=covis), c, g, x1, x2


@pytest.fixture(scope="module")
def cases():
    """Every case's input map (numpy) and JAX's result (numpy)."""
    out = {}
    m, _ = _host(8, 200, 1)
    bad = np.zeros(CAPS.max_pt, bool)
    bad[[5, 17, 42]] = True
    out["unbind"] = (m, bad, jax.device_get(jculling.erase_points(jax_map_fresh(m),
                                                                   jnp.asarray(bad))))
    m, _ = _host(8, 400, 2)
    bad = np.asarray(m.pt_valid).copy()
    out["cap"] = (m, bad, jax.device_get(jculling.erase_points(jax_map_fresh(m), jnp.asarray(bad),
                                                                max_erase=64)))
    for name, (n_kf, n_pt, seed, edit) in {
            "oracle": (12, 600, 3, None), "redundant": (10, 500, 4, _force_redundant),
            "obs_counts": (12, 600, 5, None), "reparent": (10, 500, 4, _chained_children)}.items():
        m, cam = _host(n_kf, n_pt, seed)
        extra = ()
        if edit is not None:
            m, *extra = edit(m, cam)
        curr = int(m.n_kf) - 1
        got = jculling.cull_keyframes(jax_map_fresh(m), jnp.asarray(curr, jnp.int32), CAPS, cam)
        out[name] = (m, curr, jax.device_get(got), tuple(extra))
    return out


def test_erase_points_unbinds_and_invalidates(cases):
    m, bad, want = cases["unbind"]
    bad_ids = [5, 17, 42]
    pm = port_map(m)
    m2 = culling.erase_points(pm, torch.as_tensor(bad))
    assert_maps_agree(m2, want, "erase_points")
    pv = m2.pt_valid.numpy()
    assert not pv[bad_ids].any()
    assert not np.isin(m2.kf_mp.numpy(), bad_ids).any()
    assert (m2.pt_obs_kf.numpy()[bad_ids] == -1).all()
    assert (m2.pt_obs_cnt.numpy()[bad_ids] == 0).all()
    # untouched points keep their bindings
    keep = pm.pt_valid.numpy() & ~bad
    np.testing.assert_array_equal(pm.pt_obs_cnt.numpy()[keep], m2.pt_obs_cnt.numpy()[keep])


def test_erase_respects_cap(cases):
    m, bad, want = cases["cap"]
    pm = port_map(m)
    m2 = culling.erase_points(pm, torch.as_tensor(bad), max_erase=64)
    assert_maps_agree(m2, want, "erase_points(max_erase=64)")
    # exactly 64 died, the rest stay consistently alive
    assert int((pm.pt_valid & ~m2.pt_valid).sum()) == 64
    alive = m2.pt_valid.numpy()
    assert (m2.pt_obs_kf.numpy()[alive] >= 0).any()


def test_cull_matches_numpy_oracle(cases):
    m, curr, want, _ = cases["oracle"]
    pm = port_map(m)
    expect = oracle_cull(pm, curr, PCAM)
    m2 = culling.cull_keyframes(pm, curr, PCAPS, PCAM)
    assert_maps_agree(m2, want, "cull_keyframes (oracle map)")
    np.testing.assert_array_equal((pm.kf_valid & ~m2.kf_valid).numpy(), expect)


def test_redundant_keyframe_dies_and_observations_cleared(cases):
    m, curr, want, _ = cases["redundant"]
    pm = port_map(m)
    expect = oracle_cull(pm, curr, PCAM)
    assert expect.any(), "constructed map must contain a redundant KF"
    m2 = culling.cull_keyframes(pm, curr, PCAPS, PCAM)
    assert_maps_agree(m2, want, "cull_keyframes (forced redundant)")
    culled = np.nonzero(expect)[0]
    assert not np.isin(m2.pt_obs_kf.numpy(), culled).any(), "stale observations of culled KFs"
    # archives written for trajectory recovery
    assert (m2.cull_gen.numpy()[culled] == pm.kf_gen.numpy()[culled]).all()


def test_cull_consistency_obs_counts(cases):
    m, curr, want, _ = cases["obs_counts"]
    m2 = culling.cull_keyframes(port_map(m), curr, PCAPS, PCAM)
    assert_maps_agree(m2, want, "cull_keyframes (seed 5)")
    obs, cnt, live = m2.pt_obs_kf.numpy(), m2.pt_obs_cnt.numpy(), m2.pt_valid.numpy()
    np.testing.assert_array_equal((obs[live] >= 0).sum(1), cnt[live])


def test_child_chains_off_sibling(cases):
    """keyframe.cpp:431-483: a child covisible only with its sibling chains
    off the sibling instead of collapsing onto the grandparent."""
    m, curr, want, (c, g, x1, x2) = cases["reparent"]
    pm = port_map(m)
    assert oracle_cull(pm, curr, PCAM)[c], "c must be culled for the scenario to exercise"
    m2 = culling.cull_keyframes(pm, curr, PCAPS, PCAM)
    assert_maps_agree(m2, want, "cull_keyframes (reparenting)")
    assert not bool(m2.kf_valid[c])
    p2 = m2.parent.numpy()
    assert p2[x1] == g, (p2[x1], g)
    assert p2[x2] == x1, (p2[x2], x1)   # chained, not grandparented
    # Tcp archive for trajectory recovery through c
    assert int(m2.cull_parent[c]) == g
    pose = pm.kf_pose.numpy()
    np.testing.assert_allclose(m2.kf_tcp.numpy()[c], pose[c] @ np.linalg.inv(pose[g]), atol=1e-5)
