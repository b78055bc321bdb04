"""The mapping chain's two device loops: triangulation's neighbour slots
(``slam_map/triangulate.py``, the JAX package's ``fori_loop`` of a
``lax.cond`` per slot) and keyframe culling's covisible reparenting
(``slam_map/culling.py``, its ``fori_loop`` over the culled keyframes around
a ``fori_loop`` of attach steps), each a ``utils.graphs.fori_loop``.

On maps built with ``tools/synth_map.build`` and edited so that every branch
runs: a keyframe whose 10 neighbour slots hold live, gated-out (baseline
under b) and empty slots, and a culling that erases two keyframes whose
children are reparented greedily (one onto its grandparent, one chained off
its sibling, one onto its dead parent's parent). Each case: the eager
result and the ``select``-mode result under ``no_host_reads`` (the CPU's
stand-in for a replay, the keyframe id a device int) equal bit for bit,
both equal the JAX package's ``create_new_map_points`` / ``cull_keyframes``
(integer and bool fields exactly, float fields within
tests/test_torch_system.py's rtol 1e-4 / atol 1e-5), the loops ran as
``graphs.fori_loop``s, and eager triangulation reads its gates once. The
JAX side runs once per file (module fixture).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map import culling as jculling
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.slam_map.triangulate import create_new_map_points as jcreate
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map import culling, triangulate
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.utils import graphs
from torch_slam_helpers import assert_maps_agree, jax_map_fresh, port_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from synth_map import build  # noqa: E402

torch.set_num_threads(1)
TRI_CAPS = JMapCaps(max_kf=16, max_pt=1024, max_obs=8, n_feat=128)
CULL_CAPS = JMapCaps(max_kf=32, max_pt=1024, max_obs=8, n_feat=128)
SF = [1.2 ** i for i in range(8)]
PCAM = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                     camera_k3=0), "cpu")
TRI_KF = 7


def _pcaps(caps):
    return MapCaps(max_kf=caps.max_kf, max_pt=caps.max_pt, max_obs=caps.max_obs,
                   n_feat=caps.n_feat)


def triangulation_map():
    """8 keyframes with half of their keypoints unbound; keyframe 7's first
    and third covisible neighbours moved to within 1 cm of it (gated out by
    the baseline), three more live, the other slots empty -> (numpy map,
    JAX camera, neighbour slots by covisibility)."""
    m, cam = build(TRI_CAPS, n_kf=8, n_pt=600, seed=11)
    m = jax.device_get(m)
    rng = np.random.default_rng(0)
    kf_mp = np.array(m.kf_mp)
    kf_mp[(rng.uniform(size=kf_mp.shape) < 0.5) & (kf_mp >= 0)] = -1
    covis = np.asarray(m.covis)[TRI_KF]
    order = np.argsort(-covis, kind="stable")[:triangulate.N_NEIGHBORS]
    slots = np.where(covis[order] > 0, order, -1)
    pose = np.array(m.kf_pose)
    for k in slots[[0, 2]]:
        pose[k] = pose[TRI_KF]
        pose[k, 0, 3] += 0.01
    return m.replace(kf_mp=kf_mp, kf_pose=pose), cam, slots


def culling_map():
    """12 keyframes; keyframe 11's first and third connected keyframes c1, c2
    made redundant (tests/test_culling.py's edit: coarsest octave, weak
    points past thDepth), and c1 given a second child x covisible with its
    sibling and with c1 only -> (numpy map, JAX camera, (c1, c2, x))."""
    m, cam = build(CULL_CAPS, n_kf=12, n_pt=700, seed=4)
    m = jax.device_get(m)
    curr = int(m.n_kf) - 1
    covis = np.array(m.covis)
    conn = [k for k in range(1, curr) if covis[curr, k] > 0]
    c1, c2, x = conn[0], conn[2], conn[4]
    octv, depth = np.array(m.kf_octave), np.array(m.kf_depth)
    kf_mp, cnt = np.asarray(m.kf_mp), np.asarray(m.pt_obs_cnt)
    for c in (c1, c2):
        octv[c] = 7
        depth[c, (kf_mp[c] >= 0) & (cnt[np.maximum(kf_mp[c], 0)] <= 3)] = float(cam.th_depth) + 1
    parent = np.array(m.parent)
    parent[x] = c1
    covis[x, :] = covis[:, x] = 0
    covis[x, c1 + 1] = covis[c1 + 1, x] = 40
    covis[x, c1] = covis[c1, x] = 30
    covis[x, curr] = covis[curr, x] = 5
    return (m.replace(kf_octave=octv, kf_depth=depth, parent=parent, covis=covis), cam,
            (c1, c2, x))


@pytest.fixture(scope="module")
def jax_runs():
    tm, tcam, slots = triangulation_map()
    tri = jax.device_get(jcreate(jax_map_fresh(tm), jnp.asarray(TRI_KF, jnp.int32), TRI_CAPS,
                                 tcam, jnp.asarray(SF, jnp.float32),
                                 bow_group_div=jnp.asarray(0, jnp.int32)))
    cm, ccam, kfs = culling_map()
    curr = int(cm.n_kf) - 1
    cull = jax.device_get(jculling.cull_keyframes(jax_map_fresh(cm), jnp.asarray(curr, jnp.int32),
                                                  CULL_CAPS, ccam))
    return dict(tri=(tm, tcam, slots, tri), cull=(cm, kfs, curr, cull))


def _equal(a, b) -> list:
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def _both_modes(monkeypatch, fn):
    """``fn()`` eagerly and in select mode under ``no_host_reads`` -> (eager,
    select, the (start, length) of each ``graphs.scan`` call in the eager
    run, ``graphs.fori_loop``'s (lower, upper) among them, the tensors of
    each ``graphs.fetch`` read in the eager run)."""
    loops, fetches = [], []
    scan, fetch = graphs.scan, graphs.fetch

    def rec_loop(body, carry, xs=None, length=None, *, start=0, **kw):
        loops.append((start, length))
        return scan(body, carry, xs, length, start=start, **kw)

    def rec_fetch(*t):
        n = sum(isinstance(x, torch.Tensor) for x in t)
        if n:  # a read (a loop's host bounds are fetched too, reading nothing)
            fetches.append(n)
        return fetch(*t)

    monkeypatch.setattr(graphs, "scan", rec_loop)
    monkeypatch.setattr(graphs, "fetch", rec_fetch)
    eager = fn()
    n_loops, n_fetches = list(loops), list(fetches)
    with graphs.use("select"), graphs.no_host_reads():
        select = fn()
    assert loops[len(n_loops):] == n_loops  # the same loops in both modes
    return eager, select, n_loops, n_fetches


def test_triangulation_slots_are_a_device_loop(jax_runs, monkeypatch):
    m, _, slots, want = jax_runs["tri"]
    pm = port_map(m)
    centres = np.stack([-p[:3, :3].T @ p[:3, 3] for p in np.asarray(m.kf_pose)])
    baseline = np.linalg.norm(centres - centres[TRI_KF], axis=1)
    live = [k for k in slots if k >= 0 and baseline[k] > float(PCAM.b)]
    gated = [k for k in slots if k >= 0 and baseline[k] <= float(PCAM.b)]
    assert len(live) >= 3 and len(gated) == 2 and (slots < 0).sum() >= 3, (slots, baseline)
    sf = torch.tensor(SF, dtype=torch.float32)
    kid = torch.tensor(TRI_KF, dtype=torch.int32)
    eager, select, loops, fetches = _both_modes(monkeypatch, lambda: (
        triangulate.create_new_map_points(port_map(m), kid, _pcaps(TRI_CAPS), PCAM, sf)))
    assert loops == [(0, triangulate.N_NEIGHBORS)]
    assert fetches == [2]  # eager: the gates and neighbour ids in one read
    assert _equal(eager, select) == []
    assert_maps_agree(eager, want, "create_new_map_points")
    n_new = int(eager.pt_valid.sum()) - int(pm.pt_valid.sum())
    assert n_new == int(want.pt_valid.sum()) - int(m.pt_valid.sum()) and n_new > 0


def test_culling_reparenting_is_a_device_loop(jax_runs, monkeypatch):
    m, (c1, c2, x), curr, want = jax_runs["cull"]
    kid = torch.tensor(curr, dtype=torch.int32)
    eager, select, loops, _ = _both_modes(monkeypatch, lambda: (
        culling.cull_keyframes(port_map(m), kid, _pcaps(CULL_CAPS), PCAM)))
    assert loops == [(0, 4)] + [(0, 8)] * 4  # CU culled slots around CH attach steps
    assert _equal(eager, select) == []
    assert_maps_agree(eager, want, "cull_keyframes")
    culled = np.nonzero(np.asarray(m.kf_valid) & ~eager.kf_valid.numpy())[0].tolist()
    assert culled == sorted([c1, c2]), culled
    parent, new_parent = np.asarray(m.parent), eager.parent.numpy()
    assert new_parent[c1 + 1] == parent[c1]  # onto the grandparent
    assert new_parent[x] == c1 + 1           # chained off its sibling
    assert new_parent[c2 + 1] == parent[c2]  # onto its dead parent's parent
