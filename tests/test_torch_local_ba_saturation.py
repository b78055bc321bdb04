"""Twin of tests/test_local_ba_saturation.py: local BA past every cap of the
window (W_KF=24 window keyframes, F_KF=40 fixed, L_PT local points, O_BA=12
observer slots) in the port (``solvers/local_ba.py``), against the JAX
package on the same maps (``tools/synth_map.build``, carried across).

- the window keeps the strongest covisibles; ``build_problem_ol``'s
  ``kf_ids``, ``pt_ids`` and ``o_valid`` equal JAX's;
- observer lists longer than O_BA enter valid-first truncated;
- one ``local_bundle_adjust`` on perturbed local points: the LM iteration
  counts equal JAX's ((5, 10)), every integer field equal, window poses
  within 1e-3 of JAX's (observed 5.5e-6), 95% of the moved points within
  1 mm (observed 1.9e-5) and every one within 5 cm (the bounds of
  tests/test_torch_local_ba.py's BA step from a JAX map), the window's
  reprojection error at least halved, nothing outside the problem moved.
  The exception: ``synth_map`` leaves a few points with one observation,
  and where that one is mono (u_right < 0) the point's depth is the null
  direction of its 3x3 block; LM moves it along the ray by rounding noise
  over the damping (observed: 2 points, 0.129 and 0.123 m apart from JAX's
  along the ray, 6e-6 m across it). Those are held across the ray (1 mm);

- point overflow with ``L_PT`` lowered to 1024 (monkeypatched in both
  packages, as the JAX test does): exactly 1024 valid points selected, every
  observation row references a selected point's observers.

``slow``, as the JAX file is: JAX compiles the production-shaped BA on the
CPU. The JAX side runs once per file (module fixture).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.solvers import local_ba as jlba
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import local_ba
from test_local_ba_saturation import _reproj_cost
from torch_slam_helpers import jax_map_fresh, port_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from synth_map import build  # noqa: E402

pytestmark = pytest.mark.slow  # production-shaped BA compile in JAX

CAPS = JMapCaps(max_kf=64, max_pt=4096, max_obs=24, n_feat=256)
PCAPS = MapCaps(max_kf=64, max_pt=4096, max_obs=24, n_feat=256)
OVERFLOW_CAPS = (64, 4096, 24, 1024)
PCAM = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                     camera_k3=0), "cpu")
CENTER = 20
L_CAP = 1024


def _perturbed(m, pt_ids):
    """tests/test_local_ba_saturation.py:94-100: the local points moved by
    N(0, 2 cm) -> (map, sorted point ids)."""
    sel = np.asarray(sorted(pt_ids[pt_ids >= 0].tolist()))
    pt = np.array(m.pt_pos)
    pt[sel] += np.random.default_rng(0).normal(0, 0.02, (len(sel), 3)).astype(np.float32)
    return m.replace(pt_pos=pt), sel


@pytest.fixture(scope="module")
def run():
    m, cam = build(CAPS, n_kf=40, n_pt=3500, seed=3, span_max=24)
    m = jax.device_get(m)
    center = jnp.asarray(CENTER, jnp.int32)
    prob = jax.device_get(jlba.build_problem_ol(jax_map_fresh(m), center, CAPS))
    mp, sel = _perturbed(m, np.asarray(prob.pt_ids))
    solved, n1, n2 = jlba.local_bundle_adjust_iters(jax_map_fresh(mp), center, CAPS, cam)
    mo, _ = build(JMapCaps(*OVERFLOW_CAPS), n_kf=40, n_pt=3500, seed=5, span_max=24)
    mo = jax.device_get(mo)
    full = jax.device_get(jlba.build_problem_ol(jax_map_fresh(mo), center,
                                                JMapCaps(*OVERFLOW_CAPS)))
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jlba, "L_PT", L_CAP)
        capped = jax.device_get(jlba.build_problem_ol(jax_map_fresh(mo), center,
                                                      JMapCaps(*OVERFLOW_CAPS)))
    return dict(m=m, prob=prob, perturbed=mp, sel=sel, solved=jax.device_get(solved),
                iters=(int(n1), int(n2)), mo=mo, full=full, capped=capped, cam=cam)


def _free_depth_points(prob, kf_pose):
    """{point id: its observer's camera centre} for the problem's points with
    one valid observation, a mono one (u_right < 0): their depth along that
    ray is the null direction of their point block."""
    one_mono = (prob.o_valid.sum(0) == 1) & ((prob.o_valid & (prob.o_ur < 0)).sum(0) == 1)
    out = {}
    for i in torch.nonzero(one_mono & (prob.pt_ids >= 0)).flatten().tolist():
        o = int(torch.nonzero(prob.o_valid[:, i])[0])
        T = kf_pose[int(prob.kf_ids[int(prob.o_slot[o, i])])]
        out[int(prob.pt_ids[i])] = -T[:3, :3].T @ T[:3, 3]
    return out


def _assert_problem_ids_equal(pp, jp):
    for f in ("kf_ids", "pt_ids", "o_valid"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)), f)


def test_window_keeps_strongest_covisibles(run):
    pm = port_map(run["m"])
    covis = (pm.covis[CENTER] * pm.kf_valid).numpy()
    connected = int((covis > 0).sum())
    assert connected > local_ba.W_KF, connected  # saturation is real

    prob = local_ba.build_problem_ol(pm, CENTER, PCAPS)
    _assert_problem_ids_equal(prob, run["prob"])
    win = prob.kf_ids.numpy()[: local_ba.W_KF]
    assert (win >= 0).all() and win[0] == CENTER
    # every selected neighbour is at least as covisible as every unselected one
    sel_w = covis[win[1:]]
    unsel = np.setdiff1d(np.nonzero(covis > 0)[0], win)
    assert sel_w.min() >= covis[unsel].max(), (sel_w.min(), covis[unsel].max())


def test_observer_lists_truncate_valid_first(run):
    prob = local_ba.build_problem_ol(port_map(run["m"]), CENTER, PCAPS)
    _assert_problem_ids_equal(prob, run["prob"])
    o_valid = prob.o_valid.numpy()           # [O_BA, L]
    assert o_valid.shape[0] == local_ba.O_BA
    # the lists really overflow: some point has more valid observers than slots
    assert int(port_map(run["m"]).pt_obs_cnt.max()) > local_ba.O_BA
    # valid-first compaction: no valid slot after an invalid one
    first_invalid = np.argmin(o_valid, axis=0)
    any_invalid = ~o_valid.all(axis=0)
    for col in np.nonzero(any_invalid)[0][:200]:
        assert not o_valid[first_invalid[col]:, col].any()


def test_saturated_solve_reduces_error_and_touches_only_problem(run):
    mp, sel = run["perturbed"], run["sel"]
    pm = port_map(mp)
    prob = local_ba.build_problem_ol(pm, CENTER, PCAPS)
    _assert_problem_ids_equal(prob, run["prob"])
    win = prob.kf_ids.numpy()[: local_ba.W_KF]
    pre_pose, pre_pts = pm.kf_pose.numpy().copy(), pm.pt_pos.numpy().copy()

    m2, n1, n2 = local_ba.local_bundle_adjust_iters(pm, CENTER, PCAPS, PCAM)
    assert (n1, n2) == run["iters"], ((n1, n2), run["iters"])
    got, want = convert.map_state_to_numpy(m2), convert.dataclass_to_numpy(run["solved"])
    free = _free_depth_points(prob, want["kf_pose"])
    assert 0 < len(free) < 10, sorted(free)
    for k, w in want.items():
        if k == "kf_pose":
            np.testing.assert_allclose(got[k], w, atol=1e-3)
        elif k == "pt_pos":
            moved = np.abs(w - pre_pts).max(1) > 0
            d = np.abs(got[k] - w).max(1)
            held = moved.copy()
            held[list(free)] = False
            assert held.sum() > 100 and np.quantile(d[held], 0.95) < 1e-3
            assert d[held].max() < 0.05
            # a point seen once, mono, moves along its ray by rounding noise
            # over the damping; across the ray it agrees
            for p, ow in free.items():
                ray = (w[p] - ow) / np.linalg.norm(w[p] - ow)
                diff = got[k][p] - w[p]
                assert np.linalg.norm(diff - ray * (diff @ ray)) < 1e-3, p
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)

    before = _reproj_cost(mp, PCAM, win)
    after = _reproj_cost(m2, PCAM, win)
    assert after < before * 0.5, (before, after)
    # outside the problem nothing moves
    kf_ids = prob.kf_ids.numpy()
    kf_in = np.zeros(PCAPS.max_kf, bool)
    kf_in[kf_ids[kf_ids >= 0]] = True
    np.testing.assert_array_equal(got["kf_pose"][~kf_in], pre_pose[~kf_in])
    pt_in = np.zeros(PCAPS.max_pt, bool)
    pt_in[sel] = True
    np.testing.assert_array_equal(got["pt_pos"][~pt_in], pre_pts[~pt_in])


def test_point_overflow_drops_cleanly(run, monkeypatch):
    # n_feat=1024: with 256 keypoint slots per keyframe the window could never
    # exceed a 1024-point cap (tests/test_local_ba_saturation.py:121-123)
    caps = MapCaps(*OVERFLOW_CAPS)
    pm = port_map(run["mo"])
    full = local_ba.build_problem_ol(pm, CENTER, caps)
    _assert_problem_ids_equal(full, run["full"])
    n_candidates = int((full.pt_ids >= 0).sum())
    assert n_candidates > L_CAP  # the synthetic window really overflows

    monkeypatch.setattr(local_ba, "L_PT", L_CAP)
    prob = local_ba.build_problem_ol(pm, CENTER, caps)
    _assert_problem_ids_equal(prob, run["capped"])
    pids = prob.pt_ids.numpy()
    assert pids.shape[0] == L_CAP and (pids >= 0).all()
    assert pm.pt_valid.numpy()[pids].all()
    # every observation row references a selected point's observers
    o_valid, o_slot = prob.o_valid.numpy(), prob.o_slot.numpy()
    assert (o_slot[o_valid] >= 0).all()
    assert o_valid.shape == (local_ba.O_BA, L_CAP)
