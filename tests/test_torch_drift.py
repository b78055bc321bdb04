"""The port's drift instrument (utils/drift.py::inject_drift) against the
JAX package's and against the host oracle of tests/test_drift.py, on that
file's random maps.

The three cases of tests/test_drift.py run on the port; integer fields
(bindings, observers, covisibility, the tracker's bindings) equal the
oracle's and JAX's exactly, poses and points within 1e-5 (the inverse of D
comes from another LAPACK). Main path 5's second sever
(chip_smoke.pan_sever_old, applied after either package's inject_drift) is
checked on its own terms, after both.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vo_slam_test_tpu.utils.drift import inject_drift as j_inject_drift
from vo_slam_test_tpu_torch.utils.drift import inject_drift
from test_drift import CAPS, oracle, random_map
from torch_slam_helpers import port_map

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
FIELDS = ("kf_pose", "pt_pos", "kf_mp", "pt_obs_kf", "pt_obs_kp", "pt_obs_cnt", "covis")


def _both(m, assign, kf_cut, D):
    pm, pa = inject_drift(port_map(jax.device_get(m)), torch.as_tensor(assign), kf_cut,
                          torch.as_tensor(D))
    jm, ja = j_inject_drift(m, jnp.asarray(assign), jnp.asarray(kf_cut, jnp.int32),
                            jnp.asarray(D))
    for f in FIELDS:
        got, want = getattr(pm, f).numpy(), np.asarray(getattr(jm, f))
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    return pm, pa


def test_matches_host_oracle():
    rng = np.random.default_rng(0)
    for seed in range(5):
        m = random_map(seed)
        assign = rng.integers(-1, CAPS.max_pt, CAPS.n_feat).astype(np.int32)
        kf_cut = int(rng.integers(1, CAPS.max_kf - 1))
        th = rng.normal() * 0.1
        D = np.eye(4, dtype=np.float32)
        D[:3, :3] = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                              [0, 0, 1]], np.float32)
        D[:3, 3] = rng.normal(size=3).astype(np.float32)
        pm, pa = _both(m, assign, kf_cut, D)
        want = oracle(m, assign, kf_cut, D)
        for f, w in zip(FIELDS, want[:7]):
            got = getattr(pm, f).numpy()
            if np.issubdtype(np.asarray(w).dtype, np.floating):
                np.testing.assert_allclose(got, w, atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(got, w, err_msg=f)
        np.testing.assert_array_equal(pa.numpy(), want[7])


def test_seq_based_selection_under_recycling():
    """A recycled low slot created after the cut belongs to the new island."""
    m = random_map(3)
    K = CAPS.max_kf
    seq = np.arange(K, dtype=np.int32)
    seq[0] = K + 5
    m = m.replace(kf_seq=jnp.asarray(seq), kf_valid=jnp.asarray(np.ones(K, bool)))
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = [0.3, -0.1, 0.2]
    kf_cut = K - 2
    pm, _ = _both(m, np.full((CAPS.n_feat,), -1, np.int32), kf_cut, D)
    poses, new_poses, Dinv = np.asarray(m.kf_pose), pm.kf_pose.numpy(), np.linalg.inv(D)
    np.testing.assert_allclose(new_poses[0], poses[0] @ Dinv, atol=1e-5)
    np.testing.assert_allclose(new_poses[1], poses[1], atol=1e-6)
    np.testing.assert_allclose(new_poses[kf_cut], poses[kf_cut] @ Dinv, atol=1e-5)


def test_projections_invariant():
    """T' X' == T X for island pairs: tracking continues seamlessly."""
    m = random_map(7)
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = [0.5, 0.2, -0.1]
    kf_cut = 4
    pm, _ = _both(m, np.full((CAPS.n_feat,), -1, np.int32), kf_cut, D)
    kf_sel = np.zeros(CAPS.max_kf, bool)
    kf_sel[kf_cut:] = True
    kf_sel &= np.asarray(m.kf_valid)
    ref = np.asarray(m.pt_ref_kf)
    pt_sel = (ref >= 0) & kf_sel[np.clip(ref, 0, CAPS.max_kf - 1)] & np.asarray(m.pt_valid)
    k = int(np.nonzero(kf_sel)[0][0])
    p = np.nonzero(pt_sel)[0]
    xh = np.concatenate([np.asarray(m.pt_pos)[p], np.ones((p.size, 1))], 1)
    xh2 = np.concatenate([pm.pt_pos.numpy()[p], np.ones((p.size, 1))], 1)
    np.testing.assert_allclose(xh2 @ pm.kf_pose.numpy()[k].T, xh @ np.asarray(m.kf_pose)[k].T,
                               atol=1e-4)


def test_sever_old_cuts_both_directions():
    """``pan_sever_old`` after ``inject_drift``: no old keyframe keeps a
    binding to, or an observer entry on, an island point; everything else is
    the instrument's; the same edit on the JAX package's map."""
    rng = np.random.default_rng(11)
    m = random_map(4)
    assign = rng.integers(-1, CAPS.max_pt, CAPS.n_feat).astype(np.int32)
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = [0.5, 0.2, 0.0]
    base, a0 = _both(m, assign, 5, D)
    pm = base.replace(**{k: torch.as_tensor(v) for k, v in cs.pan_sever_old(base, 5).items()})
    jm, _ = j_inject_drift(m, jnp.asarray(assign), jnp.asarray(5, jnp.int32), jnp.asarray(D))
    jm = jm.replace(**{k: jnp.asarray(v) for k, v in cs.pan_sever_old(jm, 5).items()})
    for f in ("kf_mp", "pt_obs_kf", "pt_obs_kp", "pt_obs_cnt"):
        assert getattr(pm, f).dtype == getattr(base, f).dtype, f
        np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(jm, f)), f)
    K, P = CAPS.max_kf, CAPS.max_pt
    kf_sel = (np.asarray(m.kf_seq) >= np.asarray(m.kf_seq)[5]) & np.asarray(m.kf_valid)
    ref = np.asarray(m.pt_ref_kf)
    pt_sel = (ref >= 0) & kf_sel[np.clip(ref, 0, K - 1)] & np.asarray(m.pt_valid)
    kf_mp = pm.kf_mp.numpy()
    assert not (~kf_sel[:, None] & (kf_mp >= 0) & pt_sel[np.clip(kf_mp, 0, P - 1)]).any()
    obs = pm.pt_obs_kf.numpy()
    assert not ((obs >= 0) & ~kf_sel[np.clip(obs, 0, K - 1)] & pt_sel[:, None]).any()
    # only those links changed; counts dropped by the observers removed
    cut_kp = (base.kf_mp.numpy() != kf_mp)
    assert cut_kp.any() and (kf_mp[cut_kp] == -1).all() and not kf_sel[cut_kp.any(1)].any()
    removed = ((base.pt_obs_kf.numpy() >= 0) & (obs < 0)).sum(1)
    np.testing.assert_array_equal(pm.pt_obs_cnt.numpy(),
                                  np.maximum(base.pt_obs_cnt.numpy() - removed, 0))
    for f in ("kf_pose", "pt_pos", "covis"):
        assert torch.equal(getattr(pm, f), getattr(base, f)), f
