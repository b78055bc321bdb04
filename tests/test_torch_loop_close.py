"""Sim3 verification and loop correction: the port's close_step and
close_step_multi (pipeline/loop_closing.py) against the JAX package's, on
tests/test_loop_close.py's hand-built drifted chain (MapCaps 16/512/8/128:
ten keyframes, KF0 and KF9 revisit one place, the stored chain drifts with
the index).

close_step's accept decision and gate values (n_bow, n_ransac, n_ref,
total, the generation and gap guards) equal JAX's exactly; after the
correction (the propagated group correction, the loop fuse into the
corrected group and the essential graph) the integer and bool map fields
equal JAX's and the float fields agree within 1e-4 (the pose graph solves
a gauge-boosted dense system in f32; its sums run in another order). Then
tests/test_loop_close.py's own bounds on the port's result. close_step_multi
skips the padding and the generation-mismatched copy, rejects the bogus
candidate and accepts the true one, as JAX's does. One JAX run of each
function is shared by the file (module fixture: each compiles for ~30 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import loop_closing as JLC
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from test_loop_close import CAPS, NP_PTS, build_drifted_loop_map
from torch_slam_helpers import port_map

torch.set_num_threads(1)
P_CAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                 n_feat=CAPS.n_feat)
KW = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
SCALES = np.asarray(1.2 ** np.arange(8), np.float32)
MAP_TOL = dict(rtol=1e-4, atol=1e-4)
GATES = ("gen_ok", "gap_ok", "n_bow", "n_ransac", "n_ref", "total", "live1", "live2", "cand_seq",
         "kf_seq")
MULTI_CANDS = [-1, 4, 0, 0, -1, -1, -1, -1]
MULTI_GENS = [-1, 0, 99, 0, -1, -1, -1, -1]


def _multi_map(m):
    """close_step_multi derives the featVec buckets from kf_word: the loop
    pair's keypoints (and the bogus candidate's) in one bucket."""
    kf_word = np.asarray(m.kf_word).copy()
    for k in (0, 9, 4):
        kf_word[k, :NP_PTS] = 0
    return m.replace(kf_word=jnp.asarray(kf_word))


@pytest.fixture(scope="module")
def scene():
    jcam = JCamera.from_config(JConfig(**KW))
    m, gt, stored = build_drifted_loop_map(jcam)
    host = jax.device_get(m)
    groups = jnp.zeros((CAPS.n_feat,), jnp.int32)
    jm, jls, jacc, jdg = JLC.close_step(
        jax.tree.map(jnp.asarray, host), JLC.empty_loop_state(CAPS), jnp.asarray(9, jnp.int32),
        jnp.asarray(0, jnp.int32), CAPS, jcam, jnp.asarray(SCALES), groups, groups, diag=True)
    mm = _multi_map(jax.tree.map(jnp.asarray, host))
    multi_host = jax.device_get(mm)
    jm2, jls2, jdone, jwhich = JLC.close_step_multi(
        mm, JLC.empty_loop_state(CAPS), jnp.asarray(9, jnp.int32), jnp.asarray(0, jnp.int32),
        jnp.asarray(MULTI_CANDS, jnp.int32), jnp.asarray(MULTI_GENS, jnp.int32),
        jnp.asarray(1000, jnp.int32), CAPS, jcam, jnp.asarray(SCALES))
    return dict(
        host=host, multi_host=multi_host, gt=gt, stored=stored,
        cam=Camera.from_config(SlamConfig(**KW), "cpu"),
        close=(convert.dataclass_to_numpy(jax.device_get(jm)), int(jls.last_loop_seq),
               bool(jacc), {k: int(v) for k, v in jdg.items()}),
        multi=(convert.dataclass_to_numpy(jax.device_get(jm2)), int(jls2.last_loop_seq),
               bool(jdone), int(jwhich)))


def _assert_map(got, want_np, label):
    got_np = convert.map_state_to_numpy(got)
    for k, want in want_np.items():
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got_np[k], want, err_msg=f"{label}: {k}", **MAP_TOL)
        else:
            np.testing.assert_array_equal(got_np[k], want, err_msg=f"{label}: {k}")


def test_close_step_matches_jax(scene):
    groups = torch.zeros(CAPS.n_feat, dtype=torch.int32)
    m2, ls2, accepted, dg = LC.close_step(
        port_map(scene["host"]), LC.empty_loop_state(P_CAPS, "cpu"), 9, 0, P_CAPS, scene["cam"],
        torch.as_tensor(SCALES), groups, groups, diag=True)
    want_map, want_seq, want_acc, want_dg = scene["close"]
    assert accepted == want_acc is True
    assert {k: dg[k] for k in GATES} == {k: want_dg[k] for k in GATES}
    assert int(ls2.last_loop_seq) == want_seq == 19
    _assert_map(m2, want_map, "close_step")

    # tests/test_loop_close.py's bounds on the port's correction
    gt, stored = scene["gt"], scene["stored"]
    poses = m2.kf_pose.numpy()

    def t_err(P_est, P_gt):
        return np.linalg.norm(P_est[:3, 3] - P_gt[:3, 3])

    assert bool(m2.loop_edges[9, 0]) and bool(m2.loop_edges[0, 9])
    assert t_err(poses[9], gt[9]) < 0.05
    assert t_err(poses[9], gt[9]) < 0.2 * t_err(stored[9], gt[9])
    before = sum(t_err(stored[i], gt[i]) for i in range(1, 8))
    after = sum(t_err(poses[i], gt[i]) for i in range(1, 8))
    assert after < 0.3 * before, (before, after)
    assert sum(t_err(poses[i], stored[i]) for i in range(1, 8)) > 0.01
    pts = m2.pt_pos.numpy()[:NP_PTS]
    assert np.linalg.norm(pts - np.asarray(scene["host"].pt_pos)[:NP_PTS], axis=1).max() < 0.05


def test_close_step_rejects_like_jax(scene):
    """The gap guard (a loop 10 insertions after the last one) and the
    generation guard reject before any correction: the map is untouched."""
    groups = torch.zeros(CAPS.n_feat, dtype=torch.int32)
    pm = port_map(scene["host"])
    ls = LC.empty_loop_state(P_CAPS, "cpu").replace(
        last_loop_seq=torch.tensor(15, dtype=torch.int32))
    m2, _, accepted, dg = LC.close_step(pm, ls, 9, 0, P_CAPS, scene["cam"], torch.as_tensor(SCALES),
                                        groups, groups, diag=True)
    assert not accepted and dg["gap_ok"] == 0 and dg["n_bow"] == scene["close"][3]["n_bow"]
    assert m2 is pm
    m3, _, accepted = LC.close_step(pm, LC.empty_loop_state(P_CAPS, "cpu"), 9, 0, P_CAPS,
                                    scene["cam"], torch.as_tensor(SCALES), groups, groups,
                                    cand_gen_expect=5)
    assert not accepted and m3 is pm


def test_close_step_multi_first_success(scene):
    m2, ls2, done, which = LC.close_step_multi(
        port_map(scene["multi_host"]), LC.empty_loop_state(P_CAPS, "cpu"), 9, 0, MULTI_CANDS,
        MULTI_GENS, 1000, P_CAPS, scene["cam"], torch.as_tensor(SCALES))
    want_map, want_seq, want_done, want_which = scene["multi"]
    assert (done, which) == (want_done, want_which) == (True, 0)
    assert int(ls2.last_loop_seq) == want_seq == 19
    _assert_map(m2, want_map, "close_step_multi")
    err = np.linalg.norm(m2.kf_pose.numpy()[9][:3, 3] - scene["gt"][9][:3, 3])
    assert err < 0.05, err


def test_projection_matches_break_ties_like_jax(scene):
    """The closer's two dense Hamming argmins (_search_by_sim3 and
    _sim3_projection_match: the exact +-1 matmul distances, excluded pairs at
    1 << 20) against JAX's, with KF9's first 48 keypoints duplicated into its
    free slots at the same pixel and octave (each such best distance tied
    between two columns: the lower index wins in both packages)."""
    host = scene["host"]
    n_dup = CAPS.n_feat - NP_PTS
    dup = {f: np.array(getattr(host, f)) for f in ("kf_desc", "kf_uv_und", "kf_octave",
                                                   "kf_kp_valid")}
    for f, a in dup.items():
        a[9, NP_PTS:] = a[9, :n_dup]
    jm = jax.tree.map(jnp.asarray, host).replace(**{f: jnp.asarray(a) for f, a in dup.items()})
    pm = port_map(jax.device_get(jm))
    jcam = JCamera.from_config(JConfig(**KW))
    sf = SCALES
    T1 = np.asarray(host.kf_pose)[9]
    jproj, jok = JLC._project_points(jm, jm.pt_valid, jnp.asarray(T1), jcam, jnp.asarray(sf))
    want = JLC._sim3_projection_match(jm, jproj, jok, 9, jcam, jnp.asarray(sf), 7.5)
    proj, ok = LC._project_points(pm, pm.pt_valid, torch.as_tensor(T1), scene["cam"],
                                  torch.as_tensor(sf))
    got = LC._sim3_projection_match(pm, proj, ok, 9, torch.as_tensor(sf), 7.5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got.numpy() >= 0) & (got.numpy() < n_dup)).sum() > 30  # the tied ones went low
    assert not (got.numpy() >= NP_PTS).any()

    T12 = np.linalg.inv(np.asarray(host.kf_pose)[0]) @ np.linalg.inv(T1)
    T12 = np.linalg.inv(T12).astype(np.float32)
    row1, row2 = np.asarray(host.kf_mp)[9], np.asarray(host.kf_mp)[0]
    live1, live2 = row1 >= 0, row2 >= 0
    pos = np.asarray(host.pt_pos)
    Ta, Tb = np.asarray(host.kf_pose)[9], np.asarray(host.kf_pose)[0]
    pc1 = (pos[np.maximum(row1, 0)] @ Ta[:3, :3].T + Ta[:3, 3]).astype(np.float32)
    pc2 = (pos[np.maximum(row2, 0)] @ Tb[:3, :3].T + Tb[:3, 3]).astype(np.float32)
    wk, wok = JLC._search_by_sim3(jm, 9, 0, jnp.asarray(T12), jnp.asarray(1.0), jnp.asarray(pc1),
                                  jnp.asarray(pc2), jnp.asarray(live1), jnp.asarray(live2), jcam,
                                  jnp.asarray(sf))
    gk, gok = LC._search_by_sim3(pm, 9, 0, torch.as_tensor(T12), torch.tensor(1.0),
                                 torch.as_tensor(pc1), torch.as_tensor(pc2),
                                 torch.as_tensor(live1), torch.as_tensor(live2), scene["cam"],
                                 torch.as_tensor(sf))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
