"""Loop closing inside the background step: the port's
background_step(with_loop=True) against the JAX package's, on
tests/test_loop_close.py's drifted chain given a shared place's BoW words in
KF0 and KF9 (and one featVec bucket for their keypoints).

Four keyframe events of KF9 run the mapping chain (local BA interrupted),
then detection: the first three build the consistency group, the fourth
confirms KF0 and the Sim3 verification and correction run inline, serially
after detection, as in the JAX package's ``_background_one``. After every
round the confirmed candidates, the loop state and the map's integer and
bool fields equal JAX's, and its float fields agree within 1e-4 (the pose
graph's f32 sums run in another order). The JAX run (one ~60 s compile of
its background program) is shared by the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import loop_closing as JLC
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.pipeline import system
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from test_loop_close import CAPS, NP_PTS, build_drifted_loop_map
from torch_slam_helpers import port_map

torch.set_num_threads(1)
P_CAPS = MapCaps(max_kf=CAPS.max_kf, max_pt=CAPS.max_pt, max_obs=CAPS.max_obs,
                 n_feat=CAPS.n_feat)
KW = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
SCALES = np.asarray(1.2 ** np.arange(8), np.float32)
GROUP_DIV = 1000
ROUNDS = 4


def place_map(jcam):
    """The drifted chain with KF0 and KF9 sharing one place's 40 words (the
    others random), their keypoints in featVec bucket 0, and every point
    found once per visible once (so the point culling keeps KF9's points)."""
    m, gt, stored = build_drifted_loop_map(jcam)
    rng = np.random.default_rng(3)
    K, N = CAPS.max_kf, CAPS.n_feat
    words = np.full((K, N), 1 << 30, np.int32)
    weights = np.zeros((K, N), np.float32)
    place = np.sort(rng.choice(4096, 40, replace=False))
    for k in range(10):
        words[k, :40] = place if k in (0, 9) else np.sort(rng.choice(4096, 40, replace=False))
        weights[k, :40] = 1.0 / 40
    kf_word = np.asarray(m.kf_word).copy()
    kf_word[0, :NP_PTS] = 0
    kf_word[9, :NP_PTS] = 0
    seen = m.pt_valid.astype(jnp.int32)
    return m.replace(kf_bow_word=jnp.asarray(words), kf_bow_weight=jnp.asarray(weights),
                     kf_word=jnp.asarray(kf_word), pt_found=seen, pt_visible=seen), gt


@pytest.fixture(scope="module")
def jax_rounds():
    jcam = JCamera.from_config(JConfig(**KW))
    m, gt = place_map(jcam)
    start = jax.device_get(m)
    m = jax.tree.map(jnp.asarray, start)  # one buffer per field: the step donates them
    ls = JLC.empty_loop_state(CAPS)
    rounds = []
    for _ in range(ROUNDS):
        m, ls, cand, cand_gen, closed, which, packed = jsystem.background_step(
            m, ls, jnp.asarray(True), jnp.asarray(9, jnp.int32), jnp.asarray(True),
            jnp.asarray(GROUP_DIV, jnp.int32), CAPS, jcam, jnp.asarray(SCALES), True)
        rounds.append(dict(map=convert.dataclass_to_numpy(jax.device_get(m)),
                           ls=convert.dataclass_to_numpy(jax.device_get(ls)),
                           cand=np.asarray(cand), closed=bool(closed), which=int(which)))
    return dict(start=start, gt=gt, rounds=rounds)


def test_background_step_closes_like_jax(jax_rounds):
    cam = Camera.from_config(SlamConfig(**KW), "cpu")
    pm = port_map(jax_rounds["start"])
    ls = LC.empty_loop_state(P_CAPS, "cpu")
    for r, want in enumerate(jax_rounds["rounds"]):
        pm, ls, out = system.background_step(pm, ls, True, 9, True, P_CAPS, cam,
                                             torch.as_tensor(SCALES), True, GROUP_DIV)
        assert (out.attempted, out.closed, out.which) == (
            bool((want["cand"] >= 0).any()), want["closed"], want["which"]), r
        for f, v in want["ls"].items():
            np.testing.assert_array_equal(getattr(ls, f).numpy(), v, err_msg=f"round {r}: {f}")
        got = convert.map_state_to_numpy(pm)
        for k, v in want["map"].items():
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                           err_msg=f"round {r}: {k}")
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=f"round {r}: {k}")
    # the fourth detection confirms KF0 and the loop closes inline
    assert [w["closed"] for w in jax_rounds["rounds"]] == [False, False, False, True]
    assert out.attempts[0][:2] == (0, True) and out.attempts[0][2]["n_bow"] == NP_PTS
    err = np.linalg.norm(pm.kf_pose.numpy()[9][:3, 3] - jax_rounds["gt"][9][:3, 3])
    assert err < 0.05, err
