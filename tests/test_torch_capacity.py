"""Twins of tests/test_capacity.py on the port, each held against the JAX
package on the same inputs: keyframe and point slots recycled after a cull,
generation bumps, the no-op insert into a full map, creation-ordered kf_seq
across recycling, and the generation-checked walks of recover_frame_pose.
Every map after an insert is compared field by field with JAX's (integer
fields equal, float fields within FLOAT_TOL of tests/torch_slam_helpers.py).

Plus the u16 depth scaling: SlamSystem.track scales raw u16 depth by the
config's depth scale on the device, where the JAX package scales it inside
``_slam_step`` (pipeline/system.py:197-201). The test holds the scaled image
the port's ``_track_one`` receives against the one JAX's front end receives;
it does not track (the u16 path fails in the reference, ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.frontend.frame import FrameFeatures as JFeatures
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu.slam_map import insert as j_insert
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JCaps
from vo_slam_test_tpu.slam_map.map_state import empty_map as j_empty_map
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import system
from vo_slam_test_tpu_torch.slam_map import insert as map_insert
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps, empty_map
from torch_slam_helpers import assert_maps_agree

CAPS = MapCaps(max_kf=8, max_pt=256, max_obs=8, n_feat=32)
J_CAPS = JCaps(max_kf=8, max_pt=256, max_obs=8, n_feat=32)
NO_DIST = dict(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
SCALES = 1.2 ** np.arange(8)


def feats_numpy(seed, n_valid=20):
    rng = np.random.default_rng(seed)
    N = CAPS.n_feat
    uv = rng.uniform([50, 50], [600, 430], (N, 2)).astype(np.float32)
    return dict(uv=uv, uv_und=uv, response=np.ones(N, np.float32), angle=np.zeros(N, np.float32),
                octave=np.zeros(N, np.int32), depth=np.full(N, 2.0, np.float32),
                u_right=np.full(N, -1.0, np.float32),
                desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint32), valid=np.arange(N) < n_valid)


class Pair:
    """The same map in both packages, inserted into side by side."""

    def __init__(self):
        self.cam = Camera.from_config(SlamConfig(**NO_DIST), "cpu")
        self.jcam = JCamera.from_config(JConfig(**NO_DIST))
        self.m = empty_map(CAPS, "cpu")
        self.jm = j_empty_map(J_CAPS)

    def insert(self, seed, T=None):
        f = feats_numpy(seed)
        T = np.eye(4, dtype=np.float32) if T is None else T
        N = CAPS.n_feat
        self.m, kid = map_insert.insert_keyframe(
            self.m, CAPS, convert.frame_features_from_numpy(f, "cpu"), torch.as_tensor(T),
            float(seed), seed, torch.full((N,), -1, dtype=torch.int32), torch.as_tensor(f["valid"]),
            self.cam, torch.as_tensor(SCALES, dtype=torch.float32))
        self.jm, jkid = j_insert.insert_keyframe(
            self.jm, J_CAPS, JFeatures(**{k: jnp.asarray(v) for k, v in f.items()}),
            jnp.asarray(T), jnp.asarray(float(seed)), jnp.asarray(seed, jnp.int32),
            jnp.full((N,), -1, jnp.int32), jnp.asarray(f["valid"]), self.jcam,
            jnp.asarray(SCALES, jnp.float32))
        assert kid == int(jkid)
        self.check(f"after inserting seed {seed}")
        return kid

    def set(self, **fields):
        """Write the same values into a field of both maps: name -> (index, value)."""
        for name, (idx, val) in fields.items():
            t = getattr(self.m, name).clone()
            t[idx] = torch.as_tensor(val)
            self.m = self.m.replace(**{name: t})
            j_idx = np.asarray(idx) if isinstance(idx, list) else idx
            self.jm = self.jm.replace(**{name: getattr(self.jm, name).at[j_idx].set(val)})

    def check(self, label):
        assert_maps_agree(self.m, jax.device_get(self.jm), label)


class TestCapacityLifecycle:
    def test_kf_slot_reuse_bumps_generation(self):
        p = Pair()
        for i in range(CAPS.max_kf):
            assert p.insert(i) == i
        p.set(kf_valid=(3, False))
        gen3 = int(p.m.kf_gen[3])
        assert p.insert(100) == 3
        assert bool(p.m.kf_valid[3]) and int(p.m.kf_gen[3]) == gen3 + 1
        assert not p.m.loop_edges[3].any()

    def test_point_slots_recycled(self):
        p = Pair()
        P = CAPS.max_pt
        valid = np.zeros(P, bool)
        valid[: P - 40] = True
        p.set(pt_valid=(slice(None), valid))
        p.m = p.m.replace(n_pt=torch.tensor(P - 40, dtype=torch.int32))
        p.jm = p.jm.replace(n_pt=jnp.asarray(P - 40, jnp.int32))
        want = np.arange(CAPS.n_feat) < 30
        ids = map_insert.allocate_point_slots(p.m, torch.as_tensor(want)).numpy()
        np.testing.assert_array_equal(ids, np.asarray(j_insert.allocate_point_slots(p.jm, jnp.asarray(want))))
        got = ids[want]
        assert (got >= P - 40).all() and (got < P - 1).all()
        p.set(pt_valid=([5, 17], False))
        ids2 = map_insert.allocate_point_slots(p.m, torch.as_tensor(want)).numpy()
        np.testing.assert_array_equal(ids2, np.asarray(j_insert.allocate_point_slots(p.jm, jnp.asarray(want))))
        assert ids2[want][0] == 5 and ids2[want][1] == 17

    def test_full_map_allocates_nothing(self):
        p = Pair()
        p.set(pt_valid=(slice(None), True))
        want = np.arange(CAPS.n_feat) < 10
        ids = map_insert.allocate_point_slots(p.m, torch.as_tensor(want)).numpy()
        np.testing.assert_array_equal(ids, np.asarray(j_insert.allocate_point_slots(p.jm, jnp.asarray(want))))
        assert (ids[want] == -1).all()


class TestGenerationGuards:
    def test_insert_into_full_map_is_noop(self):
        p = Pair()
        for i in range(CAPS.max_kf):
            p.insert(i)
        before = convert.map_state_to_numpy(p.m)
        assert p.insert(99, T=np.diag([1, 1, 1, 1.0]).astype(np.float32)) == -1
        after = convert.map_state_to_numpy(p.m)
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        assert int(p.m.n_kf_ever) == CAPS.max_kf

    def test_kf_seq_is_creation_ordered_across_recycling(self):
        p = Pair()
        for i in range(CAPS.max_kf):
            p.insert(i)
        p.set(kf_valid=(2, False))
        assert p.insert(50) == 2
        assert int(p.m.kf_seq[2]) == CAPS.max_kf and int(p.m.kf_gen[2]) == 2

    def test_pt_gen_bumps_on_slot_reuse(self):
        p = Pair()
        p.insert(0)
        gen_before = p.m.pt_gen.clone()
        p.set(pt_valid=(5, False))
        p.insert(1)
        assert bool(p.m.pt_valid[5]) and int(p.m.pt_gen[5]) == int(gen_before[5]) + 1


class TestTrajectoryRecovery:
    """recover_frame_pose's generation-checked walk, against JAX's."""

    def _arrays(self, K=4):
        return dict(kf_pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
                    kf_valid=np.ones(K, bool), kf_gen=np.ones(K, np.int32),
                    cull_parent=np.full(K, -1, np.int32), cull_parent_gen=np.full(K, -1, np.int32),
                    cull_gen=np.full(K, -1, np.int32),
                    kf_tcp=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)))

    def _both(self, ref, gen, T_cr, raw, a):
        got = system.recover_frame_pose(ref, gen, T_cr, raw, **a)
        np.testing.assert_array_equal(got, jsystem.recover_frame_pose(ref, gen, T_cr, raw, **a))
        return got

    def test_live_matching_gen_composes(self):
        a = self._arrays()
        a["kf_pose"][1, :3, 3] = [1.0, 0, 0]
        out = self._both(1, 1, np.eye(4, dtype=np.float32), np.full((4, 4), 9.0, np.float32), a)
        np.testing.assert_allclose(out[:3, 3], [1.0, 0, 0])

    def test_culled_chain_walks_through_archive(self):
        a = self._arrays()
        a["kf_valid"][1] = False
        a["cull_gen"][1] = 1
        a["cull_parent"][1] = 0
        a["cull_parent_gen"][1] = 1
        a["kf_tcp"][1, :3, 3] = [2.0, 0, 0]
        out = self._both(1, 1, np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32), a)
        np.testing.assert_allclose(out[:3, 3], [2.0, 0, 0])

    def test_reused_parent_slot_refuses_wrong_generation(self):
        a = self._arrays()
        a["kf_valid"][1] = False
        a["cull_gen"][1] = 1
        a["cull_parent"][1] = 0
        a["cull_parent_gen"][1] = 1
        a["kf_gen"][0] = 2
        a["cull_gen"][0] = -1
        raw = np.eye(4, dtype=np.float32)
        raw[:3, 3] = [7.0, 7, 7]
        out = self._both(1, 1, np.eye(4, dtype=np.float32), raw, a)
        np.testing.assert_allclose(out[:3, 3], [7.0, 7, 7])

    def test_reused_ref_slot_with_lost_archive_bails(self):
        a = self._arrays()
        a["kf_gen"][2] = 3
        a["cull_gen"][2] = 2
        raw = np.eye(4, dtype=np.float32)
        raw[:3, 3] = [5.0, 0, 0]
        out = self._both(2, 1, np.eye(4, dtype=np.float32), raw, a)
        np.testing.assert_allclose(out[:3, 3], [5.0, 0, 0])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("scale", [5000.0, 1000.0])
def test_u16_depth_scaling_equals_jax(monkeypatch, scale):
    """The port's SlamSystem.track and the JAX package's _slam_step scale a
    u16 depth image to the same f32 metres, bit for bit."""
    rng = np.random.default_rng(4)
    depth = rng.integers(0, 65536, (48, 64), dtype=np.uint16)
    depth[0, :4] = [0, 1, 65535, 5000]
    gray = np.zeros((48, 64), np.uint8)
    kw = dict(NO_DIST, camera_width=64, camera_height=48, camera_depthScale=scale)
    got = {}

    def capture_port(self, gray_d, depth_d, ts):
        got["port"] = depth_d.numpy()

    monkeypatch.setattr(system.SlamSystem, "_track_one", capture_port)
    system.SlamSystem(SlamConfig(**kw), caps=CAPS, device="cpu").track(gray, depth, 0.0)

    def capture_jax(gray_, depth_img, *a, **k):
        got["jax"] = np.asarray(depth_img)
        raise _Stop

    monkeypatch.setattr(jsystem, "extract_fused", capture_jax)
    js = jsystem.SlamSystem(JConfig(**kw), caps=J_CAPS)
    with pytest.raises(_Stop):
        jsystem._slam_step(js.state, js.map, jnp.asarray(gray), jnp.asarray(depth), 0.0,
                           js._depth_scale, js.camera, js.caps, js.spec, js.budgets,
                           js.scale_factors, js.inv_level_sigma2, js.fast_hi, js.fast_lo,
                           js.max_frame_gap, None, False)
    assert got["port"].dtype == got["jax"].dtype == np.float32
    np.testing.assert_array_equal(got["port"], got["jax"])
