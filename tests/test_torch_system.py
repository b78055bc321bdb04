"""End to end: the port's SlamSystem (tracking against the local map, the
keyframe policy, keyframe insertion and the mapping chain with interruptBA
forced) against the JAX SlamSystem on the first 24 frames of the room orbit
(the JAX package's SyntheticRGBD, scene "room", seed 7, room_orbit_trajectory
(240, loops=1.5)) at 320x240, 4 levels, 500 features,
MapCaps(max_kf=16, max_pt=4096). JAX gives keyframes at frames 0, 1, 5, 12,
13 and 20.

Per frame: n_features, n_matches, n_inliers, ok and the keyframe decision
equal, poses within 1e-4; final keyframe and point counts equal. Plus one step
from the JAX system's exact state and map just before the keyframe frame 12,
which isolates a step's parity from drift: its counts and its whole map after
the mapping chain (insert, point culling, triangulation, fuse, keyframe
culling) against JAX's. Integer map fields must be equal. Float fields agree
to rtol 1e-4 / atol 1e-5: both sides round in f32 but sum in another order
(matmul, SVD), observed well inside that. The JAX side is the session's one
JAX run (tests/torch_slam_helpers.py).
"""

import numpy as np
import pytest

from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import ate_rmse
from vo_slam_test_tpu_torch.pipeline import system
from torch_slam_helpers import (KF_FRAME as STEP_AT, N_FRAMES, P_CAPS, assert_maps_agree,
                                jax_room_run, room_kw, room_sequence)

JAX_KF_FRAMES = [0, 1, 5, 12, 13, 20]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    seq = room_sequence()
    kw = room_kw(seq)
    frames = [seq[i] for i in range(N_FRAMES)]
    # the port first: under pytest-xdist the JAX run may meanwhile be under
    # way in another worker
    ps = system.SlamSystem(SlamConfig(**kw), caps=P_CAPS, device="cpu")
    ps._force_interrupt_ba = True
    for g, d, ts in frames:
        ps.track(g, d, ts)
    p_traj, p_stats, _ = ps.results()
    jr = jax_room_run(tmp_path_factory)
    pre = tuple(convert.dataclass_to_numpy(x) for x in jr["pre"][STEP_AT])
    post = convert.dataclass_to_numpy(jr["post"])
    gt = np.stack([seq.poses[i] for i in range(N_FRAMES)])
    return dict(seq=seq, kw=kw, frames=frames, jr=jr, ps=ps, j_stats=jr["stats"],
                j_traj=jr["traj"], p_traj=p_traj, p_stats=p_stats, pre=pre, post=post, gt=gt)


def test_slam_system_matches_jax_per_frame(run):
    j_stats, p_stats, ps = run["j_stats"], run["p_stats"], run["ps"]
    assert [i for i, s in enumerate(j_stats) if s["made_kf"]] == JAX_KF_FRAMES
    assert len(p_stats) == N_FRAMES and all(s.ok for s in p_stats)
    for i, (j, p, o) in enumerate(zip(j_stats, p_stats, ps._outs)):
        assert (p.n_features, p.n_matches, p.n_inliers, p.ok, o.made_kf) == \
            (j["n_features"], j["n_matches"], j["n_inliers"], j["ok"], j["made_kf"]), i
        np.testing.assert_allclose(o.T_c_w.numpy(), j["T"], atol=1e-4, err_msg=f"frame {i}")
    np.testing.assert_allclose(run["p_traj"], run["j_traj"], atol=1e-4)


def test_final_map_counts_match_jax(run):
    jr, ps = run["jr"], run["ps"]
    assert (ps.n_keyframes, ps.n_points) == (jr["n_keyframes"], jr["n_points"])
    ate_p = ate_rmse(ps.timestamps, run["gt"], ps.timestamps, run["p_traj"])
    ate_j = ate_rmse(ps.timestamps, run["gt"], ps.timestamps, run["j_traj"])
    assert abs(ate_p - ate_j) < 1e-4 and ate_p < 0.03
    assert [n for _, n, _ in ps.ba_iters] == [0] * len(JAX_KF_FRAMES)  # BA skipped at entry


def test_one_keyframe_step_from_jax_state(run):
    """Frame 12 alone, from the JAX system's state and map just before it:
    tracking, the keyframe insert and the whole mapping chain."""
    pre_state, pre_map = run["pre"]
    ps = system.SlamSystem(SlamConfig(**run["kw"]), caps=P_CAPS,
                           device="cpu")
    ps.state = convert.slam_track_state_from_numpy(pre_state, "cpu")
    ps.map = convert.map_state_from_numpy(pre_map, "cpu")
    assert_maps_agree(ps.map, pre_map, "round trip")
    ps._force_interrupt_ba = True
    ps.track(*run["frames"][STEP_AT])
    o, want = ps._outs[-1], run["j_stats"][STEP_AT]
    assert (int(o.n_features), int(o.n_matches), int(o.n_inliers), bool(o.ok), o.made_kf) == \
        (want["n_features"], want["n_matches"], want["n_inliers"], want["ok"], want["made_kf"])
    assert o.made_kf
    np.testing.assert_allclose(o.T_c_w.numpy(), want["T"], atol=1e-4)
    assert_maps_agree(ps.map, run["post"], "after the keyframe step")


def test_interrupt_lowered_runs_ba(run):
    """With interruptBA lowered (the default) the keyframe events run local
    BA: frame 1's event runs both LM passes."""
    ps = system.SlamSystem(SlamConfig(**run["kw"]), caps=P_CAPS,
                           device="cpu")
    assert ps._force_interrupt_ba is None and not ps._ba_interrupt()
    for g, d, ts in run["frames"][:2]:
        ps.track(g, d, ts)
    assert [f for f, _, _ in ps.ba_iters] == [0, 1]
    _, n1, n2 = ps.ba_iters[1]
    assert n1 > 0 and n2 > 0


@pytest.mark.slow  # the JAX system over 9 frames at 640x480 on the CPU: ~2-3 min
def test_640_count_difference_is_f32_order():
    """At 640x480 (the smoke run's sequence, interruptBA forced) the port on
    the CPU first differs from JAX in a count at frame 9 (665 against 664
    matches), with poses 5e-8 to 3e-7 apart from frame 1 on. The difference
    is f32 rounding alone: from JAX's own state and map just before frame 9
    the port gives JAX's counts exactly. The first op whose outputs differ
    from the same inputs is the pinhole projection ``fx * x * invz + cx`` of
    the pose solver's residuals, up to 6e-5 px apart (XLA's CPU code rounds
    the chain differently; both sides stay within its rounding bound); the normal
    equations' f32 sums over ~1000 matches then differ in their summation
    order, each side within the sum's rounding bound n eps sum|terms| of the
    float64 sum."""
    import jax
    import jax.numpy as jnp
    import torch

    from vo_slam_test_tpu.config import SlamConfig as JConfig
    from vo_slam_test_tpu.datasets import SyntheticRGBD as JSyntheticRGBD
    from vo_slam_test_tpu.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
    from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    seq = JSyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0, camera_fps=30)
    js = JSlamSystem(JConfig(**kw), caps=JMapCaps())
    js._force_interrupt_ba = True
    for i in range(9):
        js.track(*seq[i])
    pre_state = convert.dataclass_to_numpy(jax.device_get(js.state))
    pre_map = convert.dataclass_to_numpy(jax.device_get(js.map))
    js.track(*seq[9])
    want = jax.device_get(js._outs[-1])
    ps = system.SlamSystem(SlamConfig(**kw), caps=MapCaps(), device="cpu")
    ps._force_interrupt_ba = True
    ps.state = convert.slam_track_state_from_numpy(pre_state, "cpu")
    ps.map = convert.map_state_from_numpy(pre_map, "cpu")
    ps.track(*seq[9])
    got = ps._outs[-1]
    assert (int(got.n_matches), int(got.n_inliers)) == (int(want.n_matches), int(want.n_inliers))
    np.testing.assert_allclose(got.T_c_w.numpy(), np.asarray(want.T_c_w), atol=1e-6)

    rng = np.random.default_rng(0)
    x, invz = rng.uniform(-2, 2, 1000).astype(np.float32), rng.uniform(0.2, 0.5, 1000).astype(
        np.float32)
    fx, cx = np.float32(seq.fx), np.float32(seq.cx)
    u_jax = np.asarray(jax.jit(lambda a, b: fx * a * b + cx)(x, invz))
    u_port = (torch.tensor(fx) * torch.as_tensor(x) * torch.as_tensor(invz) + torch.tensor(cx)).numpy()
    prod64 = np.float64(fx) * x * invz
    u_bound = 3 * np.finfo(np.float32).eps * (np.abs(prod64) + abs(float(cx)))
    assert (u_jax != u_port).any()  # the two round the chain differently...
    for u in (u_jax, u_port):       # ...each within its rounding bound of float64
        assert (np.abs(u - (prod64 + np.float64(cx))) <= u_bound).all()

    Jw = rng.normal(0, 300, (1000, 3, 6)).astype(np.float32)
    m = rng.uniform(0, 1, 1000).astype(np.float32)
    h_jax = np.asarray(jnp.einsum("nri,nrj,n->ij", Jw, Jw, m))
    h_port = torch.einsum("nri,nrj,n->ij", torch.as_tensor(Jw), torch.as_tensor(Jw),
                          torch.as_tensor(m)).numpy()
    J64, m64 = Jw.astype(np.float64), m.astype(np.float64)
    h64 = np.einsum("nri,nrj,n->ij", J64, J64, m64)
    bound = 3000 * np.finfo(np.float32).eps * np.einsum("nri,nrj,n->ij", np.abs(J64),
                                                          np.abs(J64), m64)
    assert (np.abs(h_jax - h64) <= bound).all() and (np.abs(h_port - h64) <= bound).all()
    assert (np.abs(h_jax - h_port) <= bound).all()
