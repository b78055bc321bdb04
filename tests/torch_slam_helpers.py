"""Shared set-up of the port's map and system parity tests
(tests/test_torch_map.py, test_torch_mapping.py, test_torch_system.py,
test_torch_local_ba.py, test_torch_reloc.py, test_torch_reloc_run.py): the
room-orbit sequence at 320x240, its config, the JAX system runs over its first
24 frames shared by those files (interruptBA forced, and local BA on), the
kidnap scenario at 320x240 with its vocabulary and its JAX run, the map
comparison, and both packages' runs over the 640x480 off-nominal scenes
(test_torch_scenarios.py, test_torch_system_b.py)."""

import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu.frontend.extractor import extract_fused as j_extract_fused
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
from vo_slam_test_tpu.slam_map import culling as jculling
from vo_slam_test_tpu.slam_map import fuse as jfuse
from vo_slam_test_tpu.slam_map import triangulate as jtri
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.solvers import local_ba as jlba
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

# The tests run as several pytest-xdist workers on one machine's cores: one
# intra-op thread per worker keeps PyTorch's OpenMP threads from spinning
# against the other workers (a third of the CPU time of these files).
torch.set_num_threads(1)

W, H = 320, 240
J_CAPS = JMapCaps(max_kf=16, max_pt=4096)
P_CAPS = MapCaps(max_kf=16, max_pt=4096)
# both sides round in f32 but sum in another order (matmul, SVD, norms)
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
N_FRAMES = 24
MAP_AT = 5    # test_torch_map: the map after frames 0-4 (keyframes 0 and 1)
KF_FRAME = 12  # a keyframe event with points left to triangulate and fuse merges


def room_sequence():
    """The JAX package's room orbit (bench.py's sequence) at half width."""
    return SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                         cy=255.3 * 0.5, trajectory=room_orbit_trajectory(240, loops=1.5),
                         scene="room", seed=7)


def room_kw(seq):
    """Config keys: 4 levels, 500 features, no distortion."""
    return dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500,
                camera_fps=30)


def jax_system(seq):
    """A JAX SlamSystem with interruptBA forced (its camera, pyramid and
    scale constants)."""
    js = JSlamSystem(JConfig(**room_kw(seq)), caps=J_CAPS)
    js._force_interrupt_ba = True
    return js


def _jax_room_run():
    """The JAX SlamSystem over frames 0..N_FRAMES-1, all as numpy:
    - stats: per frame n_features, n_matches, n_inliers, ok, made_kf, T;
    - traj, n_keyframes, n_points;
    - pre: {MAP_AT, KF_FRAME: (state, map) just before that frame};
    - feats: frame MAP_AT's features from the JAX front end; post: the map
      after frame KF_FRAME;
    - chain: the map after frame KF_FRAME's keyframe insert, then after each
      step of the JAX mapping chain run on it step by step (cull_map_points,
      create_new_map_points, search_in_neighbors, cull_keyframes; local BA
      is skipped at its entry), and kf, that keyframe's slot."""
    seq = room_sequence()
    js = jax_system(seq)
    run = dict(stats=[], pre={})
    slam_step = jsystem.slam_step

    def recording_slam_step(*args, **kw):
        st, m, out = slam_step(*args, **kw)
        if len(run["stats"]) == KF_FRAME:  # before background_step donates m
            run["chain"] = [jax_map_host(m)]
            run["kf"] = int(out.ref_kf)
        return st, m, out

    jsystem.slam_step = recording_slam_step
    try:
        for i in range(N_FRAMES):
            g, d, ts = seq[i]
            if i in (MAP_AT, KF_FRAME):
                run["pre"][i] = (jax.device_get(js.state), jax_map_host(js.map))
            if i == MAP_AT:
                ext = jax.jit(j_extract_fused, static_argnums=(3, 4))
                run["feats"] = jax.device_get(ext(jnp.asarray(g), jnp.asarray(d), js.camera,
                                                  js.spec, js.budgets, js.fast_hi, js.fast_lo))
            js.track(g, d, ts)
            o = jax.device_get(js._outs[-1])
            run["stats"].append(dict(
                n_features=int(o.n_features), n_matches=int(o.n_matches),
                n_inliers=int(o.n_inliers), ok=bool(o.ok), made_kf=bool(o.made_kf),
                T=np.asarray(o.T_c_w)))
            if i == KF_FRAME:
                run["post"] = jax_map_host(js.map)
    finally:
        jsystem.slam_step = slam_step
    run["traj"] = js.results()[0]
    run["n_keyframes"], run["n_points"] = js.n_keyframes, js.n_points
    k = jnp.asarray(run["kf"], jnp.int32)
    # each step jitted, as the system's mapping step runs it (one compile,
    # not one per primitive)
    for step in (lambda m: jculling.cull_map_points(m, k, J_CAPS),
                 lambda m: jtri.create_new_map_points(m, k, J_CAPS, js.camera, js.scale_factors),
                 lambda m: jfuse.search_in_neighbors(m, k, J_CAPS, js.camera, js.scale_factors),
                 lambda m: jculling.cull_keyframes(m, k, J_CAPS, js.camera)):
        run["chain"].append(jax_map_host(jax.jit(step)(jax_map_fresh(run["chain"][-1]))))
    return run


def _jax_room_run_ba(tmp_path_factory):
    """The JAX SlamSystem with local BA on every keyframe event (interruptBA
    lowered, its default) over frames 0..N_FRAMES-1, as numpy: stats, traj,
    n_keyframes, n_points as ``_jax_room_run``; and ba_step: JAX's
    ``local_bundle_adjust_iters`` (jitted, as the mapping step runs it) on the
    forced run's map after frame KF_FRAME's fuse (``chain[3]``) with its
    keyframe -> (map, n1, n2)."""
    seq = room_sequence()
    js = JSlamSystem(JConfig(**room_kw(seq)), caps=J_CAPS)
    run = dict(stats=[])
    for i in range(N_FRAMES):
        js.track(*seq[i])
        o = jax.device_get(js._outs[-1])
        run["stats"].append(dict(
            n_features=int(o.n_features), n_matches=int(o.n_matches),
            n_inliers=int(o.n_inliers), ok=bool(o.ok), made_kf=bool(o.made_kf),
            T=np.asarray(o.T_c_w)))
    run["traj"] = js.results()[0]
    run["n_keyframes"], run["n_points"] = js.n_keyframes, js.n_points
    forced = jax_room_run(tmp_path_factory)
    step = jax.jit(jlba.local_bundle_adjust_iters, static_argnames=("caps",))
    m, n1, n2 = step(jax_map_fresh(forced["chain"][3]), jnp.asarray(forced["kf"], jnp.int32),
                     J_CAPS, js.camera, 1.0 / (js.scale_factors * js.scale_factors))
    run["ba_step"] = (jax_map_host(m), int(n1), int(n2))
    return run


_RUNS = {}


def _shared_run(tmp_path_factory, name, fn):
    """``fn(tmp_path_factory)`` once per test session: the first test file to
    ask runs it and leaves it in the session's temp root; under pytest-xdist
    the other workers wait on a lock there and read it."""
    if name not in _RUNS:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # shared by the session's workers
        path = root / f"{name}.pkl"
        with open(root / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():
                _RUNS[name] = pickle.loads(path.read_bytes())
            else:
                _RUNS[name] = fn(tmp_path_factory)
                path.with_suffix(".tmp").write_bytes(pickle.dumps(_RUNS[name]))
                os.replace(path.with_suffix(".tmp"), path)
    return _RUNS[name]


def jax_room_run(tmp_path_factory):
    """``_jax_room_run`` once per test session (``_shared_run``)."""
    return _shared_run(tmp_path_factory, "jax_room_run", lambda _: _jax_room_run())


def jax_room_run_ba(tmp_path_factory):
    """``_jax_room_run_ba`` once per test session (``_shared_run``)."""
    return _shared_run(tmp_path_factory, "jax_room_run_ba", _jax_room_run_ba)


def jax_map_host(m):
    """A JAX MapState as a MapState of numpy arrays (survives donation)."""
    return jax.device_get(m)


def jax_map_fresh(m_host):
    """New device arrays for a jitted JAX function that donates its map."""
    return jax.tree.map(jnp.asarray, m_host)


def port_map(m_host):
    return convert.map_state_from_numpy(convert.dataclass_to_numpy(m_host), "cpu")


def assert_maps_agree(port, jax_map, label):
    """Integer and bool fields equal; float fields within FLOAT_TOL."""
    got = convert.map_state_to_numpy(port)
    want_all = convert.dataclass_to_numpy(jax_map) if not isinstance(jax_map, dict) else jax_map
    for k, want in want_all.items():
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[k], want, err_msg=f"{label}: {k}", **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=f"{label}: {k}")


# ---------------------------------------------------------------------------
# the kidnap scenario (tests/test_reloc.py) at 320x240
# ---------------------------------------------------------------------------


def kidnap_frames(seq, depth_poor=False):
    """Frames 0-7, three black frames, then frames 2-5 again (without depth
    when ``depth_poor``) -> 15 (gray, depth, timestamp)."""
    h, w = seq.height, seq.width
    black_g, no_d = np.zeros((h, w), np.uint8), np.zeros((h, w), np.float32)
    return ([seq[i] for i in range(8)] + [(black_g, no_d, 8.0 + j) for j in range(3)]
            + [(seq[i][0], no_d if depth_poor else seq[i][1], 20.0 + i) for i in range(2, 6)])


def kidnap_small():
    """SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3) at 320x240, its
    config keys (4 levels, 500 features), the 15 kidnap frames, and the
    vocabulary both packages build (k=8, levels=3, seed=2) from the port's
    extract_fused descriptors of frames 0-2 -> dict(seq, kw, frames, descs)."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.frontend.extractor import extract_fused
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    seq = SyntheticRGBD(n_frames=12, seed=31, motion_scale=0.3, width=W, height=H,
                        fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5, cy=255.3 * 0.5)
    kw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
              camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
              camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)
    ps = SlamSystem(SlamConfig(**kw), caps=P_CAPS, device="cpu")
    descs = []
    for i in range(3):
        g, d, _ = seq[i]
        f = extract_fused(torch.as_tensor(g), torch.as_tensor(d), ps.camera, ps.spec, ps.budgets)
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    return dict(seq=seq, kw=kw, frames=kidnap_frames(seq), descs=np.concatenate(descs))


def per_frame_rows(outs):
    """SlamOut list (either package) -> per-frame dicts of numpy/Python values."""
    o = jax.device_get(outs)
    return [dict(ok=bool(x.ok), relocalized=bool(x.relocalized), n_features=int(x.n_features),
                 n_matches=int(x.n_matches), n_inliers=int(x.n_inliers), made_kf=bool(x.made_kf),
                 T=np.asarray(x.T_c_w)) for x in o]


def _jax_kidnap_run(_):
    """The JAX SlamSystem (loop closing on, its default with a vocabulary)
    over the 320x240 kidnap: per-frame rows, its state and map before each
    frame and its map after the last, as numpy; its relocalization frames and
    loop closures."""
    from vo_slam_test_tpu.bow import vocabulary as JV

    k = kidnap_small()
    js = JSlamSystem(JConfig(**k["kw"]), caps=J_CAPS,
                     vocabulary=JV.build_vocabulary(k["descs"], k=8, levels=3, seed=2))
    pre = []
    for g, d, ts in k["frames"]:
        pre.append(tuple(convert.dataclass_to_numpy(jax.device_get(x)) for x in (js.state, js.map)))
        js.track(g, d, ts)
    js.results()
    return dict(rows=per_frame_rows(js._outs), pre=pre,
                post=convert.dataclass_to_numpy(jax.device_get(js.map)),
                reloc_frames=js.reloc_frames, loop_closures=list(js.loop_closures))


def jax_kidnap_run(tmp_path_factory):
    """``_jax_kidnap_run`` once per test session (``_shared_run``)."""
    return _shared_run(tmp_path_factory, "jax_kidnap_run", _jax_kidnap_run)


# ---------------------------------------------------------------------------
# the off-nominal scenes and Milestone B (tests/test_scenarios.py,
# tests/test_system.py) at 640x480
# ---------------------------------------------------------------------------


def scene_runs(seq_kws, caps=(32, 8192)):
    """Per sequence (keyword dicts of the JAX package's SyntheticRGBD): the
    JAX SlamSystem and the port's ``SlamSystem(device="cpu")`` (no
    vocabulary, local BA on, ``MapCaps(max_kf, max_pt)``) over the same JAX
    frames -> {name: dict(jax=..., port=..., rmse_gt)}; each side: ok,
    n_matches, n_inliers per frame, keyframe frames, ATE against the JAX
    sequence's poses, n_keyframes, n_points, the keyframe trajectory's
    length and first pose."""
    from vo_slam_test_tpu.datasets.tum import ate_rmse
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    out = {}
    for name, kw in seq_kws.items():
        seq = SyntheticRGBD(**kw)
        frames = [seq[i] for i in range(len(seq))]
        gt = np.stack([seq.poses[i] for i in range(len(seq))])
        ckw = dict(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                   camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
        runs = {}
        # the port first: under pytest-xdist another worker may run JAX meanwhile
        for impl in ("port", "jax"):
            if impl == "jax":
                s = JSlamSystem(JConfig(**ckw), caps=JMapCaps(*caps))
            else:
                s = SlamSystem(SlamConfig(**ckw), caps=MapCaps(*caps), device="cpu")
            for g, d, ts in frames:
                s.track(g, d, ts)
            traj, stats, kf_traj = s.results()
            runs[impl] = dict(
                ok=[bool(x.ok) for x in stats], n_matches=[int(x.n_matches) for x in stats],
                n_inliers=[int(x.n_inliers) for x in stats],
                kf_frames=[i for i, o in enumerate(jax.device_get(s._outs)) if bool(o.made_kf)],
                ate=float(ate_rmse(s.timestamps, gt, s.timestamps, traj)),
                n_keyframes=s.n_keyframes, n_points=s.n_points, n_kf_traj=len(kf_traj),
                kf_traj_first=np.asarray(kf_traj[0][1]) if kf_traj else None)
        out[name] = runs
    return out


def assert_scene_parity(r, match_band, inlier_band):
    """A ``scene_runs`` entry: the keyframe frames and every frame's ok equal,
    per-frame matches and inliers within the given bands."""
    j, p = r["jax"], r["port"]
    assert p["kf_frames"] == j["kf_frames"], (p["kf_frames"], j["kf_frames"])
    assert p["ok"] == j["ok"]
    dm = np.abs(np.subtract(p["n_matches"], j["n_matches"]))
    di = np.abs(np.subtract(p["n_inliers"], j["n_inliers"]))
    assert dm.max() <= match_band and di.max() <= inlier_band, (dm.tolist(), di.tolist())
