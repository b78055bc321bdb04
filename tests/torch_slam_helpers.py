"""Shared set-up of the port's map and system parity tests
(tests/test_torch_map.py, test_torch_mapping.py, test_torch_system.py): the
room-orbit sequence at 320x240, its config, one JAX system run over its first
24 frames shared by the three files, and the map comparison."""

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


_RUN = None


def jax_room_run(tmp_path_factory):
    """``_jax_room_run`` once per test session: the first test file to ask
    runs it and leaves it in the session's temp root; under pytest-xdist the
    other workers wait on a lock there and read it."""
    global _RUN
    if _RUN is None:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent  # shared by the session's workers
        path = root / "jax_room_run.pkl"
        with open(root / "jax_room_run.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():
                _RUN = pickle.loads(path.read_bytes())
            else:
                _RUN = _jax_room_run()
                path.with_suffix(".tmp").write_bytes(pickle.dumps(_RUN))
                os.replace(path.with_suffix(".tmp"), path)
    return _RUN


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
