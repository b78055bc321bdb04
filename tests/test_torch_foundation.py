"""Port foundation vs the JAX package: config, lie, camera, pattern tables,
state conversion, the no-JAX import guard and the no-card rule.

Tolerance 1e-6 (absolute and relative) for the float32 geometry: both sides
run the same f32 formulas, so they agree to a few ulps.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import camera as jcamera
from vo_slam_test_tpu import config as jconfig
from vo_slam_test_tpu import lie as jlie
from vo_slam_test_tpu.datasets import synthetic as jsynthetic
from vo_slam_test_tpu.ops import pattern as jpattern
from vo_slam_test_tpu_torch import camera, config, convert, lie
from vo_slam_test_tpu_torch.datasets import synthetic
from vo_slam_test_tpu_torch.frontend.frame import MAX_FEATURES
from vo_slam_test_tpu_torch.ops import pattern
from vo_slam_test_tpu_torch.pipeline import tracking

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)

YAML = textwrap.dedent("""\
    %YAML:1.0
    dataset_dir: /data/rgbd_dataset_freiburg1_xyz
    camera_fx: 517.306408
    camera_fy: 516.469215
    camera_width: 640
    camera_k1: 0.262383
    num_of_features: 1000
    scale_factor: 1.2
    max_lost: 7
    some_unknown_key: 3
    """)


def test_config_same_keys_and_values():
    raw_j = jconfig._load_opencv_yaml(YAML, is_text=True)
    raw_p = config._load_opencv_yaml(YAML, is_text=True)
    assert raw_j == raw_p
    cj = jconfig.SlamConfig.from_dict(raw_j)
    cp = config.SlamConfig.from_dict(raw_p)
    assert dataclasses.asdict(cj) == dataclasses.asdict(cp)
    assert [f.name for f in dataclasses.fields(jconfig.SlamConfig)] == \
        [f.name for f in dataclasses.fields(config.SlamConfig)]
    assert cp.get("some_unknown_key") == 3
    fr1 = os.path.join(REPO, "configs", "tum_fr1.yaml")
    assert dataclasses.asdict(config.SlamConfig.from_yaml(fr1)) == \
        dataclasses.asdict(jconfig.SlamConfig.from_yaml(fr1))


def _twists(seed, n=64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-5          # near identity: Taylor branches
    xi[8:16, 3:] *= 0.3         # below the 0.5 rad switch
    ang = rng.uniform(np.pi - 5e-4, np.pi - 1e-5, 8)   # near pi
    axis = rng.normal(0, 1, (8, 3))
    xi[16:24, 3:] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * ang[:, None]).astype(np.float32)
    return xi


LIE_CASES = ["hat", "so3_exp", "so3_log", "se3_exp", "se3_log", "se3_inverse",
             "transform_points", "transform_point", "orthonormalize", "mat_to_quat",
             "quat_to_mat"]


@pytest.mark.parametrize("name", LIE_CASES)
def test_lie_matches_jax(name):
    xi = _twists(7)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    rng = np.random.default_rng(8)
    if name == "hat":
        args = (xi[:, :3],)
    elif name == "so3_exp":
        args = (xi[:, 3:],)
    elif name == "so3_log":
        args = (T[:, :3, :3],)
    elif name == "se3_exp":
        args = (xi,)
    elif name in ("se3_log", "se3_inverse", "orthonormalize"):
        args = (T,)
    elif name == "transform_points":
        args = (T, rng.normal(0, 2, (64, 20, 3)).astype(np.float32))
    elif name == "transform_point":
        args = (T, rng.normal(0, 2, (64, 3)).astype(np.float32))
    elif name == "mat_to_quat":
        args = (T[:, :3, :3],)
    else:
        args = (rng.normal(0, 1, (64, 4)).astype(np.float32),)
    want = np.asarray(getattr(jlie, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(lie, name)(*[torch.as_tensor(np.array(a)) for a in args]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _cfg_pair(**kw):
    return jconfig.SlamConfig(**kw), config.SlamConfig(**kw)


def test_camera_matches_jax():
    cj, cp = _cfg_pair()
    jc = jcamera.Camera.from_config(cj)
    pc = camera.Camera.from_config(cp, device="cpu")
    for f in ("fx", "fy", "cx", "cy", "bf", "b", "th_depth", "depth_scale", "dist_coef"):
        np.testing.assert_array_equal(getattr(pc, f).numpy(), np.asarray(getattr(jc, f)))
    assert (pc.width, pc.height, pc.fps, pc.any_dist) == (jc.width, jc.height, jc.fps, True)

    rng = np.random.default_rng(3)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    depth = rng.uniform(0.3, 6.0, 200).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(_twists(4)[30] * 0.2)))
    pw_j = np.asarray(jc.pixel2world(jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(T)))
    pw_p = pc.pixel2world(torch.as_tensor(uv), torch.as_tensor(depth), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(pw_p, pw_j, **TOL)
    np.testing.assert_allclose(
        pc.world2camera(torch.as_tensor(pw_j), torch.as_tensor(T)).numpy(),
        np.asarray(jc.world2camera(jnp.asarray(pw_j), jnp.asarray(T))), **TOL)
    np.testing.assert_allclose(
        pc.pixel2camera(torch.as_tensor(uv), torch.as_tensor(depth)).numpy(),
        np.asarray(jc.pixel2camera(jnp.asarray(uv), jnp.asarray(depth))), **TOL)
    np.testing.assert_array_equal(pc.K.numpy(), np.asarray(jc.K))
    p3 = np.concatenate([rng.normal(0, 2, (200, 2)), rng.uniform(-1, 6, (200, 1))], 1)
    p3[:3, 2] = [0.0, 1e-13, -1e-13]  # the near-zero depth guard
    p3 = p3.astype(np.float32)
    np.testing.assert_allclose(pc.camera2pixel(torch.as_tensor(p3)).numpy(),
                               np.asarray(jc.camera2pixel(jnp.asarray(p3))), **TOL)


def test_synthetic_renderer_matches_jax():
    """The port's renderer (used by chip_smoke.py) gives the JAX renderer's
    frames: same textures, poses to f32 rounding of se3_exp."""
    kw = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.6, cy=63.8, n_frames=30,
              seed=0, motion_scale=0.5)
    js, ps = jsynthetic.SyntheticRGBD(**kw), synthetic.SyntheticRGBD(**kw)
    np.testing.assert_allclose(ps.poses, js.poses, **TOL)
    for i in (0, 17):
        (gj, dj, tj), (gp, dp, tp) = js[i], ps[i]
        assert tj == tp
        assert np.mean(gj != gp) < 1e-3
        np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=1e-5)


def test_pattern_tables_equal():
    np.testing.assert_array_equal(pattern.bit_pattern_31(), jpattern.bit_pattern_31())
    np.testing.assert_array_equal(pattern.umax_table(), jpattern.umax_table())
    np.testing.assert_array_equal(pattern.circular_patch_mask(), jpattern.circular_patch_mask())


def test_convert_round_trip():
    rng = np.random.default_rng(5)
    n = MAX_FEATURES
    feats = {
        "uv": rng.uniform(0, 640, (n, 2)).astype(np.float32),
        "uv_und": rng.uniform(0, 640, (n, 2)).astype(np.float32),
        "response": rng.uniform(0, 50, n).astype(np.float32),
        "angle": rng.uniform(0, 360, n).astype(np.float32),
        "octave": rng.integers(0, 8, n).astype(np.int32),
        "depth": rng.uniform(-1, 5, n).astype(np.float32),
        "u_right": rng.uniform(-1, 640, n).astype(np.float32),
        "desc": rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        "valid": rng.random(n) < 0.7,
    }
    state = {"feats": feats, "T_c_w": np.eye(4, dtype=np.float32),
             "T_cl": rng.normal(size=(4, 4)).astype(np.float32),
             "motion_valid": np.asarray(True), "initialized": np.asarray(True)}
    s = convert.track_state_from_numpy(state, "cpu")
    assert s.feats.desc.dtype == torch.int32 and s.initialized is True
    back = convert.track_state_to_numpy(s)
    for k, v in feats.items():
        assert back["feats"][k].dtype == v.dtype
        np.testing.assert_array_equal(back["feats"][k], v)
    np.testing.assert_array_equal(back["T_cl"], state["T_cl"])
    assert back["motion_valid"] is True


GUARD = r"""
import ast, importlib, pkgutil, sys
sys.modules["jax"] = None
import vo_slam_test_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# chip_smoke.py imports most of its modules inside main(): import each one
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for alias in node.names:
            importlib.import_module(alias.name)
    elif isinstance(node, ast.ImportFrom):
        mod = importlib.import_module(node.module)
        for alias in node.names:
            if not hasattr(mod, alias.name):
                importlib.import_module(node.module + "." + alias.name)
bad = [m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "vo_slam_test_tpu" or m.startswith("vo_slam_test_tpu."))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_tracker_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tracking.FusedTracker(config.SlamConfig())
