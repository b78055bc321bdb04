"""Global BA on one map in four ways, on the CPU: the map main path 5 holds
right after its loop closure on the card, as ``perf/pan_loop_probe.py
--gba-trace --dump-gba PATH 4g`` writes it (with the card's global BA output
beside it). Runs the JAX package's ``global_bundle_adjust`` in float32 and
with x64 on (the map cast to float64), and the port's on the CPU, and holds
the card's result against each: the robust cost before and after (the
port's cost function, float64) and the largest pose and point differences
over live slots.

    python perf/gba_same_map.py PATH
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.slam_map.map_state import MapState as JMapState
from vo_slam_test_tpu.solvers.global_ba import global_bundle_adjust as j_gba
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import global_ba as G


def main() -> int:
    z = np.load(sys.argv[1])
    m_in = {k[3:]: z[k] for k in z.files if k.startswith("in_")}
    card = {k[4:]: z[k] for k in z.files if k.startswith("out_")}
    isig2 = z["inv_level_sigma2"]
    fixed = int(z["fixed_kf"])
    K, N = m_in["kf_mp"].shape
    P, O = m_in["pt_obs_kf"].shape
    caps = MapCaps(max_kf=K, max_pt=P, max_obs=O, n_feat=N)
    jcaps = JMapCaps(max_kf=K, max_pt=P, max_obs=O, n_feat=N)
    _, cfg = cs.pan_sequence()
    cam = Camera.from_config(cfg, "cpu")
    jcam = JCamera.from_config(JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")}))
    pm_in = convert.map_state_from_numpy(m_in, "cpu")
    t_isig2 = torch.as_tensor(isig2)
    kv, pv = m_in["kf_valid"], m_in["pt_valid"]
    c0, n_obs = cs.gba_cost(pm_in, cam, t_isig2)
    print(f"map: {int(kv.sum())} live keyframes, {int(pv.sum())} live points, {n_obs} "
          f"observations; robust cost before {c0:.6f}; fixed keyframe {fixed}")

    results = {"card (port, float64 solve)": card}
    pm_out = G.global_bundle_adjust(pm_in, caps, cam, fixed, inv_level_sigma2=t_isig2)
    results["port on the CPU"] = convert.map_state_to_numpy(pm_out)
    jm = JMapState(**{k: jnp.asarray(v) for k, v in m_in.items()})
    out = j_gba(jm, jcaps, jcam, jnp.asarray(fixed, jnp.int32), inv_level_sigma2=jnp.asarray(isig2))
    results["JAX float32"] = dict(m_in, kf_pose=np.asarray(out.kf_pose),
                                  pt_pos=np.asarray(out.pt_pos))
    jax.config.update("jax_enable_x64", True)
    jm64 = JMapState(**{k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
                        for k, v in m_in.items()})
    out = j_gba(jm64, jcaps, jcam, jnp.asarray(fixed, jnp.int32),
                inv_level_sigma2=jnp.asarray(isig2.astype(np.float64)))
    results["JAX x64"] = dict(m_in, kf_pose=np.asarray(out.kf_pose).astype(np.float32),
                              pt_pos=np.asarray(out.pt_pos).astype(np.float32))
    for name, r in results.items():
        m = convert.map_state_from_numpy(dict(m_in, kf_pose=r["kf_pose"], pt_pos=r["pt_pos"]),
                                         "cpu")
        c1, _ = cs.gba_cost(m, cam, t_isig2)
        dpose = np.abs(r["kf_pose"][kv] - m_in["kf_pose"][kv]).max()
        dpt = np.abs(r["pt_pos"][pv] - m_in["pt_pos"][pv]).max()
        vs = np.abs(card["kf_pose"][kv] - r["kf_pose"][kv]).max()
        vs_pt = np.abs(card["pt_pos"][pv] - r["pt_pos"][pv]).max()
        print(f"{name}: robust cost after {c1:.6f}; max |pose change| {dpose:.3e}, max |point "
              f"change| {dpt:.3e}; against the card: max |d pose| {vs:.3e}, max |d point| "
              f"{vs_pt:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
