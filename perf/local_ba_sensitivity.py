"""How much the JAX package's own local BA moves when its input moves by one
float32 ulp, beside how far the port's local BA lands from it, on the CPU.
Input: a map just before a keyframe event's local BA, as
``perf/loop_path5_split.py --substeps --save-ba DIR`` writes it
(DIR/ba_frame<F>.npz: the JAX package's map on main path 5, with the event's
keyframe slot and interruptBA flag).

For seeds 0..``--seeds``-1, every coordinate of every live point is moved
one ulp up or down at random (np.nextafter), and both packages' local BA run
on that input. Prints, for each run, the LM iterations of the two passes and
the largest difference of the window keyframes' poses and the live points
from the JAX package's run on the unmoved input.

    python perf/local_ba_sensitivity.py DIR/ba_frame36.npz [--seeds 4]
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
from vo_slam_test_tpu.solvers import local_ba as jlba
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import local_ba as plba

torch.set_num_threads(4)


def main() -> int:
    z = np.load(sys.argv[1])
    n_seeds = int(sys.argv[sys.argv.index("--seeds") + 1]) if "--seeds" in sys.argv else 4
    kf_id, stop = int(z["kf_id"]), bool(z["stop"])
    m0 = {k: z[k] for k in z.files if k not in ("kf_id", "stop")}
    K, N = m0["kf_mp"].shape
    P, O = m0["pt_obs_kf"].shape
    caps = MapCaps(max_kf=K, max_pt=P, max_obs=O, n_feat=N)
    jcaps = JMapCaps(max_kf=K, max_pt=P, max_obs=O, n_feat=N)
    _, cfg = cs.pan_sequence()
    cam = Camera.from_config(cfg, "cpu")
    jcam = JCamera.from_config(JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")}))
    sf = SlamSystem(cfg, caps=caps, device="cpu").scale_factors.numpy()
    isig2 = 1.0 / (sf * sf)

    def run_jax(m):
        out, n1, n2 = jlba.local_bundle_adjust_iters(
            JMapState(**{k: jnp.asarray(v) for k, v in m.items()}), jnp.asarray(kf_id, jnp.int32),
            jcaps, jcam, jnp.asarray(isig2), stop=jnp.asarray(stop))
        return np.asarray(out.kf_pose), np.asarray(out.pt_pos), (int(n1), int(n2))

    def run_port(m):
        out, n1, n2 = plba.local_bundle_adjust_iters(
            convert.map_state_from_numpy(m, "cpu"), kf_id, caps, cam, torch.as_tensor(isig2),
            stop=stop)
        return out.kf_pose.numpy(), out.pt_pos.numpy(), (int(n1), int(n2))

    ref_pose, ref_pt, ref_it = run_jax(m0)
    moved = np.abs(ref_pose - m0["kf_pose"]).max((1, 2)) > 0
    pv = m0["pt_valid"]
    print(f"{sys.argv[1]}: keyframe slot {kf_id}, interruptBA {stop}; {int(pv.sum())} live "
          f"points; the JAX package's local BA moves keyframe slots "
          f"{np.nonzero(moved)[0].tolist()} (largest pose change "
          f"{np.abs(ref_pose - m0['kf_pose']).max():.3e}) in LM iterations {ref_it}")

    def line(label, pose, pt, it):
        print(f"  {label}: LM iterations {it}; against the JAX package on the unmoved input: max "
              f"|d pose| {np.abs(pose[moved] - ref_pose[moved]).max() if moved.any() else 0:.3e}, "
              f"max |d point| {np.abs(pt[pv] - ref_pt[pv]).max():.3e}", flush=True)

    line("port, unmoved input", *run_port(m0))
    for seed in range(n_seeds):
        rng = np.random.default_rng(seed)
        pos = m0["pt_pos"].copy()
        up = rng.random(pos.shape) < 0.5
        nudged = np.where(up, np.nextafter(pos, np.inf), np.nextafter(pos, -np.inf))
        pos[pv] = nudged[pv]
        m = dict(m0, pt_pos=pos.astype(np.float32))
        line(f"JAX, points moved one ulp (seed {seed})", *run_jax(m))
        line(f"port, points moved one ulp (seed {seed})", *run_port(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
