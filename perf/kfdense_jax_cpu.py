"""The JAX package's SlamSystem on the CPU over the benchmark's kfdense
scenario, configured exactly as ``bench.py`` (repo root) configures it: the
240-frame room orbit (``room_orbit_trajectory(240, loops=1.5)``,
``scene="room"``, seed 7) at 640x480 with f32 depth, ``SlamSystem(cfg,
vocabulary=voc, chunk=8)`` at the default ``MapCaps``, loop closing inline.
The vocabulary is the one the port trained on the card (``python3
perf/path8_probe.py --save-voc PATH`` writes it), so both packages run with
the same words.

    timeout 5400 python perf/kfdense_jax_cpu.py --voc PATH [--out JSON] [--frames N]

Prints one line per chunk, then the frames tracked, the keyframe frames,
``n_kf_ever``, the loop closures and attempts, the LM iterations per
keyframe event and the ATE; ``--out`` writes them with the per-frame counts
(ok, keyframe decision, features, matches, inliers), positions (the
trajectory ``results()`` recovers, the raw tracked pose, the ground truth)
and how each frame's pose was recovered (reference keyframe and generation,
directly, through culled keyframes or the raw pose) as JSON, which
PERF.md's comparison with main path 8a reads. It is the "JAX on the CPU"
reference of main path 8a (~12 minutes: the rendering, the CPU compile of
the chunked steps, the run)."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np

from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
from vo_slam_test_tpu.config import SlamConfig
from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu.datasets.staging import render_all
from vo_slam_test_tpu.datasets.synthetic import room_orbit_trajectory
from vo_slam_test_tpu.datasets.tum import ate_rmse
from vo_slam_test_tpu.pipeline.system import SlamSystem


def arg(name, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def recovery_route(ref, gen, kf_valid, kf_gen, cull_parent, cull_parent_gen, cull_gen, **_):
    """How ``recover_frame_pose`` reaches a frame's pose: ("direct", 0) from
    its reference keyframe, ("chain", hops) through culled keyframes' parents,
    or ("raw", hops) when a generation mismatch severs the chain."""
    hops = 0
    while ref >= 0 and hops < 64:
        if kf_valid[ref] and kf_gen[ref] == gen:
            return ("direct" if hops == 0 else "chain"), hops
        if cull_gen[ref] != gen:
            break
        gen, ref = int(cull_parent_gen[ref]), int(cull_parent[ref])
        hops += 1
    return "raw", hops


def main() -> int:
    t0 = time.perf_counter()
    n_frames, loops = 240, 1.5
    traj = room_orbit_trajectory(n_frames, loops=loops)
    seq = SyntheticRGBD(trajectory=traj, scene="room", seed=7)
    cfg = SlamConfig(
        camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
        camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0, camera_fps=30)
    grays, depths, times = render_all(seq, n_frames, f"orbit{loops}")
    frames = [(g, d.astype(np.float32), t) for g, d, t in zip(grays, depths, times)]
    frames = frames[:int(arg("--frames", n_frames))]
    voc = JVocabulary.load(arg("--voc"))
    print(f"rendered {len(frames)} frames, vocabulary k={voc.k} levels={voc.levels} from "
          f"{arg('--voc')} in {time.perf_counter() - t0:.1f} s", flush=True)
    js = SlamSystem(cfg, vocabulary=voc, chunk=8)
    for i, f in enumerate(frames):
        js.track(*f)
        if not js._chunk_buf:
            print(f"frame {i} done at {time.perf_counter() - t0:.1f} s", flush=True)
    traj_est, stats, _ = js.results()
    rows = js._per_frame(jax.device_get(js._outs))
    per_frame = [dict(ok=bool(r.ok), made_kf=bool(r.made_kf), n_features=int(r.n_features),
                      n_matches=int(r.n_matches), n_inliers=int(r.n_inliers)) for r in rows]
    gt = np.stack([seq.poses[i] for i in range(len(frames))])
    maps = {k: np.asarray(getattr(js.map, k)) for k in (
        "kf_valid", "kf_gen", "cull_parent", "cull_parent_gen", "cull_gen")}
    ate = ate_rmse(js.timestamps, gt, js.timestamps, traj_est)
    out = dict(frames=len(frames), tracked=sum(s.ok for s in stats),
               keyframe_frames=[i for i, r in enumerate(per_frame) if r["made_kf"]],
               n_kf_ever=int(np.asarray(js.map.n_kf_ever)),
               closures=[int(x) for x in js.loop_closures],
               attempts=[tuple(int(v) if not isinstance(v, bool) else v for v in a[:3])
                         for a in js.loop_attempts],
               ba_iters=[tuple(int(v) for v in x) for x in js.ba_iters],
               n_ba_interrupts=int(js.n_ba_interrupts), ate_m=float(ate),
               n_keyframes=int(js.n_keyframes), n_points=int(js.n_points),
               wall_s=time.perf_counter() - t0, per_frame=per_frame,
               position_m=np.asarray(traj_est)[:, :3, 3].tolist(),
               raw_position_m=[np.linalg.inv(np.asarray(r.T_c_w))[:3, 3].tolist() for r in rows],
               gt_position_m=gt[:, :3, 3].tolist(),
               recovery=[(int(r.ref_kf), int(r.ref_gen)) + recovery_route(
                   int(r.ref_kf), int(r.ref_gen), **maps) for r in rows])
    print(f"JAX on the CPU, kfdense chunk=8: tracked {out['tracked']}/{out['frames']}; keyframe "
          f"frames {out['keyframe_frames']} ({len(out['keyframe_frames'])}); n_kf_ever "
          f"{out['n_kf_ever']}; closures {out['closures']}; attempts {out['attempts']}; LM "
          f"iterations {out['ba_iters']}; ba_interrupts {out['n_ba_interrupts']}; ATE "
          f"{ate * 100:.4f} cm; live keyframes {out['n_keyframes']}, points {out['n_points']}; "
          f"wall {out['wall_s']:.1f} s")
    if arg("--out"):
        with open(arg("--out"), "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
