"""The JAX package's SlamSystem on the CPU over main path 5's scenario: the
pan loop of tests/test_loop_e2e.py at 640x480 (chip_smoke.pan_sequence),
chunk=4, MapCaps(max_kf=32, max_pt=8192), with the vocabulary the port builds
(chip_smoke.pan_vocabulary on the CPU, written to an .npz and read back by
the JAX package) and the drift injected by the JAX package's
``utils/drift.py::inject_drift`` after frame 27, cut at the keyframe count
after frame 19.

    timeout 3000 python perf/loop_path5_jax_cpu.py [--diag] [--host-voc | --voc PATH] [--sever-both]

``--diag`` runs the JAX package's VO_LOOP_DIAG path (each Sim3 attempt
dispatched from the host with its gate values, drained every frame);
``--host-voc`` builds the vocabulary from the JAX package's host
OrbExtractor instead, as tests/test_loop_e2e.py does; ``--voc PATH`` reads
an .npz (the card's: ``python3 perf/pan_loop_probe.py --save-voc PATH`` on
the card writes it). ``--sever-both`` also
severs the old keyframes' bindings to island points and their observer
entries on them after the JAX package's instrument
(``chip_smoke.pan_sever_old``, main path 5's drift). ``--gba`` turns
on the JAX package's global BA after a closure and prints how far it moved
the live keyframes and points.

Prints the loop closures, the frames tracked, the island keyframes' median
residual against their pre-drift poses, the ATE and the wall time; it is the
"JAX on the CPU" reference of main path 5 in PERF.md (about 15 minutes)."""

import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.utils.drift import inject_drift
from vo_slam_test_tpu_torch.datasets import ate_rmse


def host_vocabulary(seq, jcfg):
    """tests/test_loop_e2e.py's vocabulary: the JAX host OrbExtractor."""
    from vo_slam_test_tpu.bow.vocabulary import build_vocabulary
    from vo_slam_test_tpu.camera import Camera
    from vo_slam_test_tpu.frontend.extractor import OrbExtractor

    ext = OrbExtractor(Camera.from_config(jcfg), n_features=1000)
    descs = []
    for i in cs.PAN_VOC_FRAMES:
        g, d, _ = seq[i]
        f = ext(g, d)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    return build_vocabulary(np.concatenate(descs), k=8, levels=3, seed=3)


def main() -> int:
    diag = "--diag" in sys.argv
    if diag:
        os.environ["VO_LOOP_DIAG"] = "1"
    t0 = time.perf_counter()
    seq, cfg = cs.pan_sequence()
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2", "camera_p1",
        "camera_p2", "camera_k3", "camera_fps")})
    if "--host-voc" in sys.argv:
        jvoc = host_vocabulary(seq, jcfg)
        cents = [np.asarray(c) for c in jvoc.centroids]
    elif "--voc" in sys.argv:
        jvoc = JVocabulary.load(sys.argv[sys.argv.index("--voc") + 1])
        cents = [np.asarray(c) for c in jvoc.centroids]
    else:
        voc = cs.pan_vocabulary(seq, cfg, "cpu")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "pan_voc.npz")
            voc.save(path)
            jvoc = JVocabulary.load(path)
        cents = [c.cpu().numpy().view(np.uint32) for c in voc.centroids]
    print(f"vocabulary k={jvoc.k} levels={jvoc.levels} from frames {cs.PAN_VOC_FRAMES} "
          f"({'host OrbExtractor' if '--host-voc' in sys.argv else 'the port'}"
          f"{' on the card, ' + sys.argv[sys.argv.index('--voc') + 1] if '--voc' in sys.argv else ''});"
          f" centroid sum "
          f"{sum(int(c.astype(np.uint64).sum()) for c in cents)}; diag {diag}", flush=True)
    js = JSlamSystem(jcfg, caps=JMapCaps(max_kf=32, max_pt=8192), vocabulary=jvoc,
                     chunk=cs.PAN_CHUNK, drain_chunk=1, enable_global_ba="--gba" in sys.argv)
    if "--gba" in sys.argv:
        from vo_slam_test_tpu.solvers import global_ba as jgba

        orig_gba = jgba.global_bundle_adjust

        def traced_gba(m, *a, **k):
            out = orig_gba(m, *a, **k)
            kv, pv = np.asarray(m.kf_valid), np.asarray(m.pt_valid)
            dp = np.abs(np.asarray(out.kf_pose) - np.asarray(m.kf_pose))[kv].max()
            dx = np.abs(np.asarray(out.pt_pos) - np.asarray(m.pt_pos))[pv].max()
            print(f"global BA: {int(kv.sum())} keyframes, {int(pv.sum())} points; max |pose "
                  f"change| {dp:.3e}, max |point change| {dx:.3e}", flush=True)
            return out
        jgba.global_bundle_adjust = traced_gba
    D = cs.pan_drift()
    kf_cut = pre_poses = pre_valid = None
    for i in range(len(seq)):
        js.track(*seq[i])
        if i == cs.PAN_CUT_FRAME:
            kf_cut = max(int(np.asarray(js.map.n_kf)), 1)
        if i == cs.PAN_DRIFT_FRAME:
            pre_poses = np.asarray(js.map.kf_pose).copy()
            pre_valid = np.asarray(js.map.kf_valid).copy()
            js.map, ar = inject_drift(js.map, js.state.assign_real,
                                      jnp.asarray(kf_cut, jnp.int32), jnp.asarray(D))
            js.state = js.state.replace(assign_real=ar)
            if "--sever-both" in sys.argv:
                js.map = js.map.replace(**{k: jnp.asarray(v) for k, v in
                                           cs.pan_sever_old(js.map, kf_cut).items()})
        extra = ""
        if pre_poses is not None and not js._chunk_buf:
            res_i = cs.island_residual(pre_poses, pre_valid, kf_cut, np.asarray(js.map.kf_pose))
            extra = (f"; island residual {res_i.round(4).tolist()}, island slots' kf_seq "
                     f"{np.asarray(js.map.kf_seq)[kf_cut:kf_cut + len(res_i)].tolist()}")
        print(f"frame {i} done at {time.perf_counter() - t0:.1f} s{extra}", flush=True)
    traj, stats, _ = js.results()
    oks = [s.ok for s in stats]
    res = cs.island_residual(pre_poses, pre_valid, kf_cut, np.asarray(js.map.kf_pose))
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    ate = ate_rmse(js.timestamps, gt, js.timestamps, traj)
    print(f"JAX on the CPU, chunk={cs.PAN_CHUNK}: tracked {sum(oks)}/{len(oks)}; kf_cut {kf_cut}; "
          f"loop closures at frames {js.loop_closures}; attempts (frame, candidate, accepted) "
          f"{js.loop_attempts}; loop edges {np.argwhere(np.asarray(js.map.loop_edges)).tolist()}; "
          f"island residual median {float(np.median(res)):.6f} m (gate "
          f"{0.35 * float(np.linalg.norm(D[:3, 3])):.4f}), per keyframe {res.round(6).tolist()}; "
          f"ATE {ate * 100:.4f} cm; keyframes live {js.n_keyframes}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
