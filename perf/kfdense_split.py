"""Where the port and the JAX package part on main path 8a (kfdense): the
first keyframe event whose local BA takes another number of LM iterations.

JAX mode, on the CPU (needs the JAX package):

    python perf/kfdense_split.py --voc PATH [--event 6] [--save DIR] [--seeds 4]

runs the JAX package's SlamSystem over the first chunk of kfdense (frames
0-7, chunk=8, the card's vocabulary from ``perf/path8_probe.py --save-voc``),
records the input of its first background chunk and replays the mapping
chain from it step by step (cull_map_points, create_new_map_points,
search_in_neighbors, local BA, cull_keyframes) for each keyframe event up to
the one made at frame ``--event``. At that event's local BA it prints the LM
iterations of the JAX package's local BA and of the port's on the CPU from
the same map, then both under one-ulp moves of every live point (seeds
0..``--seeds``-1), and writes the map, the event and the JAX package's result
to DIR/ba_event<F>.npz.

Closure mode, on the CPU (needs the JAX package):

    python perf/kfdense_split.py --voc PATH --closure [--chunk-start 160]

runs the JAX package over kfdense up to the chunk that starts at
``--chunk-start`` (the chunk of the closure at frame 162), records that
chunk's background input (the map, the loop state, the keyframe events) and
runs both packages' ``background_chunk`` from it: the closure and its winner,
the LM iterations, the largest keyframe-pose difference, and each side's
keyframe trajectory error (the live keyframes' poses against the ground
truth at their timestamps, after alignment) before and after the chunk.

Card mode (no JAX needed):

    python3 perf/kfdense_split.py --ba DIR/ba_event6.npz [--device cuda]

runs the port's local BA from that map on the device and prints its LM
iterations and how far its poses and points land from the JAX package's.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from vo_slam_test_tpu_torch import bench, convert
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import local_ba as plba


def arg(name, default):
    return type(default)(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv else default


def port_ba(m_np, kf_id, stop, device):
    """The port's local BA from a numpy map -> (poses, points, (LM1, LM2))."""
    K, N = m_np["kf_mp"].shape
    P, O = m_np["pt_obs_kf"].shape
    _, cfg = bench.kfdense_sequence()
    ps = SlamSystem(cfg, caps=MapCaps(max_kf=K, max_pt=P, max_obs=O, n_feat=N), device=device)
    out, n1, n2 = plba.local_bundle_adjust_iters(
        convert.map_state_from_numpy(m_np, device), kf_id, ps.caps, ps.camera,
        1.0 / (ps.scale_factors * ps.scale_factors), stop=stop)
    return out.kf_pose.cpu().numpy(), out.pt_pos.cpu().numpy(), (int(n1), int(n2))


def against(label, pose, pt, it, ref_pose, ref_pt, moved, pv):
    print(f"  {label}: LM iterations {it}; against the JAX package on the unmoved map: max "
          f"|d pose| {np.abs(pose[moved] - ref_pose[moved]).max() if moved.any() else 0:.3e}, "
          f"max |d point| {np.abs(pt[pv] - ref_pt[pv]).max():.3e}", flush=True)


def card_mode() -> int:
    z = np.load(arg("--ba", ""))
    device = arg("--device", "cuda")
    m = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
    kf_id, stop = int(z["kf_id"]), bool(z["stop"])
    moved = np.abs(z["jax_kf_pose"] - m["kf_pose"]).max((1, 2)) > 0
    t0 = time.perf_counter()
    pose, pt, it = port_ba(m, kf_id, stop, device)
    print(f"{arg('--ba', '')}: keyframe slot {kf_id}; the JAX package's local BA on the CPU "
          f"took LM iterations {tuple(int(x) for x in z['jax_iters'])}; the port on {device} "
          f"({time.perf_counter() - t0:.1f} s):")
    against(f"port on {device}", pose, pt, it, z["jax_kf_pose"], z["jax_pt_pos"], moved,
            m["pt_valid"])
    return 0


def jax_mode() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
    import jax.numpy as jnp

    from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
    from vo_slam_test_tpu.config import SlamConfig as JConfig
    from vo_slam_test_tpu.pipeline import system as jsystem
    from vo_slam_test_tpu.slam_map import culling as jcull, fuse as jfuse
    from vo_slam_test_tpu.slam_map import triangulate as jtri
    from vo_slam_test_tpu.slam_map.map_state import MapState as JMapState
    from vo_slam_test_tpu.solvers import local_ba as jlba

    t0 = time.perf_counter()
    seq, cfg = bench.kfdense_sequence()
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")})
    js = jsystem.SlamSystem(jcfg, vocabulary=JVocabulary.load(arg("--voc", "")),
                            chunk=bench.CHUNK)
    rec, orig = {}, jsystem.background_chunk

    def recording(m, ls, did_kf, kf_id, interrupt_ba, *a, **k):
        if not rec:
            rec.update(m=jax.device_get(m), did=np.asarray(did_kf).tolist(),
                       kf_id=np.asarray(kf_id).tolist(), stop=bool(np.asarray(interrupt_ba)),
                       bgd=int(np.asarray(a[0])))
        return orig(m, ls, did_kf, kf_id, interrupt_ba, *a, **k)

    jsystem.background_chunk = recording
    for i in range(bench.CHUNK):
        js.track(*seq[i])
    js.results()
    jsystem.background_chunk = orig
    print(f"JAX on the CPU, frames 0-{bench.CHUNK - 1}: keyframe events {rec['did']}, LM "
          f"iterations {[tuple(int(v) for v in x) for x in js.ba_iters]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    event = arg("--event", 6)
    caps, cam, sf = js.caps, js.camera, js.scale_factors
    isig2 = 1.0 / (sf * sf)
    did = [bool(x) for x in rec["did"]]
    stops = np.asarray(jsystem.chunk_ba_stops(jnp.asarray(did))) | rec["stop"]
    m_host = rec["m"]
    for f in range(event + 1):
        if not did[f]:
            continue
        kid = jnp.asarray(rec["kf_id"][f], jnp.int32)
        m = jax.tree.map(jnp.asarray, m_host)
        m = jcull.cull_map_points(m, kid, caps)
        m = jtri.create_new_map_points(m, kid, caps, cam, sf,
                                       bow_group_div=jnp.asarray(rec["bgd"]))
        m = jfuse.search_in_neighbors(m, kid, caps, cam, sf)
        if f == event:
            m_host = jax.device_get(m)
            break
        m, _, _ = jlba.local_bundle_adjust_iters(m, kid, caps, cam, isig2,
                                                 stop=jnp.asarray(bool(stops[f])))
        m_host = jax.device_get(jcull.cull_keyframes(m, kid, caps, cam))
    m0 = convert.dataclass_to_numpy(m_host)
    kf_id, stop = int(rec["kf_id"][event]), bool(stops[event])

    def run_jax(m_np):
        out, n1, n2 = jlba.local_bundle_adjust_iters(
            JMapState(**{k: jnp.asarray(v) for k, v in m_np.items()}),
            jnp.asarray(kf_id, jnp.int32), caps, cam, isig2, stop=jnp.asarray(stop))
        return np.asarray(out.kf_pose), np.asarray(out.pt_pos), (int(n1), int(n2))

    ref_pose, ref_pt, ref_it = run_jax(m0)
    moved = np.abs(ref_pose - m0["kf_pose"]).max((1, 2)) > 0
    pv = m0["pt_valid"]
    print(f"the event at frame {event} (keyframe slot {kf_id}, interruptBA {stop}), its map "
          f"replayed from the chunk's input: {int(pv.sum())} live points; the JAX package's "
          f"local BA takes LM iterations {ref_it} (in its own run: "
          f"{[tuple(int(v) for v in x) for x in js.ba_iters if int(x[0]) == event]})")
    against("port on the CPU", *port_ba(m0, kf_id, stop, "cpu"), ref_pose, ref_pt, moved, pv)
    for seed in range(arg("--seeds", 4)):
        rng = np.random.default_rng(seed)
        pos = m0["pt_pos"].copy()
        up = rng.random(pos.shape) < 0.5
        nudged = np.where(up, np.nextafter(pos, np.inf), np.nextafter(pos, -np.inf))
        pos[pv] = nudged[pv]
        m = dict(m0, pt_pos=pos.astype(np.float32))
        against(f"JAX, live points moved one ulp (seed {seed})", *run_jax(m), ref_pose, ref_pt,
                moved, pv)
        against(f"port on the CPU, live points moved one ulp (seed {seed})",
                *port_ba(m, kf_id, stop, "cpu"), ref_pose, ref_pt, moved, pv)
    if "--save" in sys.argv:
        out = Path(arg("--save", "")) / f"ba_event{event}.npz"
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, kf_id=kf_id, stop=stop, jax_iters=np.asarray(ref_it),
                            jax_kf_pose=ref_pose, jax_pt_pos=ref_pt,
                            **{f"m_{k}": v for k, v in m0.items()})
        print(f"wrote {out}")
    return 0


def keyframe_ate(kf_pose, kf_valid, kf_ts, times, poses) -> float:
    """ATE (m) of the live keyframes' positions against the ground truth
    ``poses`` at ``times``."""
    from vo_slam_test_tpu_torch.datasets import ate_rmse

    v = np.nonzero(kf_valid)[0]
    return ate_rmse(times, poses, kf_ts[v], np.linalg.inv(kf_pose[v].astype(np.float64)))


def closure_mode() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)

    from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
    from vo_slam_test_tpu.config import SlamConfig as JConfig
    from vo_slam_test_tpu.pipeline import system as jsystem
    from vo_slam_test_tpu_torch.bow.vocabulary import Vocabulary
    from vo_slam_test_tpu_torch.pipeline import loop_closing
    from vo_slam_test_tpu_torch.pipeline import system as psystem

    t0 = time.perf_counter()
    start = arg("--chunk-start", 160)
    seq, cfg = bench.kfdense_sequence()
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")})
    jvoc = JVocabulary.load(arg("--voc", ""))
    js = jsystem.SlamSystem(jcfg, vocabulary=jvoc, chunk=bench.CHUNK)
    rec, orig = {}, jsystem.background_chunk

    def recording(m, ls, did_kf, kf_id, interrupt_ba, *a, **k):
        if js._frame_id != start:
            return orig(m, ls, did_kf, kf_id, interrupt_ba, *a, **k)
        # the input before the call: the step donates its buffers
        rec.update(m=jax.device_get(m), ls=jax.device_get(ls), did=np.asarray(did_kf).tolist(),
                   kf_id=np.asarray(kf_id).tolist(), stop=bool(np.asarray(interrupt_ba)),
                   bgd=int(np.asarray(a[0])))
        out = orig(m, ls, did_kf, kf_id, interrupt_ba, *a, **k)
        rec.update(m_out=jax.device_get(out[0]), packed=np.asarray(out[6]).tolist())
        return out

    jsystem.background_chunk = recording
    times = []
    for i in range(start + bench.CHUNK):
        frame = seq[i]
        times.append(frame[2])
        js.track(*frame)
    jax.block_until_ready(js.map.kf_pose)
    jsystem.background_chunk = orig
    did = [bool(x) for x in rec["did"]]
    kids = [int(k) if d else -1 for d, k in zip(did, rec["kf_id"])]
    print(f"JAX on the CPU to frame {start + bench.CHUNK - 1} ({time.perf_counter() - t0:.1f} "
          f"s): the chunk at frame {start}: keyframe events {did}, slots {kids}", flush=True)
    ps = psystem.SlamSystem(cfg, device="cpu", vocabulary=Vocabulary.load(arg("--voc", ""), "cpu"),
                            chunk=bench.CHUNK)
    ls = loop_closing.LoopState(**{k: torch.as_tensor(np.asarray(getattr(rec["ls"], k)))
                                   for k in ("groups", "counts", "n_groups", "last_loop_seq")})
    m_in = convert.dataclass_to_numpy(rec["m"])
    t1 = time.perf_counter()
    m, _, outs = psystem.background_chunk(
        convert.map_state_from_numpy(m_in, "cpu"), ls, did, kids, rec["stop"], ps.caps,
        ps.camera, ps.scale_factors, True, rec["bgd"])
    got = convert.map_state_to_numpy(m)
    want = convert.dataclass_to_numpy(rec["m_out"])
    j_rows = [tuple(r[:5]) for r, d in zip(rec["packed"], did) if d]
    p_rows = [(int(o.closed), o.which, int(o.attempted), o.ba_n1, o.ba_n2)
              for o, d in zip(outs, did) if d]
    print(f"the port's background_chunk from the same input on the CPU "
          f"({time.perf_counter() - t1:.1f} s): (closed, winner, attempted, LM1, LM2) per event "
          f"JAX {j_rows} port {p_rows}")
    kv = want["kf_valid"] & got["kf_valid"]
    print(f"  keyframe poses after the chunk: max |d pose| port against JAX "
          f"{np.abs(got['kf_pose'][kv] - want['kf_pose'][kv]).max():.3e} over {int(kv.sum())} "
          f"live keyframes")
    gt = seq.poses[:len(times)]
    for label, mm in (("before the chunk", m_in), ("after, JAX", want), ("after, port", got)):
        ate = keyframe_ate(mm["kf_pose"], mm["kf_valid"], mm["kf_timestamp"], times, gt)
        print(f"  keyframe ATE {label}: {ate * 100:.4f} cm", flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(card_mode() if "--ba" in sys.argv else
             closure_mode() if "--closure" in sys.argv else jax_mode())
