"""Where the port and the JAX package part on main path 5 after the loop
closes, on the CPU: the JAX package's SlamSystem runs the pan loop
(chip_smoke.pan_sequence, chunk=4, MapCaps(max_kf=32, max_pt=8192), the
vocabulary of chip_smoke.pan_vocabulary built on the CPU, the drift injected
by the JAX package's inject_drift then chip_smoke.pan_sever_old); every
background_chunk call from frame ``--from`` on is recorded, and the port's
background_chunk is run from the same input (the JAX map and loop state,
keyframe flags and ids, interruptBA) and compared with the JAX output:
closure and winner, the largest pose and point differences over live slots,
the integer fields that differ, and the island keyframes' residual against
their pre-drift poses after each. ``--substeps`` also runs each keyframe
event's mapping chain step by step in both packages (cull_map_points,
create_new_map_points, search_in_neighbors, local BA, cull_keyframes) from
the JAX state before the event, and with ``--save-ba DIR`` writes the JAX
map before each event's local BA to DIR/ba_frame<F>.npz (for
perf/local_ba_sensitivity.py). ``--port-run`` also runs the port's own
SlamSystem over the whole scenario and prints its island residual per chunk.

    timeout 3000 python perf/loop_path5_split.py [--from 36] [--substeps [--save-ba DIR]]
        [--port-run]
"""

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
import torch

import chip_smoke as cs
from vo_slam_test_tpu.bow.vocabulary import Vocabulary as JVocabulary
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu.pipeline.system import SlamSystem as JSlamSystem
from vo_slam_test_tpu.slam_map.map_state import MapCaps as JMapCaps
from vo_slam_test_tpu.utils.drift import inject_drift as j_inject_drift
from vo_slam_test_tpu_torch import convert
from vo_slam_test_tpu_torch.pipeline import loop_closing, system as psystem
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.utils.drift import inject_drift

torch.set_num_threads(4)
INT_FIELDS_SHOWN = 6


def arg(name, default):
    return type(default)(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv else default


def port_map(m_host):
    return convert.map_state_from_numpy(convert.dataclass_to_numpy(m_host), "cpu")


def port_loop_state(ls_host):
    return loop_closing.LoopState(**{k: torch.as_tensor(np.asarray(getattr(ls_host, k)))
                                     for k in ("groups", "counts", "n_groups", "last_loop_seq")})


def compare(label, port, jax_host, island=None):
    """One line: largest live pose / point differences and the integer fields
    that differ (with the count of differing entries)."""
    got = convert.map_state_to_numpy(port)
    want = convert.dataclass_to_numpy(jax_host)
    kv = np.asarray(want["kf_valid"]) & got["kf_valid"]
    pv = np.asarray(want["pt_valid"]) & got["pt_valid"]
    dpose = float(np.abs(got["kf_pose"][kv] - want["kf_pose"][kv]).max()) if kv.any() else 0.0
    dpt = float(np.abs(got["pt_pos"][pv] - want["pt_pos"][pv]).max()) if pv.any() else 0.0
    ints = {}
    for k, w in want.items():
        w = np.asarray(w)
        if not np.issubdtype(w.dtype, np.floating):
            n = int((got[k] != w).sum())
            if n:
                ints[k] = n
    shown = dict(list(sorted(ints.items(), key=lambda kv_: -kv_[1]))[:INT_FIELDS_SHOWN])
    extra = ""
    if island is not None:
        pre, pre_valid, kf_cut = island
        r_p = cs.island_residual(pre, pre_valid, kf_cut, got["kf_pose"])
        r_j = cs.island_residual(pre, pre_valid, kf_cut, np.asarray(want["kf_pose"]))
        extra = f"; island residual port {r_p.round(4).tolist()} JAX {r_j.round(4).tolist()}"
    print(f"  {label}: max |d pose| {dpose:.3e}, max |d point| {dpt:.3e}, integer fields "
          f"differing {shown}{extra}", flush=True)
    return dpose, dpt, ints


def substeps(ps, m_host, kf_id, stop, bow_group_div, frame, island):
    """The mapping chain of one keyframe event, step by step in both
    packages from the same JAX map, each step from JAX's previous output."""
    from vo_slam_test_tpu.slam_map import culling as jcull, fuse as jfuse
    from vo_slam_test_tpu.slam_map import triangulate as jtri
    from vo_slam_test_tpu.solvers import local_ba as jlba
    from vo_slam_test_tpu_torch.slam_map import culling as pcull, fuse as pfuse
    from vo_slam_test_tpu_torch.slam_map import triangulate as ptri
    from vo_slam_test_tpu_torch.solvers import local_ba as plba

    jcaps, jcam, jsf = JSTATE["caps"], JSTATE["cam"], JSTATE["sf"]
    caps, cam, sf = ps.caps, ps.camera, ps.scale_factors
    kid = jnp.asarray(kf_id, jnp.int32)
    steps = [
        ("cull_map_points", lambda m: jcull.cull_map_points(m, kid, jcaps),
         lambda m: pcull.cull_map_points(m, kf_id, caps)),
        ("create_new_map_points",
         lambda m: jtri.create_new_map_points(m, kid, jcaps, jcam, jsf,
                                              bow_group_div=jnp.asarray(bow_group_div)),
         lambda m: ptri.create_new_map_points(m, kf_id, caps, cam, sf,
                                              bow_group_div=bow_group_div)),
        ("search_in_neighbors", lambda m: jfuse.search_in_neighbors(m, kid, jcaps, jcam, jsf),
         lambda m: pfuse.search_in_neighbors(m, kf_id, caps, cam, sf)),
        ("local BA", lambda m: jlba.local_bundle_adjust_iters(
            m, kid, jcaps, jcam, 1.0 / (jsf * jsf), stop=jnp.asarray(stop)),
         lambda m: plba.local_bundle_adjust_iters(m, kf_id, caps, cam, 1.0 / (sf * sf),
                                                  stop=stop)),
        ("cull_keyframes", lambda m: jcull.cull_keyframes(m, kid, jcaps, jcam),
         lambda m: pcull.cull_keyframes(m, kf_id, caps, cam)),
    ]
    for name, jf, pf in steps:
        if name == "local BA" and "--save-ba" in sys.argv:
            out = Path(arg("--save-ba", "")) / f"ba_frame{frame}.npz"
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez(out, kf_id=kf_id, stop=stop, **convert.dataclass_to_numpy(m_host))
        jout = jf(jax.tree.map(jnp.asarray, m_host))
        pout = pf(port_map(m_host))
        if isinstance(jout, tuple):
            print(f"    {name}: LM iterations JAX {[int(x) for x in jout[1:]]} port "
                  f"{[int(x) for x in pout[1:]]}")
            jout, pout = jout[0], pout[0]
        compare(f"  {name}", pout, jax.device_get(jout), island)
        m_host = jax.device_get(jout)
    return m_host


JSTATE = {}


def main() -> int:
    t0 = time.perf_counter()
    first = arg("--from", 36)
    seq, cfg = cs.pan_sequence()
    voc = cs.pan_vocabulary(seq, cfg, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pan_voc.npz")
        voc.save(path)
        jvoc = JVocabulary.load(path)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "camera_fx", "camera_fy", "camera_cx", "camera_cy", "camera_k1", "camera_k2",
        "camera_p1", "camera_p2", "camera_k3", "camera_fps")})
    caps = MapCaps(max_kf=32, max_pt=8192)
    js = JSlamSystem(jcfg, caps=JMapCaps(max_kf=32, max_pt=8192), vocabulary=jvoc,
                     chunk=cs.PAN_CHUNK)
    ps = psystem.SlamSystem(cfg, caps=caps, device="cpu", vocabulary=voc, chunk=cs.PAN_CHUNK)
    JSTATE.update(caps=js.caps, cam=js.camera, sf=js.scale_factors)
    calls = []
    orig = jsystem.background_chunk

    def recording(m, ls, did_kf, kf_id, interrupt_ba, *a, **k):
        frame = js._frame_id
        rec = None
        if frame >= first:
            rec = dict(frame=frame, m=jax.device_get(m), ls=jax.device_get(ls),
                       did=np.asarray(did_kf).tolist(), kf_id=np.asarray(kf_id).tolist(),
                       stop=bool(np.asarray(interrupt_ba)), bgd=int(np.asarray(a[0])))
        out = orig(m, ls, did_kf, kf_id, interrupt_ba, *a, **k)
        if rec is not None:
            rec.update(m_out=jax.device_get(out[0]), packed=np.asarray(out[6]).tolist())
            calls.append(rec)
        return out

    jsystem.background_chunk = recording
    D = cs.pan_drift()
    kf_cut = pre = pre_valid = None
    for i in range(len(seq)):
        js.track(*seq[i])
        if i == cs.PAN_CUT_FRAME:
            kf_cut = max(int(np.asarray(js.map.n_kf)), 1)
        if i == cs.PAN_DRIFT_FRAME:
            pre = np.asarray(js.map.kf_pose).copy()
            pre_valid = np.asarray(js.map.kf_valid).copy()
            js.map, ar = j_inject_drift(js.map, js.state.assign_real,
                                        jnp.asarray(kf_cut, jnp.int32), jnp.asarray(D))
            js.state = js.state.replace(assign_real=ar)
            js.map = js.map.replace(**{k: jnp.asarray(v) for k, v in
                                       cs.pan_sever_old(js.map, kf_cut).items()})
    js.results()
    jsystem.background_chunk = orig
    print(f"JAX on the CPU: loop closures {js.loop_closures}, attempts {js.loop_attempts}; "
          f"kf_cut {kf_cut}; {len(calls)} chunks recorded from frame {first} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    island = (pre, pre_valid, kf_cut)
    for rec in calls:
        if not any(rec["did"]):
            continue
        did = [bool(x) for x in rec["did"]]
        kids = [int(k) if d else -1 for d, k in zip(did, rec["kf_id"])]
        m, ls, outs = psystem.background_chunk(
            port_map(rec["m"]), port_loop_state(rec["ls"]), did, kids, rec["stop"], ps.caps,
            ps.camera, ps.scale_factors, True, rec["bgd"])
        j_rows = [(r[0], r[1], r[2], r[3], r[4]) for r, d in zip(rec["packed"], did) if d]
        p_rows = [(int(o.closed), o.which, int(o.attempted), o.ba_n1, o.ba_n2)
                  for o, d in zip(outs, did) if d]
        print(f"chunk at frame {rec['frame']}: keyframe events {did}, slots {kids}; "
              f"(closed, winner, attempted, LM1, LM2) JAX {j_rows} port {p_rows}", flush=True)
        compare("port from JAX's input", m, rec["m_out"], island)
        if "--substeps" in sys.argv:
            stops = (psystem.chunk_ba_stops(did) | rec["stop"]).tolist()
            m_host = rec["m"]
            for d, kid, stop in zip(did, kids, stops):
                if d:
                    print(f"   event slot {kid} (interruptBA {stop}), the mapping chain:")
                    m_host = substeps(ps, m_host, kid, stop, rec["bgd"], rec["frame"],
                                      island)
    if "--port-run" in sys.argv:
        pcut = None
        for i in range(len(seq)):
            ps.track(*seq[i])
            if i == cs.PAN_CUT_FRAME:
                pcut = max(int(ps.map.n_kf), 1)
            if i == cs.PAN_DRIFT_FRAME:
                ppre = ps.map.kf_pose.numpy().copy()
                ppre_valid = ps.map.kf_valid.numpy().copy()
                ps.map, ps.state.assign_real = inject_drift(ps.map, ps.state.assign_real, pcut,
                                                            torch.as_tensor(D))
                ps.map = ps.map.replace(**{k: torch.as_tensor(v) for k, v in
                                           cs.pan_sever_old(ps.map, pcut).items()})
            if i > cs.PAN_DRIFT_FRAME and not ps._chunk_buf:
                r = cs.island_residual(ppre, ppre_valid, pcut, ps.map.kf_pose.numpy())
                print(f"port on the CPU, frame {i}: island residual {r.round(4).tolist()}",
                      flush=True)
        ps.results()
        print(f"port on the CPU: loop closures {ps.loop_closures}, attempts {ps.loop_attempts}")
    print(f"wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
