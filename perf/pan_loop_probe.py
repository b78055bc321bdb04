"""Main path 5 of chip_smoke.py alone, on the card: the pan loop in the
three variants (chunk=4, chunk=1, chunk=4 with global BA), each printed with
its gates, without the rest of the smoke run and without failing on a gate.

    python3 perf/pan_loop_probe.py [--one-sided] [variant ...]   # variants: 4, 1, 4g
    python3 perf/pan_loop_probe.py --trace           # chunk=1, per frame after the drift
    python3 perf/pan_loop_probe.py --save-voc PATH   # write the vocabulary to PATH
    python3 perf/pan_loop_probe.py --gba-trace 4g    # what each global BA changed
    python3 perf/pan_loop_probe.py --gba-trace --dump-gba PATH 4g

The drift is injected as in chip_smoke.py (``inject_drift``, then
``pan_sever_old``); ``--one-sided`` injects it with ``inject_drift`` alone,
the JAX package's instrument, as ``--trace`` always does. ``--gba-trace``
prints, for each global BA, the robust cost of the map before and after it
and how far it moved the live keyframes and points; with ``--dump-gba PATH``
it also writes the map before and after the first global BA and the
inv_level_sigma2 it was given to PATH (an .npz for perf/gba_same_map.py).
``--save-voc PATH`` writes the vocabulary built on the card to PATH (an
.npz for perf/loop_path5_jax_cpu.py --voc) and stops.
``--trace`` prints, for each frame from the drift on, how many of the
frame's bound points predate the cut ("old", by their reference keyframe's
kf_seq), the new keyframe's old bindings and covisibility with old
keyframes, and how far the island keyframes have moved from their pre-drift
poses. Prints the card's name and power limit first."""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import chip_smoke as cs


def trace_gba(dump=None) -> None:
    """Wrap global_bundle_adjust to print its effect (and write the first
    call's maps to ``dump``)."""
    from vo_slam_test_tpu_torch import convert
    from vo_slam_test_tpu_torch.solvers import global_ba as G

    orig = G.global_bundle_adjust

    def wrapped(m, caps, cam, fixed_kf, **k):
        out = orig(m, caps, cam, fixed_kf, **k)
        kv, pv = m.kf_valid, m.pt_valid
        c0, n_obs = cs.gba_cost(m, cam, k.get("inv_level_sigma2"))
        c1, _ = cs.gba_cost(out, cam, k.get("inv_level_sigma2"))
        print(f"  global BA: {int(kv.sum())} keyframes, {int(pv.sum())} points, {n_obs} "
              f"observations; robust cost {c0:.6f} -> {c1:.6f}; max |pose change| "
              f"{float((out.kf_pose - m.kf_pose)[kv].abs().max()):.3e}, max |point change| "
              f"{float((out.pt_pos - m.pt_pos)[pv].abs().max()):.3e}", flush=True)
        if dump is not None and not Path(dump).exists():
            Path(dump).parent.mkdir(parents=True, exist_ok=True)
            np.savez(dump, fixed_kf=fixed_kf,
                     inv_level_sigma2=k["inv_level_sigma2"].cpu().numpy(),
                     **{f"in_{f}": v for f, v in convert.map_state_to_numpy(m).items()},
                     **{f"out_{f}": v for f, v in convert.map_state_to_numpy(out).items()})
            print(f"  wrote {dump}")
        return out
    G.global_bundle_adjust = wrapped


def trace(system, cfg, voc, frames) -> int:
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
    from vo_slam_test_tpu_torch.utils.drift import inject_drift

    from vo_slam_test_tpu_torch.pipeline import loop_closing
    from vo_slam_test_tpu_torch.slam_map import culling, triangulate
    from vo_slam_test_tpu_torch.solvers import local_ba

    s = system.SlamSystem(cfg, caps=MapCaps(max_kf=32, max_pt=8192), vocabulary=voc)
    D = torch.as_tensor(cs.pan_drift()).cuda()
    cut_seq = pre = island = None
    state = {}

    def step_probe(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            m = out[0] if isinstance(out, tuple) else out
            if state.get("pre") is not None and hasattr(m, "kf_pose"):
                mv = torch.linalg.norm(m.kf_pose[state["island"]][:, :3, 3]
                                       - state["pre"][state["island"]][:, :3, 3], dim=1)
                print(f"    after {name}: island moved {mv.cpu().numpy().round(4).tolist()}",
                      flush=True)
            return out
        setattr(mod, name, wrapped)

    for mod, name in ((culling, "cull_map_points"), (triangulate, "create_new_map_points"),
                      (system.fuse, "search_in_neighbors"), (local_ba, "local_bundle_adjust_iters"),
                      (culling, "cull_keyframes"), (loop_closing, "_close_multi")):
        step_probe(mod, name)
    for i, (g, d, ts) in enumerate(frames):
        s.track(g, d, ts)
        if i == cs.PAN_CUT_FRAME:
            kf_cut = max(int(s.map.n_kf), 1)
        if i == cs.PAN_DRIFT_FRAME:
            cut_seq = int(s.map.kf_seq[kf_cut])
            pre = s.map.kf_pose.clone()
            island = (s.map.kf_seq >= cut_seq) & s.map.kf_valid
            state.update(pre=pre, island=island)
            s.map, s.state.assign_real = inject_drift(s.map, s.state.assign_real, kf_cut, D)
        if cut_seq is None:
            continue
        m = s.map
        ref_seq = m.kf_seq[m.pt_ref_kf.clamp(min=0).long()]
        old_pt = m.pt_valid & (ref_seq < cut_seq)
        a = s.state.assign_real
        n_old = int((old_pt[a.clamp(min=0).long()] & (a >= 0)).sum())
        n_bound = int((a >= 0).sum())
        new_kf = int(s._outs[-1].ref_kf) if s._outs[-1].made_kf else -1
        extra = ""
        if new_kf >= 0:
            row = m.kf_mp[new_kf]
            old_kf = m.kf_valid & (m.kf_seq < cut_seq)
            extra = (f"; new keyframe slot {new_kf} seq {int(m.kf_seq[new_kf])}: "
                     f"{int((old_pt[row.clamp(min=0).long()] & (row >= 0)).sum())} old of "
                     f"{int((row >= 0).sum())} bound, covis with old keyframes "
                     f"{(m.covis[new_kf] * old_kf).tolist()}")
        moved = torch.linalg.norm(m.kf_pose[island][:, :3, 3] - pre[island][:, :3, 3], dim=1)
        print(f"frame {i}: ok {bool(s._outs[-1].ok)}, bound {n_bound}, old {n_old}; island "
              f"moved {moved.cpu().numpy().round(4).tolist()}{extra}", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("pan_loop_probe: no CUDA device available", file=sys.stderr)
        return 1
    from vo_slam_test_tpu_torch.ops import _build
    from vo_slam_test_tpu_torch.pipeline import system

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.build()
    seq, cfg = cs.pan_sequence()
    frames = [seq[i] for i in range(len(seq))]
    gt = np.stack([seq.poses[i] for i in range(len(seq))])
    voc = cs.pan_vocabulary(seq, cfg, torch.device("cuda"))
    print(f"build, frames and vocabulary in {time.perf_counter() - t0:.1f} s")
    if "--save-voc" in sys.argv:
        out = Path(sys.argv[sys.argv.index("--save-voc") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        voc.save(str(out))
        print(f"wrote {out}: centroid sum "
              f"{sum(int(c.cpu().numpy().view(np.uint32).astype(np.uint64).sum()) for c in voc.centroids)}")
        return 0
    if "--trace" in sys.argv:
        return trace(system, cfg, voc, frames)
    one_sided = "--one-sided" in sys.argv
    if one_sided:
        sys.argv.remove("--one-sided")
    dump = None
    if "--dump-gba" in sys.argv:
        i = sys.argv.index("--dump-gba")
        dump = sys.argv[i + 1]
        del sys.argv[i:i + 2]
    if "--gba-trace" in sys.argv:
        sys.argv.remove("--gba-trace")
        trace_gba(dump)
    variants = {"4": (4, False), "1": (1, False), "4g": (4, True)}
    for name in (sys.argv[1:] or list(variants)):
        chunk, gba = variants[name]
        t0 = time.perf_counter()
        s, rec = cs.run_pan(system, cfg, voc, frames, chunk, gba, sever_old=not one_sided)
        print(f"variant {name}: {time.perf_counter() - t0:.1f} s")
        try:
            cs.pan_report(f"chunk={chunk}{', global BA' if gba else ''}", s, rec, gt)
        except AssertionError as e:
            print(f"  gate failed: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
