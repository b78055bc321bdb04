"""The graph path on the card, alone: conditional nodes, then main paths 1-3
through ``utils.graphs.StepGraph`` beside ``graphs=False`` in one process.

    python3 perf/graphs_probe.py [--frames N] [--skip-chunk] [--sites] [--bisect]
                                 [--smoke-phase] [--vocab] [--close] [--loop]
                                 [--depth] [--launch] [--while] [--mapping-nodes]
                                 [--gba] [--loops] [--mesh]

Prints torch's version and whether ``torch.cuda.CUDAGraph`` has
``begin_capture_to_if_node``; checks a captured ``cond`` and ``while_capped``
against eager for both predicate values; then ``FusedTracker`` over main path
1's 30 corner frames and ``SlamSystem`` over the first ``--frames`` (default
40) room-orbit frames at 640x480, per frame and with ``chunk=8``, each with
and without graphs: bit equality of poses, keyframes, LM counts and every map
tensor, host syncs per ``track`` call (sync debug mode) and per-frame CUDA
event ms. ``--sites`` prints the Python line of every host sync of the eager
runs; ``--bisect`` first captures single operations, the vocabulary path's
operations and each mapping-chain stage inside an IF body (which ones
instantiate); ``--smoke-phase`` runs only
``chip_smoke.run_graphs_phase``; ``--vocab`` captures the vocabulary path's
operations inside an IF body one by one, then runs the smoke's eigensolver
phase and main path 4 through graphs (``chip_smoke.run_graphs_kidnap``);
``--close`` captures the loop close's operations inside an IF body one by one
(the dense pose-graph solve at path 5's and the default caps' sizes, the Sim3
RANSAC and refinement, forward-mode Jacobians, the whole pose graph with a
device ``fixed_kf``), each replay against eager; ``--loop`` runs the smoke's
main path 5 (``chunk=4``) and main path 8a eagerly and through the step
programs with the close inside the background program (``chip_smoke.run_pan``,
``run_path8a``): equal, host syncs per chunk, launches from the second chunk
on (counted on the device), the closing chunk's ms, capture time and nodes;
``--depth``
captures the essential graph's dense solve at K 256 (one (K*7)^2 system) and
its pieces under 1, 2 and 3 nested conds, with ``solve_ex`` and with a
Cholesky, before and after running each once on the IF-body streams;
``--launch`` times main path 5 (``chunk=4``) through the step programs in a
fresh process, then again after a short ``torch.profiler`` session, with the
host seconds of each program's ``replay`` call; ``--while`` replays a toy
``graphs.scan`` (one WHILE node) for 0, 1 and all trips against eager and
compares its node count at two trip caps, then captures each op class of the
background program (cuBLAS, cuSOLVER's LU and Cholesky, ``torch.func.jvp``,
a hand-written kernel, the Sim3 refinement and the pose graph with their own
LM loops) inside one WHILE body and inside WHILE > IF > IF > WHILE > IF >
WHILE, as the background program nests the Sim3 LM (with ``--loop``, paths 5
and 8a follow); ``--mapping-nodes`` captures each stage of the mapping chain
alone on the room orbit's map and prints its graph nodes beside the whole
chain's, then the three fixed-trip loops (undistortion, EPnP's
Gauss-Newton, pose-only's fast round), each captured alone; ``--loops``
first captures those loops' library ops (``solve_ex`` at both shapes, the
pose round's guard) inside a WHILE body, then the three loops, each replay
against eager; ``--mesh`` runs the smoke's mesh phase on main path 2's map
(both mesh solvers eagerly and as step programs); ``--gba`` captures global BA's
pieces (the [256,6,6] ``inv_ex`` batch, the per-point sorted sums, a WHILE >
WHILE gemv nest) alone and inside one and two WHILE bodies, then its whole
program at the tests' caps and the default MapCaps beside eager
(``chip_smoke.run_gba_scene``).
Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def capture_selftest(graphs) -> None:
    """A StepGraph whose step holds a cond and a while_capped, replayed for
    both predicate values, against eager."""
    dev = torch.device("cuda")

    def step(inp, st):
        x, = inp
        y = graphs.cond(x.sum() > 0, lambda: st * 2 + x, lambda: st - x)
        z, n = graphs.while_capped(lambda c: c[0].sum() < 100, lambda c: (c[0] * 2, c[1] + 1),
                                   (y, torch.zeros((), dtype=torch.int32, device=dev)), 8)
        return z, n

    sg = graphs.StepGraph(step, dev, "selftest")
    st = torch.ones(4, device=dev)
    for i, v in enumerate((1.0, -1.0, 1.0, -1.0, 3.0)):
        x = torch.full((4,), v, device=dev)
        want_y = st * 2 + x if v > 0 else st - x
        want = want_y.clone()
        n = 0
        while n < 8 and want.sum() < 100:
            want, n = want * 2, n + 1
        st, got_n = sg.run((x,), st)
        if not torch.equal(st, want) or int(got_n) != n:
            raise AssertionError(f"selftest call {i}: {st.tolist()} / {want.tolist()}, "
                                 f"{int(got_n)} / {n}")
        st = st.clone()
    print(f"selftest: cond + while_capped replayed {sg.replays} times, equal to eager")


def tracked(fn, sites: dict | None):
    """(result, syncs) of ``fn`` under sync debug mode ``warn``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ws = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        for w in ws:
            key = f"{Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return out, len(ws)


def run(make, frames, label, sites=None):
    """Track ``frames`` with a fresh system; CUDA-event ms and syncs per call."""
    s = make()
    ms, syncs = [], []
    for g, d, t in frames:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _, n = tracked(lambda: s.track(g, d, t), sites)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        syncs.append(n)
    res = s.results()
    print(f"  {label}: frame ms median {np.median(ms[3:]):.3f} (frames 3..), first three "
          f"{[round(x, 1) for x in ms[:3]]}; syncs per call {syncs}")
    return s, res, ms, syncs


def same_maps(a, b) -> list:
    return [f.name for f in dataclasses.fields(a.map)
            if not torch.equal(getattr(a.map, f.name), getattr(b.map, f.name))]


def micro_cases(graphs) -> None:
    """Single operations inside an IF body, each its own StepGraph: which
    ones a conditional body instantiates with."""
    dev = torch.device("cuda")
    A = torch.randn(144, 144, device=dev)
    S = A @ A.T + 144 * torch.eye(144, device=dev)
    b = torch.randn(144, 1, device=dev)
    M3 = torch.randn(3, 3, device=dev) + 3 * torch.eye(3, device=dev)
    B4 = torch.randn(1024, 4, 4, device=dev, dtype=torch.float64)
    x4 = torch.randn(1024, 4, 1, device=dev, dtype=torch.float64)
    v = torch.randn(4096, device=dev)
    cases = {
        "plain": lambda: v * 2,
        "nested cond": lambda: graphs.cond(v.sum() > 0, lambda: v * 3, lambda: v - 1),
        "inv_ex 3x3": lambda: torch.linalg.inv_ex(M3)[0],
        "solve_ex f64 [1024,4,4]": lambda: torch.linalg.solve_ex(B4, x4)[0],
        "cholesky_ex 144": lambda: torch.linalg.cholesky_ex(S)[0],
        "cholesky_solve 144": lambda: torch.cholesky_solve(b, torch.linalg.cholesky_ex(S)[0]),
        "solve_triangular x2 144": lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(S)[0].mT, torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(S)[0], b, upper=False), upper=True),
        "argsort stable": lambda: torch.argsort(v, stable=True).float(),
        "while_capped": lambda: graphs.while_capped(lambda c: c.sum() < 1e6, lambda c: c * 2,
                                                    v.abs() + 1, 4),
        "scatter_reduce amax": lambda: torch.zeros(64, device=dev).scatter_reduce(
            0, (v.abs() * 10).long().clamp(max=63), v, "amax"),
    }
    for name, fn in cases.items():
        sg = graphs.StepGraph(lambda inp, st: (st, graphs.cond(inp[0], fn, lambda: fn() * 0)),
                              dev, name)
        go = torch.ones((), dtype=torch.bool, device=dev)
        try:
            for _ in range(3):
                sg.run((go,), torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            print(f"  micro {name}: ok", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every case
            print(f"  micro {name}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


def vocab_cases(graphs) -> None:
    """The vocabulary path's operations inside an IF body, each its own
    StepGraph (which ones a conditional body instantiates with): the stable
    sort of ``prng.top_k``, ``bow_vector`` (sort, ``index_add_``),
    ``vocabulary.transform``, ``search_by_bow_kf_frame``, EPnP's small solves
    (``solve_ex`` at its batch shapes, ``inv_ex``), the eigensolver kernel,
    and whole Horn and EPnP RANSAC calls with a device seed."""
    from vo_slam_test_tpu_torch.bow import retrieval as bow_ret
    from vo_slam_test_tpu_torch.bow import vocabulary as bow_voc
    from vo_slam_test_tpu_torch.camera import Camera
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.matching import bow_match
    from vo_slam_test_tpu_torch.ops import symeig_cuda
    from vo_slam_test_tpu_torch.solvers import epnp, ransac
    from vo_slam_test_tpu_torch.utils import prng

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    N = 1000
    voc = bow_voc.synth_vocabulary(k=8, levels=3, device=dev)
    desc = torch.randint(-2**31, 2**31 - 1, (N, 8), generator=g, dtype=torch.int32).to(dev)
    valid = (torch.rand(N, generator=g) < 0.9).to(dev)
    words = bow_voc.transform(voc, desc, valid)
    groups = bow_voc.feature_groups(voc, words)
    angle = (torch.rand(N, generator=g) * 360).to(dev)
    mp = torch.where(torch.rand(N, generator=g) < 0.5, torch.arange(N), -1).to(torch.int32).to(dev)
    cam = Camera.from_config(SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                                        camera_k3=0), dev)
    Xw = (torch.randn(200, 3, generator=g) + torch.tensor([0.0, 0.0, 4.0])).to(dev)
    uv = (Xw[:, :2] / Xw[:, 2:] * 500 + 320).to(dev)
    pc = Xw.clone()
    ones = torch.ones(200, dtype=torch.bool, device=dev)
    seed = torch.full((), 7 * 3 + 1, dtype=torch.int64, device=dev)
    B3 = torch.randn(384, 3, 3, generator=g).to(dev) + 3 * torch.eye(3, device=dev)
    B4 = torch.randn(384, 4, 4, generator=g).to(dev) + 4 * torch.eye(4, device=dev)
    B5 = torch.randn(384, 5, 5, generator=g).to(dev) + 5 * torch.eye(5, device=dev)
    M12 = torch.randn(128, 12, 12, generator=g).to(dev)
    M12 = M12 @ M12.mT
    G = torch.randn(128, N, generator=g).to(dev)
    cases = {
        "top_k stable sort [128,1000]": lambda: prng.top_k(G, 4)[1].float(),
        "bow_vector": lambda: bow_ret.bow_vector(words, voc.idf)[1],
        "transform": lambda: bow_voc.transform(voc, desc, valid).float(),
        "search_by_bow_kf_frame": lambda: bow_match.search_by_bow_kf_frame(
            desc, groups, mp, angle, mp >= 0, desc.flip(0), groups.flip(0), angle.flip(0),
            valid, 0.75).assign.float(),
        "solve_ex f32 [384,3,3]": lambda: epnp._solve(B3, B3[..., 0]),
        "solve_ex f32 [384,4,4]": lambda: epnp._solve(B4, B4[..., 0]),
        "solve_ex f32 [384,5,5]": lambda: epnp._solve(B5, B5[..., 0]),
        "inv_ex f32 [128,3,3]": lambda: torch.linalg.inv_ex(B3[:128])[0],
        "symeig kernel [128,12,12]": lambda: symeig_cuda.symeig(M12)[1],
        "symeig kernel [384,4,4]": lambda: symeig_cuda.symeig(B4)[1],
        "horn ransac, device seed": lambda: ransac.ransac_pose_3d3d(
            Xw, pc, uv, ones, ones, cam.fx, cam.fy, cam.cx, cam.cy, seed)[0],
        "epnp ransac, device key": lambda: epnp.ransac_pnp(
            prng.prng_key(seed), Xw, uv, ones, torch.ones(200, device=dev), cam)[0],
    }
    for name, fn in cases.items():
        sg = graphs.StepGraph(lambda inp, st, fn=fn: (st, graphs.cond(inp[0], fn,
                                                                       lambda: fn() * 0)),
                              dev, name)
        go = torch.ones((), dtype=torch.bool, device=dev)
        try:
            outs = [sg.run((go,), torch.zeros(1, device=dev))[1] for _ in range(3)]
            torch.cuda.synchronize()
            want = fn()
            same = all(torch.equal(torch.nan_to_num(o), torch.nan_to_num(want)) for o in outs)
            print(f"  vocab {name}: ok, replays equal eager {same}", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every case
            print(f"  vocab {name}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


def close_cases(graphs) -> None:
    """The loop close's operations inside an IF body, each its own StepGraph,
    each replay against eager: ``solve_ex`` on one dense system (refine's
    6x6, the pose graph's (K*7)^2 at K 32 and 256), a Cholesky with two
    triangular solves at K 256, ``jac_at_zero`` (``torch.func.jvp``), the
    Sim3 RANSAC with a device seed and its refinement, and
    ``solve_pose_graph`` with a device ``fixed_kf``."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.solvers import pose_graph, sim3

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(9)

    def spd(n):
        A = torch.randn(n, n, generator=g)
        return (A @ A.T / n + torch.eye(n)).to(dev), torch.randn(n, generator=g).to(dev)

    H6, b6 = spd(6)
    H224, b224 = spd(224)
    H1792, b1792 = spd(1792)
    W = torch.randn(14, 7, generator=g).to(dev)
    N = 128
    pc2 = (torch.randn(N, 3, generator=g) * 0.5 + torch.tensor([0.0, 0.0, 3.0])).to(dev)
    R = lie.se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.01, 0.02, -0.01]).to(dev))
    pc1 = pc2 @ R[:3, :3].T + R[:3, 3]

    def proj(p):
        return torch.stack([500 * p[:, 0] / p[:, 2] + 320, 500 * p[:, 1] / p[:, 2] + 240], -1)

    uv1, uv2 = proj(pc1), proj(pc2)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    gate = torch.full((N,), 9.21, device=dev)
    seed = torch.full((), 9, dtype=torch.int32, device=dev)

    def chain(K, n):
        """A drifted chain of n live keyframes in a K-slot graph."""
        xi = torch.randn(K, 6, generator=g).to(dev) * 0.05
        xi[:, 2] += torch.arange(K, device=dev) * 0.1
        T = lie.se3_exp(xi)
        valid = torch.arange(K, device=dev) < n
        ids = torch.arange(K, device=dev)
        edges = ((ids[:, None] - ids[None, :]).abs() == 1) & valid[:, None] & valid[None, :]
        edges[0, n - 1] = edges[n - 1, 0] = True
        meas = torch.einsum("iab,jbc->ijac", T, lie.se3_inverse(T))
        noise = lie.se3_exp(torch.randn(K, 6, generator=g).to(dev) * 0.01)
        Tn = noise @ T
        return (torch.ones(K, device=dev), Tn[:, :3, :3], Tn[:, :3, 3], valid, edges,
                torch.ones(K, K, device=dev), meas[:, :, :3, :3], meas[:, :, :3, 3])

    c32, c256 = chain(32, 20), chain(256, 60)
    fixed = torch.full((), 3, dtype=torch.int32, device=dev)

    def pg(c):
        s, Ro, t = pose_graph.solve_pose_graph(*c, fixed, iters=20)
        return torch.cat([s[:, None], Ro.reshape(-1, 9), t], 1)

    def chol_solve(H, b):
        L = torch.linalg.cholesky_ex(H)[0]
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    cases = {
        "solve_ex f32 6x6": lambda: torch.linalg.solve_ex(H6, b6)[0],
        "solve_ex f32 224x224": lambda: torch.linalg.solve_ex(H224, b224)[0],
        "solve_ex f32 1792x1792": lambda: torch.linalg.solve_ex(H1792, b1792)[0],
        "cholesky_ex + 2 solve_triangular 1792": lambda: chol_solve(H1792, b1792),
        "jac_at_zero [4096,14]": lambda: sim3.jac_at_zero(
            lambda x: torch.sin(x) @ W, (4096, 14), dev)[1],
        "ransac_sim3, device seed": lambda: sim3.ransac_sim3(
            pc1, pc2, uv1, uv2, gate, gate, ok, 500.0, 500.0, 320.0, 240.0, seed)[1],
        "refine_sim3": lambda: sim3.refine_sim3(
            torch.eye(4, device=dev), torch.ones((), device=dev), pc1, pc2, uv1, uv2,
            torch.ones(N, device=dev), torch.ones(N, device=dev), ok, 500.0, 500.0, 320.0,
            240.0)[1],
        "solve_pose_graph K 32, device fixed_kf": lambda: pg(c32),
        "solve_pose_graph K 256, device fixed_kf": lambda: pg(c256),
    }
    for name, fn in cases.items():
        sg = graphs.StepGraph(lambda inp, st, fn=fn: (st, graphs.cond(inp[0], fn,
                                                                       lambda: fn() * 0)),
                              dev, name)
        go = torch.ones((), dtype=torch.bool, device=dev)
        try:
            outs = [sg.run((go,), torch.zeros(1, device=dev))[1] for _ in range(3)]
            torch.cuda.synchronize()
            want = fn()
            same = all(torch.equal(torch.nan_to_num(o), torch.nan_to_num(want)) for o in outs)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            sg.run((go,), torch.zeros(1, device=dev))
            e1.record()
            torch.cuda.synchronize()
            print(f"  close {name}: ok, replays equal eager {same}, {sg.n_nodes} nodes, "
                  f"replay {e0.elapsed_time(e1):.3f} ms", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every case
            print(f"  close {name}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)


def loop_paths(system, dev) -> None:
    """Main paths 5 (``chunk=4``) and 8a, eager and through the step
    programs, with the smoke's own run functions and checks."""
    import json

    import chip_smoke
    from vo_slam_test_tpu_torch import bench

    pseq, pcfg = chip_smoke.pan_sequence()
    pframes = [pseq[i] for i in range(len(pseq))]
    pvoc = chip_smoke.pan_vocabulary(pseq, pcfg, dev)
    rows = {}
    runs = {}
    for on in (False, True):
        t0 = time.perf_counter()
        runs[on] = chip_smoke.run_pan(system, pcfg, pvoc, pframes, chip_smoke.PAN_CHUNK, False,
                                      graphs=on)
        print(f"path 5 graphs={on} in {time.perf_counter() - t0:.1f} s", flush=True)
    (a, ra), (b, rb) = runs[False], runs[True]
    chip_smoke.same_system_runs("path 5 (graphs=True)", a, b, a.results(), b.results())
    calls = [i for i in range(len(pframes)) if (i + 1) % chip_smoke.PAN_CHUNK == 0]
    bg = b.background_graph
    rows["5"] = dict(closures=b.loop_closures, syncs=rb["syncs"], eager_syncs=ra["syncs"],
                     chunk_ms=[rb["call_ms"][i] for i in calls],
                     eager_chunk_ms=[ra["call_ms"][i] for i in calls],
                     launches_equal=rb["launches_from_chunk_2"] == ra["launches_from_chunk_2"],
                     launches=rb["launches_from_chunk_2"],
                     eager_launches=ra["launches_from_chunk_2"],
                     wrappers=rb["wrapper_calls_from_chunk_2"],
                     capture_s=[b.track_graph.capture_s, bg.capture_s],
                     nodes=[b.track_graph.n_nodes, bg.n_nodes], if_nodes=[b.track_graph.n_if,
                                                                           bg.n_if],
                     while_nodes=[b.track_graph.n_while, bg.n_while])
    print(json.dumps({"path5": rows["5"]}), flush=True)
    del a, b, runs
    gc.collect()
    sc = bench.build_scenario("kfdense", dev)
    frames_dev = bench.stage_frames(sc.frames, dev)
    runs = {}
    for on in (False, True):
        t0 = time.perf_counter()
        runs[on] = chip_smoke.run_path8a(system, sc, frames_dev, None, graphs=on)
        print(f"path 8a graphs={on} in {time.perf_counter() - t0:.1f} s", flush=True)
    (a, ra), (b, rb) = runs[False], runs[True]
    chip_smoke.same_system_runs("path 8a (graphs=True)", a, b, a.results(), b.results())
    diag = bench.check(sc, b, len(frames_dev))
    bg = b.background_graph
    rejected = sorted({f // sc.chunk for f, _, acc, _ in b.loop_gates if not acc})
    rows["8a"] = dict(diag=diag, syncs=rb["syncs"], sync_sites=rb["sync_sites"],
                      eager_syncs=ra["syncs"], chunk_ms=rb["chunk_ms"],
                      eager_chunk_ms=ra["chunk_ms"], rejected_chunks=rejected,
                      launches_equal=rb["launches_from_chunk_2"] == ra["launches_from_chunk_2"],
                      launches=rb["launches_from_chunk_2"],
                      eager_launches=ra["launches_from_chunk_2"],
                      wrappers=rb["wrapper_calls_from_chunk_2"],
                      capture_s=[b.track_graph.capture_s, bg.capture_s],
                      nodes=[b.track_graph.n_nodes, bg.n_nodes],
                      if_nodes=[b.track_graph.n_if, bg.n_if],
                      while_nodes=[b.track_graph.n_while, bg.n_while])
    print(json.dumps({"path8a": rows["8a"]}, default=str), flush=True)


def depth_cases(graphs) -> None:
    """The pose graph's dense solve at K 256 and its pieces under 1-3 nested
    conds (each its own StepGraph): ``solve_ex`` on one 1792x1792 system, a
    Cholesky with two triangular solves, the one-hot block sums, the whole
    ``solve_pose_graph``; then each body stream runs ``solve_ex`` once outside
    any capture, and the failing cases are tried again."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.solvers import pose_graph

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    n = 1792
    A = torch.randn(n, n, generator=g)
    H = (A @ A.T / n + torch.eye(n)).to(dev)
    b = torch.randn(n, generator=g).to(dev)
    O = torch.randn(4096, 256, generator=g).to(dev)
    X = torch.randn(4096, 49, generator=g).to(dev)
    K = 256
    xi = torch.randn(K, 6, generator=g).to(dev) * 0.05
    T = lie.se3_exp(xi)
    valid = torch.arange(K, device=dev) < 60
    ids = torch.arange(K, device=dev)
    edges = ((ids[:, None] - ids[None, :]).abs() == 1) & valid[:, None] & valid[None, :]
    meas = torch.einsum("iab,jbc->ijac", T, lie.se3_inverse(T))
    fixed = torch.full((), 3, dtype=torch.int32, device=dev)

    def chol(H, b):
        L = torch.linalg.cholesky_ex(H)[0]
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    cases = {
        "solve_ex 1792": lambda: torch.linalg.solve_ex(H, b)[0],
        "lu_factor_ex 1792": lambda: torch.linalg.lu_factor_ex(H)[0],
        "cholesky + solve_triangular 1792": lambda: chol(H, b),
        "one-hot sums [256,4096]@[4096,49]": lambda: O.T @ X,
        "solve_pose_graph K 256": lambda: pose_graph.solve_pose_graph(
            torch.ones(K, device=dev), T[:, :3, :3], T[:, :3, 3], valid, edges,
            torch.ones(K, K, device=dev), meas[:, :, :3, :3], meas[:, :, :3, 3], fixed,
            iters=2)[2],
    }
    true = torch.ones((), dtype=torch.bool, device=dev)

    def attempt(name, fn, depth, tag):
        want = fn()

        def nest(d):
            if d == 0:
                return fn()
            return graphs.cond(true, lambda: nest(d - 1), lambda: torch.zeros_like(want))

        sg = graphs.StepGraph(lambda inp, st: (st, nest(depth)), dev, name)
        try:
            outs = [sg.run((), torch.zeros(1, device=dev))[1] for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(o, want) for o in outs)
            print(f"  depth {tag} {depth} {name}: ok, equal {same}, {sg.n_nodes} nodes", flush=True)
            return True
        except Exception as e:  # noqa: BLE001 - the probe reports every case
            print(f"  depth {tag} {depth} {name}: FAILED {type(e).__name__}: {str(e)[:100]}",
                  flush=True)
            return False

    failed = [(name, d) for d in (1, 2, 3) for name, fn in cases.items()
              if not attempt(name, fn, d, "first")]
    for d in range(3):
        with torch.cuda.stream(graphs._body_stream(dev, d)):
            torch.linalg.solve_ex(H, b)
            _ = O.T @ X
    torch.cuda.synchronize()
    for name, d in failed:
        attempt(name, cases[name], d, "after a run on each body stream")


def while_cases(graphs) -> None:
    """WHILE nodes (``graphs.scan``/``while_capped`` in a capture): a toy
    scan replayed for 0, 1 and all trips against eager, its node count at
    two trip caps; then every op class of the background program inside a
    WHILE body nested as the program nests it, WHILE (chunk) > IF (keyframe)
    > IF (close) > WHILE (Sim3 slot) > IF (live) > WHILE (LM), each WHILE of
    two trips, each its own StepGraph replayed three times against eager."""
    from vo_slam_test_tpu_torch import lie
    from vo_slam_test_tpu_torch.ops import symeig_cuda
    from vo_slam_test_tpu_torch.solvers import pose_graph, sim3

    dev = torch.device("cuda")

    def toy(length):
        def step(inp, st):
            xs, start, n = inp
            return graphs.scan(lambda i, c, x: (c + x * (i + 1), c * 2), st, xs, start=start,
                               n=n)

        return graphs.StepGraph(step, dev, f"toy {length}")

    def toy_eager(xs, st, start, n):
        return graphs.scan(lambda i, c, x: (c + x * (i + 1), c * 2), st, xs, start=start, n=n)

    nodes = {}
    for length in (4, 16):
        sg = toy(length)
        xs = torch.arange(length, dtype=torch.float32, device=dev)
        dint = lambda v: torch.full((), v, dtype=torch.int64, device=dev)  # noqa: E731
        ok = []
        for start, n in ((0, 1), (1, 2), (0, 0), (0, length), (2, 1), (1, length)):
            st = torch.ones((), device=dev)
            got = sg.run((xs, dint(start), dint(n)), st.clone())
            want = toy_eager(xs, st, start, n)
            rows_ok = (not got[1].any()) if want[1] is None else torch.equal(got[1], want[1])
            ok.append(torch.equal(got[0], want[0]) and bool(rows_ok))
        nodes[length] = (sg.n_nodes, sg.n_while)
        print(f"  while toy length {length}: equal {ok}, {sg.n_nodes} nodes, {sg.n_while} "
              f"WHILE nodes, {sg.replays} replays", flush=True)
    print(f"  while toy: node count the same at both caps {nodes[4] == nodes[16]}", flush=True)

    g = torch.Generator().manual_seed(5)

    def spd(n):
        A = torch.randn(n, n, generator=g)
        return (A @ A.T / n + torch.eye(n)).to(dev), torch.randn(n, generator=g).to(dev)

    H6, b6 = spd(6)
    H144, b144 = spd(144)
    H1792, b1792 = spd(1792)
    O = torch.randn(4096, 256, generator=g).to(dev)
    X = torch.randn(4096, 49, generator=g).to(dev)
    W = torch.randn(14, 7, generator=g).to(dev)
    Ms = torch.randn(16, 12, 12, generator=g)
    Ms = (Ms @ Ms.mT).to(dev)
    N = 128
    pc2 = (torch.randn(N, 3, generator=g) * 0.5 + torch.tensor([0.0, 0.0, 3.0])).to(dev)
    R = lie.se3_exp(torch.tensor([0.02, -0.01, 0.03, 0.01, 0.02, -0.01]).to(dev))
    pc1 = pc2 @ R[:3, :3].T + R[:3, 3]
    proj = lambda p: torch.stack([500 * p[:, 0] / p[:, 2] + 320,  # noqa: E731
                                  500 * p[:, 1] / p[:, 2] + 240], -1)
    uv1, uv2 = proj(pc1), proj(pc2)
    ok_n = torch.ones(N, dtype=torch.bool, device=dev)
    K = 256
    T = lie.se3_exp(torch.randn(K, 6, generator=g).to(dev) * 0.05)
    valid = torch.arange(K, device=dev) < 60
    ids = torch.arange(K, device=dev)
    edges = ((ids[:, None] - ids[None, :]).abs() == 1) & valid[:, None] & valid[None, :]
    meas = torch.einsum("iab,jbc->ijac", T, lie.se3_inverse(T))
    fixed = torch.full((), 3, dtype=torch.int32, device=dev)

    def chol(H, b):
        L = torch.linalg.cholesky_ex(H)[0]
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]

    cases = {
        "solve_ex f32 6x6 (Sim3 LM, pose-only)": lambda: torch.linalg.solve_ex(H6, b6)[0],
        "cholesky_ex + 2 solve_triangular 144 (local BA)": lambda: chol(H144, b144),
        "cholesky_ex + 2 solve_triangular 1792 (pose graph)": lambda: chol(H1792, b1792),
        "solve_ex f32 1792 (LU)": lambda: torch.linalg.solve_ex(H1792, b1792)[0],
        "cuBLAS [256,4096]@[4096,49]": lambda: O.T @ X,
        "jac_at_zero [4096,14] (jvp)": lambda: sim3.jac_at_zero(
            lambda x: torch.sin(x) @ W, (4096, 14), dev)[1],
        "symeig kernel [16,12,12]": lambda: symeig_cuda.symeig(Ms)[0],
        "refine_sim3 (its own WHILE loops)": lambda: sim3.refine_sim3(
            torch.eye(4, device=dev), torch.ones((), device=dev), pc1, pc2, uv1, uv2,
            torch.ones(N, device=dev), torch.ones(N, device=dev), ok_n, 500.0, 500.0, 320.0,
            240.0)[1],
        "solve_pose_graph K 256 (its own WHILE loop)": lambda: pose_graph.solve_pose_graph(
            torch.ones(K, device=dev), T[:, :3, :3], T[:, :3, 3], valid, edges,
            torch.ones(K, K, device=dev), meas[:, :, :3, :3], meas[:, :, :3, 3], fixed,
            iters=3)[2],
    }
    true = torch.ones((), dtype=torch.bool, device=dev)

    def nest(fn, levels, like):
        if not levels:
            return fn()
        if levels[0] == "I":
            return graphs.cond(true, lambda: nest(fn, levels[1:], like),
                               lambda: torch.zeros_like(like))
        ys = graphs.scan(lambda i, c, _: (c + 1, nest(fn, levels[1:], like)),
                         torch.zeros((), device=dev), length=2)[1]
        return ys[1]

    for levels in ("W", "WIIWIW"):
        for name, fn in cases.items():
            want = fn()
            sg = graphs.StepGraph(lambda inp, st, fn=fn, want=want: (st, nest(fn, levels, want)),
                                  dev, name)
            try:
                outs = [sg.run((), torch.zeros(1, device=dev))[1] for _ in range(3)]
                torch.cuda.synchronize()
                same = all(torch.equal(torch.nan_to_num(o), torch.nan_to_num(want))
                           for o in outs)
                print(f"  while {levels} {name}: ok, equal {same}, {sg.n_nodes} nodes, "
                      f"{sg.n_while} WHILE / {sg.n_if} IF", flush=True)
            except Exception as e:  # noqa: BLE001 - the probe reports every case
                print(f"  while {levels} {name}: FAILED {type(e).__name__}: {str(e)[:160]}",
                      flush=True)
            del sg
            gc.collect()


def gba_cases(graphs) -> None:
    """Global BA's pieces inside WHILE bodies, each its own StepGraph
    replayed three times against eager: cuSOLVER's batched inverse of
    [256,6,6] f64 blocks (``inv_ex``, the CG preconditioner), the per-point
    sums (a stable argsort, ``index_add_`` lengths, ``segment_reduce`` over
    P+1 segments) and a bare WHILE > WHILE nest of cuBLAS gemv (the LM > CG
    nest), each alone, in one WHILE body and in WHILE > WHILE; then the
    whole global-BA program on ``chip_smoke.gba_scene`` at the tests' caps
    and the default MapCaps beside eager (``chip_smoke.run_gba_scene``)."""
    import chip_smoke
    from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    f64 = torch.float64
    A = torch.randn(256, 6, 6, generator=g, dtype=f64)
    A = (A @ A.mT + torch.eye(6, dtype=f64)).to(dev)
    M = (torch.randn(1536, 1536, generator=g, dtype=f64) / 80).to(dev)
    v0 = torch.randn(1536, generator=g, dtype=f64).to(dev)
    P = 2048
    key = torch.randint(0, P + 1, (4096,), generator=g).to(dev)
    X = torch.randn(4096, 6, 6, generator=g, dtype=f64).to(dev)

    def per_point():
        b = torch.argsort(key, stable=True)
        n = torch.zeros(P + 1, dtype=torch.int64, device=dev).index_add_(0, key,
                                                                          torch.ones_like(key))
        return torch.segment_reduce(X[b], "sum", lengths=n, axis=0, unsafe=True)[:P]

    def nest2():
        return graphs.fori_loop(0, 3, lambda i, c: graphs.fori_loop(
            0, 4, lambda j, d: torch.tanh(M @ d), c), v0)

    cases = {"inv_ex [256,6,6] f64": lambda: torch.linalg.inv_ex(A)[0],
             "argsort + index_add_ + segment_reduce [4096] -> [2048,6,6]": per_point,
             "WHILE(3) > WHILE(4) of gemv [1536]": nest2}

    def nest(fn, depth, like):
        if not depth:
            return fn()
        return graphs.scan(lambda i, c, _: (c + 1, nest(fn, depth - 1, like)),
                           torch.zeros((), device=dev), length=2)[1][1]

    for depth in (0, 1, 2):
        for name, fn in cases.items():
            want = fn()
            sg = graphs.StepGraph(lambda inp, st, fn=fn, want=want, d=depth: (
                st, nest(fn, d, want)), dev, name)
            try:
                outs = [sg.run((), torch.zeros(1, device=dev))[1] for _ in range(4)]
                torch.cuda.synchronize()
                same = all(torch.equal(o, want) for o in outs)
                print(f"  gba {'WHILE > ' * depth}{name}: ok, equal {same}, {sg.n_nodes} nodes, "
                      f"{sg.n_while} WHILE, {sg.replays} replays", flush=True)
            except Exception as e:  # noqa: BLE001 - the probe reports every case
                print(f"  gba {'WHILE > ' * depth}{name}: FAILED {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
            del sg
            gc.collect()
    for label, caps in (("the tests' caps", MapCaps(16, 2048, 12, 256)),
                        ("the default MapCaps", MapCaps())):
        chip_smoke.run_gba_scene(label, caps, dev, False)


def loop_body_cases(graphs, dev) -> None:
    """The fixed-trip loops' library ops inside one WHILE body (3 trips),
    each its own StepGraph replayed three times against eager: ``solve_ex``
    on the fast pose round's [6,6] system with its ``isfinite``/``max``
    guard, and on EPnP's [128,3,4,4] batch of Gauss-Newton systems."""
    g = torch.Generator().manual_seed(5)
    A6 = torch.randn(6, 6, generator=g)
    A6 = (A6 @ A6.T + torch.eye(6)).to(dev)
    b6 = torch.randn(6, generator=g).to(dev)
    A4 = torch.randn(128, 3, 4, 4, generator=g)
    A4 = (A4 @ A4.mT + 1e-3 * torch.eye(4)).to(dev)
    b4 = torch.randn(128, 3, 4, generator=g).to(dev)

    def guarded(x):
        step = -torch.linalg.solve_ex(A6, b6 + x)[0]
        ok = torch.all(torch.isfinite(step)) & (torch.max(torch.abs(step)) < 1.0)
        return torch.where(ok, x + 0.1 * step, x)

    def batched(x):
        return x - 0.1 * torch.linalg.solve_ex(A4, torch.einsum("...ij,...j->...i", A4, x) - b4)[0]

    cases = {"solve_ex [6,6] + isfinite/max guard": (guarded, torch.zeros(6, device=dev)),
             "solve_ex [128,3,4,4]": (batched, torch.zeros(128, 3, 4, device=dev))}
    for name, (body, x0) in cases.items():
        with graphs.use("select"):
            want = graphs.repeat(3, body, x0)
        sg = graphs.StepGraph(lambda inp, st, body=body: (st, graphs.repeat(3, body, inp[0])),
                              dev, name)
        try:
            outs = [sg.run((x0,), torch.zeros(1, device=dev))[1] for _ in range(4)]
            torch.cuda.synchronize()
            same = all(torch.equal(o, want) for o in outs)
            print(f"  WHILE > {name}: ok, equal {same}, {sg.n_nodes} nodes, {sg.n_while} WHILE, "
                  f"{sg.replays} replays", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every case
            print(f"  WHILE > {name}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)
        del sg
        gc.collect()


def fixed_loop_nodes(dev) -> None:
    """The three fixed-trip loops, each captured alone as the step programs
    run it (one WHILE node, ``utils.graphs.repeat``): ``ops/undistort.py``'s
    10 fixed-point trips on 1024 keypoints, EPnP's 6 Gauss-Newton trips on
    its [3,4] beta cases for 8 candidates, and pose-only's fast-path
    Gauss-Newton round (4 trips) on 512 observations; their graph nodes,
    WHILE nodes and capture seconds, and whether each replay equals eager."""
    from vo_slam_test_tpu_torch.ops import undistort
    from vo_slam_test_tpu_torch.solvers import epnp, pose_only
    from vo_slam_test_tpu_torch.utils import graphs

    g = torch.Generator().manual_seed(3)
    uv = (torch.rand(1024, 2, generator=g) * torch.tensor([640.0, 480.0])).to(dev)
    dist = torch.tensor([0.2, -0.5, 0.001, 0.002, 0.3], device=dev)
    V = torch.randn(8, 3, 4, 4, 3, generator=g).to(dev)
    rho = torch.rand(8, 3, 6, generator=g).to(dev)
    betas = torch.rand(8, 3, 4, generator=g).to(dev)
    n = 512
    p = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 4.0, 4.0]) + torch.tensor(
        [-2.0, -2.0, 2.0])
    obs = pose_only.PoseObs(
        p_world=p.to(dev), uv=(p[:, :2] / p[:, 2:] * 500 + 320).to(dev),
        u_right=torch.full((n,), -1.0, device=dev), inv_sigma2=torch.ones(n, device=dev),
        valid=torch.ones(n, dtype=torch.bool, device=dev))
    T0 = torch.eye(4, device=dev)
    cases = {
        "ops/undistort.py undistort_points (10 trips)": lambda: undistort.undistort_points(
            uv, 500.0, 500.0, 320.0, 240.0, dist),
        "solvers/epnp.py _gauss_newton_betas (6 trips)": lambda: epnp._gauss_newton_betas(
            V, rho, betas),
        "solvers/pose_only.py _solve_round_gn (4 trips)": lambda: pose_only._solve_round_gn(
            T0, obs, obs.valid, 500.0, 500.0, 320.0, 320.0, 40.0, True, 4),
    }
    for name, fn in cases.items():
        want = fn()
        sg = graphs.StepGraph(lambda inp, st, fn=fn: (st, fn()), dev, name)
        try:
            outs = [sg.run((), torch.zeros(1, device=dev))[1] for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(o, want) for o in outs)
            print(f"  nodes {name}: {sg.n_nodes} ({sg.n_if} IF, {sg.n_while} WHILE), capture "
                  f"{sg.capture_s:.3f} s; replays equal to eager {same}", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every loop
            print(f"  nodes {name}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)
        del sg
        gc.collect()


def mesh_cases(system, dev, n_frames: int) -> None:
    """The smoke's mesh phase alone (``chip_smoke.run_mesh_phase``: both
    mesh solvers eagerly and as step programs on 8 shards of the card) on
    the map of main path 2 (``SlamSystem``, ``graphs=False``) after
    ``n_frames`` room-orbit frames."""
    import chip_smoke
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    s = system.SlamSystem(cfg, graphs=False)
    for i in range(n_frames):
        g, d, t = room[i]
        s.track(torch.as_tensor(g).to(dev), torch.as_tensor(d).to(dev), t)
    s.results()
    chip_smoke.run_mesh_phase(s, dev)


def mapping_nodes(system, dev) -> None:
    """The graph nodes of the mapping chain's stages, each captured alone
    (its own StepGraph, the keyframe id a device input) on the room orbit's
    map after 6 frames at the default caps, beside the whole chain: the
    share of the background program that the triangulation's neighbour
    slots and keyframe culling's re-selection loop take."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.slam_map import culling, fuse, triangulate
    from vo_slam_test_tpu_torch.utils import graphs

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    s = system.SlamSystem(cfg, graphs=False)
    for i in range(6):
        g, d, t = room[i]
        s.track(torch.as_tensor(g).to(dev), torch.as_tensor(d).to(dev), t)
    s.results()
    m0, caps, cam, sf = s.map, s.caps, s.camera, s.scale_factors
    stages = {
        "culling.cull_map_points": lambda m, k: culling.cull_map_points(m, k, caps),
        "triangulate.create_new_map_points": lambda m, k: triangulate.create_new_map_points(
            m, k, caps, cam, sf),
        "fuse.search_in_neighbors": lambda m, k: fuse.search_in_neighbors(m, k, caps, cam, sf),
        "culling.cull_keyframes": lambda m, k: culling.cull_keyframes(m, k, caps, cam),
        "the whole chain (_mapping_step)": lambda m, k: system._mapping_step(
            m, torch.ones((), dtype=torch.bool, device=dev), k, caps, cam, sf)[0],
    }
    kid = torch.full((), 5, dtype=torch.int32, device=dev)
    for name, fn in stages.items():
        sg = graphs.StepGraph(lambda inp, st, fn=fn: (st, fn(m0, inp[0])), dev, name)
        try:
            for _ in range(2):
                sg.run((kid,), torch.zeros(1, device=dev))
            print(f"  nodes {name}: {sg.n_nodes} ({sg.n_if} IF, {sg.n_while} WHILE), capture "
                  f"{sg.capture_s:.3f} s", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every stage
            print(f"  nodes {name}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)
        del sg
        gc.collect()


def launch_cases(system, dev) -> None:
    """Main path 5 through the step programs twice per setting, the chunk ms
    and the host ms of each ``CUDAGraph.replay`` call (tracking, background):
    in a fresh process, after a short ``torch.profiler`` session, and after
    that session's runs with the profiler's state cleared."""
    import json

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from vo_slam_test_tpu_torch.utils import graphs as graphs_mod

    pseq, pcfg = chip_smoke.pan_sequence()
    pframes = [pseq[i] for i in range(len(pseq))]
    pvoc = chip_smoke.pan_vocabulary(pseq, pcfg, dev)
    replay_ms: dict = {}
    orig = graphs_mod.StepGraph.run

    def timed(sg, *a, **kw):
        if sg.graph is None:
            return orig(sg, *a, **kw)
        replay = sg.graph.replay

        def host_timed():
            t0 = time.perf_counter()
            replay()
            replay_ms.setdefault(sg.name, []).append((time.perf_counter() - t0) * 1e3)
        sg.graph.replay = host_timed
        try:
            return orig(sg, *a, **kw)
        finally:
            sg.graph.replay = replay

    graphs_mod.StepGraph.run = timed
    calls = [i for i in range(len(pframes)) if (i + 1) % chip_smoke.PAN_CHUNK == 0]
    out = {}
    for label in ("fresh", "fresh again", "after a profiler session", "after it, again"):
        if label == "after a profiler session":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                (torch.ones(8, device=dev) * 2).sum().item()
        replay_ms.clear()
        s, r = chip_smoke.run_pan(system, pcfg, pvoc, pframes, chip_smoke.PAN_CHUNK, False,
                                  graphs=True)
        ms = [r["call_ms"][i] for i in calls[1:]]
        out[label] = dict(chunk_ms_median=float(np.median(ms)),
                          replay_host_ms_median={k: float(np.median(v))
                                                 for k, v in replay_ms.items()},
                          nodes=[s.track_graph.n_nodes, s.background_graph.n_nodes])
        print(f"  launch {label}: {json.dumps(out[label])}", flush=True)
        del s
        gc.collect()
    graphs_mod.StepGraph.run = orig


def vocab_paths(system, dev) -> None:
    """The smoke's eigensolver phase, then main path 4 through the step
    programs (``chip_smoke.run_graphs_kidnap``)."""
    import json

    import chip_smoke

    print(json.dumps({"symeig": chip_smoke.run_symeig_phase(dev)}, default=str), flush=True)
    kseq, kcfg = chip_smoke.kidnap_sequence()
    voc = chip_smoke.kidnap_vocabulary(kseq, kcfg, dev)
    rows, launches = chip_smoke.run_graphs_kidnap(
        system, kcfg, voc, chip_smoke.kidnap_frames(kseq, False),
        chip_smoke.kidnap_frames(kseq, True), dev)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk not in ("eager_ms", "graph_ms")}
                      for k, v in rows.items()}, default=str))


def bisect_chain(system, graphs, cfg, frames) -> None:
    """Each stage of the mapping chain captured alone inside a cond, on the
    map of an eager run of the first 6 frames (keyframe events 0, 1, 5)."""
    from vo_slam_test_tpu_torch.slam_map import culling, fuse, triangulate
    from vo_slam_test_tpu_torch.solvers import local_ba

    s = system.SlamSystem(cfg, graphs=False)
    for g, d, t in frames[:6]:
        s.track(g, d, t)
    kf = torch.tensor(2, dtype=torch.int32, device="cuda")
    sf = s.scale_factors
    stages = {
        "cull_map_points": lambda m: culling.cull_map_points(m, kf, s.caps),
        "create_new_map_points": lambda m: triangulate.create_new_map_points(
            m, kf, s.caps, s.camera, sf),
        "search_in_neighbors": lambda m: fuse.search_in_neighbors(m, kf, s.caps, s.camera, sf),
        "local_ba": lambda m: local_ba.local_bundle_adjust_iters(
            m, kf, s.caps, s.camera, 1.0 / (sf * sf), stop=torch.zeros((), dtype=torch.bool,
                                                                       device="cuda"))[0],
        "cull_keyframes": lambda m: culling.cull_keyframes(m, kf, s.caps, s.camera),
    }
    for name, fn in stages.items():
        go = torch.ones((), dtype=torch.bool, device="cuda")
        sg = graphs.StepGraph(lambda inp, m: (graphs.cond(inp[0], fn, lambda m: m, (m,)), ()),
                              "cuda", name)
        try:
            m = s.map
            for _ in range(3):
                m, _ = sg.run((go,), m)
            torch.cuda.synchronize()
            print(f"  bisect {name}: captured and replayed", flush=True)
        except Exception as e:  # noqa: BLE001 - the probe reports every stage
            print(f"  bisect {name}: FAILED {type(e).__name__}: {str(e)[:300]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("graphs_probe: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--skip-chunk", action="store_true")
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--bisect", action="store_true",
                    help="capture each mapping-chain stage alone under a cond first")
    ap.add_argument("--smoke-phase", action="store_true",
                    help="run chip_smoke.run_graphs_phase (paths 1-3) and stop")
    ap.add_argument("--vocab", action="store_true",
                    help="the vocabulary path's operations inside an IF body, the eigensolver "
                         "phase and main path 4 through graphs, then stop")
    ap.add_argument("--close", action="store_true",
                    help="the loop close's operations inside an IF body, then stop")
    ap.add_argument("--loop", action="store_true",
                    help="main paths 5 (chunk=4) and 8a eagerly and through the step programs, "
                         "then stop")
    ap.add_argument("--depth", action="store_true",
                    help="the pose graph's dense solve under nested conds, then stop")
    ap.add_argument("--launch", action="store_true",
                    help="path 5's graph run fresh and after a profiler session, then stop")
    ap.add_argument("--mapping-nodes", action="store_true",
                    help="the mapping chain's stages and the fixed-trip loops, each captured "
                         "alone: their graph nodes, then stop")
    ap.add_argument("--gba", action="store_true",
                    help="global BA's pieces inside WHILE bodies, then its program at two caps "
                         "beside eager; then stop, or go on with --mapping-nodes")
    ap.add_argument("--loops", action="store_true",
                    help="the fixed-trip loops' library ops inside a WHILE body, then the three "
                         "loops captured alone; then stop, or go on with --mesh")
    ap.add_argument("--mesh", action="store_true",
                    help="the smoke's mesh phase (both mesh solvers eagerly and as step "
                         "programs) on main path 2's map after --frames frames, then stop")
    ap.add_argument("--while", dest="while_", action="store_true",
                    help="WHILE nodes: a toy loop, then the background program's op classes "
                         "inside nested WHILE and IF bodies; then stop, or go on with --loop")
    args = ap.parse_args()

    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory
    from vo_slam_test_tpu_torch.ops import _build
    from vo_slam_test_tpu_torch.pipeline import system, tracking
    from vo_slam_test_tpu_torch.utils import graphs

    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        capture_selftest(graphs)
    except Exception:
        traceback.print_exc()
        return 2

    dev = torch.device("cuda")
    if args.loops:
        loop_body_cases(graphs, dev)
        fixed_loop_nodes(dev)
        if not args.mesh:
            return 0
    if args.mesh:
        mesh_cases(system, dev, args.frames)
        return 0
    if args.gba:
        gba_cases(graphs)
        if not args.mapping_nodes:
            return 0
    if args.mapping_nodes:
        mapping_nodes(system, dev)
        fixed_loop_nodes(dev)
        return 0
    if args.while_:
        while_cases(graphs)
        if not args.loop:
            return 0
    if args.close:
        close_cases(graphs)
        return 0
    if args.loop:
        loop_paths(system, dev)
        return 0
    if args.depth:
        depth_cases(graphs)
        return 0
    if args.launch:
        launch_cases(system, dev)
        return 0
    if args.vocab:
        vocab_cases(graphs)
        vocab_paths(system, dev)
        return 0
    if args.smoke_phase:
        import json

        import chip_smoke

        room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room",
                             seed=7)
        seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
        cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                         camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
        room_cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx,
                              camera_cy=room.cy, camera_k1=0, camera_k2=0, camera_p1=0,
                              camera_p2=0, camera_k3=0)
        n = chip_smoke.SLICE_FRAMES
        rows, _ = chip_smoke.run_graphs_phase(
            system, tracking, cfg, [seq[i] for i in range(30)], room_cfg,
            [room[i] for i in range(n)], np.stack([seq.poses[i] for i in range(30)]),
            np.stack([room.poses[i] for i in range(n)]), dev)
        print(json.dumps({str(k): {kk: vv for kk, vv in v.items()
                                   if kk not in ("eager_ms", "graph_ms")}
                          for k, v in rows.items()}))
        return 0
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    frames = [seq[i] for i in range(len(seq))]
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    staged = [(torch.as_tensor(g).to(dev), torch.as_tensor(d).to(dev), t) for g, d, t in frames]
    print("path 1 (FusedTracker, 30 corner frames):", flush=True)
    sites = {} if args.sites else None
    _, (te, se), _, _ = run(lambda: tracking.FusedTracker(cfg, graphs=False), staged, "eager",
                            sites)
    try:
        _, (tg, sg), _, _ = run(lambda: tracking.FusedTracker(cfg), staged, "graphs")
    except Exception:
        traceback.print_exc()
        return 3
    print(f"  trajectories equal: {np.array_equal(te, tg)}; stats equal: {se == sg}")

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    rf = [room[i] for i in range(args.frames)]
    room_cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx,
                          camera_cy=room.cy, camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0,
                          camera_k3=0)
    rstaged = [(torch.as_tensor(g).to(dev), torch.as_tensor(d).to(dev), t) for g, d, t in rf]
    if args.bisect:
        micro_cases(graphs)
        vocab_cases(graphs)
        bisect_chain(system, graphs, room_cfg, rstaged)
    for chunk in ((1,) if args.skip_chunk else (1, 8)):
        print(f"path {2 if chunk == 1 else 3} (SlamSystem chunk={chunk}, {args.frames} room "
              f"frames):", flush=True)
        a, (ta, _, _), _, _ = run(lambda: system.SlamSystem(room_cfg, chunk=chunk, graphs=False),
                                  rstaged, "eager", sites)
        try:
            b, (tb, _, _), _, _ = run(lambda: system.SlamSystem(room_cfg, chunk=chunk), rstaged,
                                      "graphs")
        except Exception:
            traceback.print_exc()
            return 4
        ka = [i for i, o in enumerate(a._outs) if o.made_kf]
        kb = [i for i, o in enumerate(b._outs) if o.made_kf]
        print(f"  keyframes {ka} / {kb}; LM {a.ba_iters} / {b.ba_iters}; trajectories equal "
              f"{np.array_equal(ta, tb)}; map fields differing {same_maps(a, b)}; points "
              f"{a.n_points} / {b.n_points}; replays {b.track_graph.replays} + "
              f"{b.background_graph.replays}")
    if sites is not None:
        print(f"host sync sites of the eager runs: {sites}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
