#!/usr/bin/env python3
"""Times the parts of earlier designs of the BA kernels, the FAST score, the
masked top-2, the IC angle + rBRIEF and the epipolar top-1 beside the current
kernels, on the same inputs, in one run on the card.

    python3 perf/kernel_split.py                # from the repository root: every phase
    python3 perf/kernel_split.py ba_tail fast   # named phases: dpx fast ba ba_tail top2 orb epi
    python3 perf/kernel_split.py epi --v1-only  # the first designs' parts alone
    python3 perf/kernel_split.py fast --fast-against DIR  # and DIR's raw FAST kernel

Prints, after the card's name and power limit:

- the throughput of three-input minima (``perf/dpx_bench.cu``): the packed
  16-bit DPX intrinsic against ``min(min(a, b), c)`` on int, the 32-bit DPX
  form, the packed two-input form and f32, and the min/max instructions the
  compiler chose for each (``cuobjdump -sass``);
- the launch floor (``csrc/noop.cu``): one empty launch and two in a row;
- FAST on a frame's [8,480,640] pyramid: the first design
  (``perf/fast_v1.cu``) and the current kernel, in turns, both equal to the
  plain version, and the current kernel on an all-zero batch of the same
  shape and strides (staging and stores alone); then its 3x3-NMS mode on the
  pyramid and on ``chip_smoke.py``'s random [2,480,640] batch: the first
  design (``perf/fast_nms_v1.cu``) and the current kernel in turns, and the
  current kernel built with other tile heights (``NMS_ROWS``: rows a thread),
  every output checked bit for bit against the first design's; both designs
  on the all-zero batch; and the instructions of each FAST kernel
  (``cuobjdump -sass``);
- ``ba_accumulate`` on the first LM iteration of the local BA with the most
  live points among frames 0-12 of the room orbit: the first design
  (``perf/ba_v1.cu``) whole, launch 1 alone, launch 1 cut to the live
  points, launch 2 alone, its S_red blocks alone, its pose-block blocks alone,
  the newest keyframe's pose block alone and S_red block (0, 0) alone; then
  the current kernel whole and by launch (profiler kernel events), and with
  no live point (what its blocks cost before any work);
- ``ba_cost`` and ``ba_backsub`` (``ba_tail``) on the same captured instance
  and on ``chip_smoke.py``'s seeded full-width one: the earlier designs
  (v1, ``perf/ba_tail_v1.cu``) beside the current kernels, in turns, with the
  outputs checked bit for bit (the cost also against ``ba_accumulate``'s, the
  back-substitution with a finite pose step as the solver gives it, and with
  a NaN step printed); the back-substitution's variants
  (``perf/ba_backsub_variants.cu``: Wc rows strided by L or the records'
  rows, at 32, 64 and 128 threads a block); ``ba_cost`` built from edited
  copies of ``csrc/ba.cu`` with other grids (``COST_SHAPES``: blocks per SM
  and threads per block); ``ba_accumulate`` and ``ba_cost`` built with other
  counts of loads in flight in ``cost_sum`` (``SUM_LOADS``); the current
  ``ba_cost`` with no live point;
- the masked top-2 (``top2``) on ``chip_smoke.py``'s instances of its four
  call sites (the frame pair as its phase 3 builds it, the local map, chi2 and
  batched searches as its capture run keeps them) and on its seeded ones: the
  live rows, columns and allowed pairs, the blocks with no live row (of 8 rows,
  the first design's, and of 16, the current one's), and the first design (``perf/match_v1.cu``) whole, with its staging
  alone and with every row dead; then the current kernel beside it in turns,
  with every row dead, and built from edited copies of ``csrc/match.cu``
  (``TOP2_VARIANTS``: room for two blocks per SM, one 32-column step per
  gate batch with a 32-column queue, other band heights, and the sort without
  the row walks), every output of the exact ones checked bit for bit against
  the first design's;
- the IC angle + rBRIEF (``orb``) on frame 0's keypoints: the first design
  (``perf/orb_v1.cu``) whole, without its disc loop, without thread 0's tail
  and without the pattern samples; then the current kernel beside it in turns
  and built with other counts of keypoints per block (``ORB_KPB``), angle
  and descriptor bits checked against the first design's;
- the epipolar top-1 (``epi``): the live rows, columns and allowed pairs of
  each of main path 2's launches (``chip_smoke.py``'s SlamSystem run over 40
  frames, recorded here) and the distribution of their live rows; on
  ``chip_smoke.py``'s captured instance and its seeded one, the blocks with
  no live row (of 8 and 16 rows) and the first design (``perf/epi_v1.cu``)
  whole, with its staging alone and with every row dead; then the current
  kernel beside it in turns, with every row dead, and built from edited
  copies of ``csrc/epi.cu`` (``EPI_VARIANTS``: other rows and threads per
  block, and the gate without the descriptor round); both designs on each of
  main path 2's launches, in turns, summed; every output of the exact ones,
  and of the current kernel and the plain version on
  ``epi_instances.EPI_EDGE_CASES``, checked bit for bit against the first
  design's.

``--v1-only`` leaves out the current kernels of ``top2``, ``orb`` and ``epi``.
``--fast-against DIR`` adds to ``fast`` the raw kernel of another checkout at DIR (for
example an earlier commit's ``git archive``): each kernel of its ``csrc/fast.cu`` compared
with the current one's SASS instruction by instruction, the raw outputs bit for bit, and
the two raw kernels timed in turns.
Exits 1 if a bit differs.

All times are CUDA-graph replays (``chip_smoke.time_graph_ms``) unless a
line says otherwise. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vo_slam_test_tpu_torch.ops.epi_instances import EPI_EDGE_CASES  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = _I

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: cudaError {rc}")
    return call


def stream():
    return torch.cuda.current_stream().cuda_stream


def dpx_phase(_build, dev):
    lib = ctypes.CDLL(str(_build.library_path("dpx_bench", ROOT / "perf")))
    launch = bind(lib, "dpx_bench_launch", [_P, _P, _I, _I, _I, _I, _P])
    rng = np.random.default_rng(0)
    # two 16-bit lanes, each in [0, 512)
    words = rng.integers(0, 512, 4096).astype(np.uint32) | (
        rng.integers(0, 512, 4096).astype(np.uint32) << 16)
    src = torch.as_tensor(words.view(np.int32)).to(dev)
    blocks, threads, n = 132 * 8, 256, 1024
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    names = ["__vimin3_s16x2 / __vimax3_s16x2", "min(min(a,b),c) on int", "__vimin3_s32",
             "__vmins2 twice", "fminf twice"]
    ops = blocks * threads * n * 12  # three-input minima or maxima per launch
    for which, label in enumerate(names):
        ms = chip_smoke.time_graph_ms(
            lambda: launch(src.data_ptr(), out.data_ptr(), which, blocks, threads, n, stream()),
            n_per_graph=4, reps=3)
        # each round of three minima/maxima also holds two XORs on the same pipe
        per_s = ops / (ms * 1e-3)
        print(f"  three-input min/max, {label}: {ms:.4f} ms for {ops:.3e} -> "
              f"{per_s / 1e9:.0f} G/s; with the XORs {per_s * 5 / 3 / 132 / 1.98e9:.1f} "
              f"instructions per SM per clock at 1.98 GHz")
    for fn, c in sass_counts(_build, _build.library_path("dpx_bench", ROOT / "perf")).items():
        print(f"  sass {fn}: {dict((k, v) for k, v in c.items() if 'MNMX' in k or 'VIM' in k)}")


def sass_text(_build, lib) -> dict:
    """{kernel: [instruction text without its address and encoding]} of a
    built library, from ``cuobjdump -sass`` ({} where the toolkit has none)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        return {}
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fn, out = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = []
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[fn].append(line.split("*/", 1)[1].split("/*")[0].strip())
    return out


def sass_counts(_build, lib) -> dict:
    """{kernel: {opcode: count, "total": instructions}} of a built library."""
    counts = {}
    for fn, text in sass_text(_build, lib).items():
        c = counts[fn] = {"total": len(text)}
        for ins in text:
            tok = ins.replace(";", " ").split()
            op = tok[1] if tok[0].startswith("@") else tok[0]
            c[op] = c.get(op, 0) + 1
    return counts


# rows per thread of the FAST NMS mode's tile variants (csrc/fast.cu NROWS): the
# kernel's 2 (a 64x16 tile), 4 (64x32) and 1 (64x8, two outputs a thread)
NMS_ROWS = (4, 1)


def fast_against_phase(_build, dev, levels, csrc) -> list:
    """The raw FAST kernel of another checkout's ``csrc/fast.cu`` (``csrc``)
    beside the current one: each kernel's SASS compared instruction by
    instruction, the raw outputs bit for bit, the raw times in turns."""
    from vo_slam_test_tpu_torch.ops import fast_cuda

    _build.build([], extra=[("fast", csrc)])
    other, cur = _build.library_path("fast", csrc), _build.library_path("fast")
    a, b = sass_text(_build, cur), sass_text(_build, other)
    for fn in sorted(set(a) | set(b)):
        print(f"  sass {fn}: current {len(a.get(fn, []))} instructions, {csrc} "
              f"{len(b.get(fn, []))}; identical {a.get(fn) == b.get(fn)}")
    raw = bind(ctypes.CDLL(str(other)), "fast_score_launch", fast_cuda.KERNEL.argtypes)
    same = chip_smoke.bits_equal(fast_cuda.fast_score(levels), chip_smoke.fast_call(raw, levels))
    print(f"  fast raw: current bit-equal to {csrc}'s: {same}")
    order = [("other checkout", lambda: chip_smoke.fast_call(raw, levels)),
             ("current", lambda: fast_cuda.fast_score(levels)),
             ("current", lambda: fast_cuda.fast_score(levels)),
             ("other checkout", lambda: chip_smoke.fast_call(raw, levels))]
    for label, fn in order:
        print(f"  fast raw, {label}: {chip_smoke.time_graph_ms(fn):.4f} ms")
    return [] if same else ["fast raw against the other checkout"]


def fast_phase(_build, dev, against=None) -> list:
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.ops import fast, fast_cuda
    from vo_slam_test_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid, interior

    lib = ctypes.CDLL(str(_build.library_path("fast_v1", ROOT / "perf")))
    v1 = bind(lib, "fast_v1_launch", fast_cuda.KERNEL.argtypes)
    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    spec = PyramidSpec(640, 480, 8, 1.2)
    raw = build_pyramid(torch.as_tensor(seq[0][0]).to(dev), spec).raw
    levels = interior(raw, spec)
    # an all-zero batch of the same shape and strides: the interior of a zero canvas
    zeros = interior(torch.zeros_like(raw), spec)
    L, H, W = levels.shape
    out = torch.empty((L, H, W), dtype=torch.float32, device=dev)

    def run_v1():
        v1(levels.data_ptr(), levels.stride(0), levels.stride(1), out.data_ptr(), L, H, W,
           stream())

    run_v1()
    want = fast.fast_score(levels)
    got = fast_cuda.fast_score(levels)
    torch.cuda.synchronize()
    print(f"  fast [{L},{H},{W}]: first design equal to plain {torch.equal(out, want)}, current "
          f"equal to plain {torch.equal(got, want)}; live pixels "
          f"{chip_smoke.fast_live_pixels(levels)} of {L * H * W}, level pixels "
          f"{sum(h * w for h, w in spec.sizes)}")
    differ = [] if torch.equal(out, want) and torch.equal(got, want) else ["fast raw"]
    order = [("first design", run_v1), ("current", lambda: fast_cuda.fast_score(levels)),
             ("current", lambda: fast_cuda.fast_score(levels)), ("first design", run_v1)]
    for label, fn in order:
        print(f"  fast {label}: {chip_smoke.time_graph_ms(fn):.4f} ms")
    # every tile takes the zero exit: staging and stores without the arithmetic
    print(f"  fast current, all-zero batch of the same shape and strides: "
          f"{chip_smoke.time_graph_ms(lambda: fast_cuda.fast_score(zeros)):.4f} ms")

    # the 3x3-NMS mode (row 1b): the first design (perf/fast_nms_v1.cu), the
    # current kernel and its tile variants, on the pyramid and on chip_smoke.py's
    # random batch, every output checked bit for bit against the first design's
    v1n = bind(ctypes.CDLL(str(_build.library_path("fast_nms_v1", ROOT / "perf"))),
               "fast_score_nms_v1_launch", fast_cuda.KERNEL_NMS.argtypes)
    src = (_build.CSRC / "fast.cu").read_text()
    libs = source_variants(_build, {f"fast_nms_rows{k}": define(src, "NROWS", k)
                                    for k in NMS_ROWS})
    variants = {k: bind(libs[f"fast_nms_rows{k}"], "fast_score_nms_launch",
                        fast_cuda.KERNEL_NMS.argtypes) for k in NMS_ROWS}
    rand = chip_smoke.fast_nms_random_levels(dev)
    call = chip_smoke.fast_call
    for label, lv in (("pyramid", levels), ("random batch", rand)):
        ref = call(v1n, lv)
        got = fast_cuda.fast_score(lv, with_nms=True)
        checks = {"plain": torch.equal(got, fast.fast_score_nms(lv)),
                  "first design": chip_smoke.bits_equal(got, ref)}
        checks.update({f"{k} rows a thread": chip_smoke.bits_equal(call(kern, lv), ref)
                       for k, kern in variants.items()})
        print(f"  fast NMS {label} {list(lv.shape)}: current equal to {checks}")
        differ += [f"fast NMS {label}: {k}" for k, ok in checks.items() if not ok]
        order = [("first design", lambda: call(v1n, lv)),
                 ("current", lambda: fast_cuda.fast_score(lv, with_nms=True)),
                 ("current", lambda: fast_cuda.fast_score(lv, with_nms=True)),
                 ("first design", lambda: call(v1n, lv))]
        order += [(f"{k} rows a thread (64x{8 * k} tile)", lambda k=k: call(variants[k], lv))
                  for k in NMS_ROWS]
        for name, fn in order:
            print(f"  fast NMS {label}, {name}: {chip_smoke.time_graph_ms(fn):.4f} ms")
    print(f"  fast NMS current, all-zero batch of the same shape and strides: "
          f"{chip_smoke.time_graph_ms(lambda: fast_cuda.fast_score(zeros, with_nms=True)):.4f} "
          f"ms; first design {chip_smoke.time_graph_ms(lambda: call(v1n, zeros)):.4f} ms")
    for lib_path in (_build.library_path("fast"),
                     _build.library_path("fast_nms_v1", ROOT / "perf")):
        for fn, c in sass_counts(_build, lib_path).items():
            print(f"  sass {lib_path.name} {fn}: {c['total']} instructions; "
                  f"{dict(sorted(c.items(), key=lambda kv: -kv[1])[1:13])}")
    if against is not None:
        differ += fast_against_phase(_build, dev, levels, against)
    return differ


def room_orbit(n_frames):
    """``chip_smoke.py``'s main path 2 inputs: its config and the first
    ``n_frames`` frames of the room orbit."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD
    from vo_slam_test_tpu_torch.datasets.synthetic import room_orbit_trajectory

    room = SyntheticRGBD(trajectory=room_orbit_trajectory(240, loops=1.5), scene="room", seed=7)
    cfg = SlamConfig(camera_fx=room.fx, camera_fy=room.fy, camera_cx=room.cx, camera_cy=room.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_fps=30)
    return cfg, [room[i] for i in range(n_frames)]


def capture():
    """The instances of ``chip_smoke.py``'s capture run over frames 0-12 of
    the room orbit (the BA with the most live points among them)."""
    from vo_slam_test_tpu_torch.ops import ba_cuda, match_cuda
    from vo_slam_test_tpu_torch.pipeline import system

    cfg, frames = room_orbit(13)
    return chip_smoke.capture_instances(match_cuda, ba_cuda, system, cfg, frames)


def ba_phase(_build, dev, captured):
    from vo_slam_test_tpu_torch.ops import ba_cuda

    inst = captured["ba"]
    counts = chip_smoke.ba_counts(inst)
    O, L = inst["slot"].shape
    WF, wk = inst["posesT"].shape[1], inst["wk"]
    n = counts["live_points"]
    print(f"  captured BA instance: WF={WF} wk={wk} O={O} L={L}; {counts}")
    slot, povar = inst["slot"][:, :n], inst["povar"][:, :n] > 0
    per_slot = [int(((slot == a) & povar).any(0).sum()) for a in range(wk)]
    print(f"  points per window slot: {per_slot}")
    has = torch.stack([((slot == a) & povar).any(0) for a in range(wk)]).float()
    both = (has @ has.T).long()
    off = both - torch.diag(torch.diag(both))
    print(f"  points per S_red block: {int((both > 0).sum())} of {wk * wk} blocks non-empty, "
          f"largest off-diagonal {sorted(off.flatten().tolist())[-6:]}")

    lib = ctypes.CDLL(str(_build.library_path("ba_v1", ROOT / "perf")))
    v1 = bind(lib, "ba_v1_launch", [_P] * 12 + [_I] * 5 + [_P] * 10 + [_I, _I, _P])
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty(s, **f32) for s in
            ((wk, 36), (wk, 6), (wk * 6, wk * 6), (wk * 6, 1), (1, 1), (9, L), (3, L))]
    wc = torch.zeros((wk, 18, L), **f32)
    cost_pt = torch.empty((L,), **f32)
    mask = torch.empty((L,), dtype=torch.int32, device=dev)
    ins = [inst[k] for k in ("lam", "cam5", "posesT", "X", "slot", "u", "v", "ur", "isig2",
                             "act", "povar", "n_pts")]

    def run_v1(mode):
        v1(*[t.data_ptr() for t in ins], WF, wk, O, L, int(inst["huber"]),
           *[t.data_ptr() for t in outs], wc.data_ptr(), cost_pt.data_ptr(), mask.data_ptr(),
           mode, n, stream())

    wc_cur = torch.zeros((wk, 18, L), **f32)  # carried over a BA call's iterations, as the
    scratch = ba_cuda.ba_scratch(wk, L, dev)   # solver carries them

    def run_cur():
        return ba_cuda.ba_accumulate(
            inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"],
            inst["ur"], inst["isig2"], inst["act"], inst["povar"], inst["cam5"], wk,
            inst["huber"], n_pts=inst["n_pts"], wc=wc_cur, scratch=scratch)

    run_v1(0)
    cur = run_cur()
    torch.cuda.synchronize()
    diffs = [float((a - b.reshape(a.shape)).abs().max()) for a, b in zip(outs, cur[:7])]
    print(f"  max |first design - current| on (Hpp, bp, S_red, rhs_red, cost, Hinv, bl): {diffs}")
    labels = {0: "whole (launches 1 + 2)", 1: "launch 1", 5: f"launch 1 cut to {n} points",
              2: "launch 2", 3: "launch 2, S_red blocks alone (col < wk)",
              4: "launch 2, pose-block blocks alone (col == wk)",
              6: "launch 2, pose block of slot 0 alone", 7: "launch 2, S_red block (0,0) alone"}
    for mode in (0, 1, 5, 2, 3, 4, 6, 7, 0):
        ms = chip_smoke.time_graph_ms(lambda: run_v1(mode))
        print(f"  ba_accumulate first design, {labels[mode]}: {ms:.4f} ms")
    for _ in range(2):
        print(f"  ba_accumulate current, whole: {chip_smoke.time_graph_ms(run_cur):.4f} ms; "
              f"by launch (profiler): {chip_smoke.launch_times_ms(run_cur)}")
    # no live point: every block of both launches leaves at once
    inst = dict(inst, n_pts=torch.zeros((), dtype=torch.int32, device=dev))
    print(f"  ba_accumulate current with n_pts = 0, whole: "
          f"{chip_smoke.time_graph_ms(run_cur):.4f} ms; by launch (profiler): "
          f"{chip_smoke.launch_times_ms(run_cur)}")


COST_SHAPES = ((1, 128), (1, 256), (2, 128), (4, 128))
# cost_sum's loads in flight per thread (in ba_sum_kernel's cost block and ba_cost_kernel's
# last block alike); every version adds in the same order. 1 is the source as it stands.
SUM_LOADS = (1, 4, 16)
_SUM_LOOP = ("    for (int l = threadIdx.x; l < n; l += RED_THREADS) "
             "acc = __fadd_rn(acc, __ldcg(cost_pt + l));\n")


def batched_sum_loop(k: int) -> str:
    """cost_sum's loop with ``k`` loads in flight per thread before their adds."""
    return f"""    for (int l0 = threadIdx.x; l0 < n; l0 += {k} * RED_THREADS) {{
      float c[{k}];
#pragma unroll
      for (int j = 0; j < {k}; ++j)
        c[j] = l0 + j * RED_THREADS < n ? __ldcg(cost_pt + l0 + j * RED_THREADS) : 0.0f;
#pragma unroll
      for (int j = 0; j < {k}; ++j)
        if (l0 + j * RED_THREADS < n) acc = __fadd_rn(acc, c[j]);
    }}
"""


def source_variants(_build, texts):
    """Edited copies of a ``csrc`` source (``texts``: {name: source}), written
    into ``_build/variants`` and built there -> {name: CDLL}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (out_dir / f"{name}.cu").write_text(text)
    _build.build(texts, out_dir)
    return {name: ctypes.CDLL(str(_build.library_path(name, out_dir))) for name in texts}


def define(src, name, value):
    """``src`` with ``#define name`` set to ``value`` (it must be there once)."""
    text, n = re.subn(rf"#define {name} \d+", f"#define {name} {value}", src)
    assert n == 1, name
    return text


def tail_variants(_build):
    """``csrc/ba.cu`` built with each grid of COST_SHAPES (blocks per SM,
    threads per block of ``ba_cost_kernel``) and each of SUM_LOADS, all in one
    go -> ({shape: cost launch}, {loads: (accumulate launch, cost launch)})."""
    from vo_slam_test_tpu_torch.ops import ba_cuda

    src = (_build.CSRC / "ba.cu").read_text()
    assert src.count(_SUM_LOOP) == 1
    texts = {f"ba_cost_{b}x{th}": define(define(src, "COST_BLOCKS_PER_SM", b), "COST_THREADS", th)
             for b, th in COST_SHAPES}
    texts.update({f"ba_loads_{k}": src.replace(_SUM_LOOP, batched_sum_loop(k)) if k > 1 else src
                  for k in SUM_LOADS})
    libs = source_variants(_build, texts)

    def launch(name, symbol):
        argtypes = {"ba_cost_launch": ba_cuda.KERNEL_COST.argtypes,
                    "ba_accumulate_launch": ba_cuda.KERNEL_ACC.argtypes}[symbol]
        return bind(libs[name], symbol, argtypes)

    shapes = {(b, th): launch(f"ba_cost_{b}x{th}", "ba_cost_launch") for b, th in COST_SHAPES}
    loads = {k: (launch(f"ba_loads_{k}", "ba_accumulate_launch"),
                 launch(f"ba_loads_{k}", "ba_cost_launch")) for k in SUM_LOADS}
    return shapes, loads


def ba_tail_phase(_build, dev, captured) -> list:
    """-> the labels of the outputs that are not bit-equal (empty: all are)."""
    from vo_slam_test_tpu_torch.ops import ba_cuda

    lib = ctypes.CDLL(str(_build.library_path("ba_tail_v1", ROOT / "perf")))
    v1_cost = bind(lib, "ba_tail_v1_cost_launch", [_P] * 10 + [_I] * 4 + [_P] * 3)
    v1_sub = bind(lib, "ba_tail_v1_backsub_launch", [_P] * 5 + [_I] * 2 + [_P] * 2)
    variant = bind(ctypes.CDLL(str(_build.library_path("ba_backsub_variants", ROOT / "perf"))),
                   "ba_backsub_variant_launch", [_P] * 7 + [_I] * 4 + [_P] * 2)
    shapes, loads = tail_variants(_build)
    seeded = chip_smoke.random_ba_instance(np.random.default_rng(2), 64, 24, 12, 8192, 1500, dev)
    rng = np.random.default_rng(3)
    differ = []

    def check(label, a, b):
        ok = chip_smoke.bits_equal(a, b)
        print(f"  {label}: {'bit-equal' if ok else 'NOT bit-equal'}")
        if not ok:
            differ.append(label)

    # the solver's own back-substitution (its Wc, mask and finite step)
    Wc, Hinv, bl, dxp, mask = captured["ba_backsub"]
    n_pts = captured["ba"]["n_pts"]
    wk, _, L = Wc.shape
    dx_v1 = torch.empty((3, L), dtype=torch.float32, device=dev)
    v1_sub(Wc.data_ptr(), Hinv.data_ptr(), bl.data_ptr(), dxp.data_ptr(), n_pts.data_ptr(), wk, L,
           dx_v1.data_ptr(), stream())
    check("ba_backsub on the solver's captured call, current against v1's",
          ba_cuda.ba_backsub(Wc, Hinv, bl, dxp, n_pts=n_pts, mask=mask), dx_v1)

    for label, inst in (("captured", captured["ba"]), ("seeded", seeded)):
        O, L = inst["slot"].shape
        WF, wk, n_pts = inst["posesT"].shape[1], inst["wk"], inst["n_pts"]
        print(f"  {label} instance: WF={WF} wk={wk} O={O} L={L}; {chip_smoke.ba_counts(inst)}")
        scratch, mask = ba_cuda.ba_scratch(wk, L, dev), ba_cuda.ba_mask(L, dev)
        acc = ba_cuda.ba_accumulate(
            inst["lam"], inst["posesT"], inst["X"], inst["slot"], inst["u"], inst["v"], inst["ur"],
            inst["isig2"], inst["act"], inst["povar"], inst["cam5"], wk, inst["huber"],
            n_pts=n_pts, scratch=scratch, mask=mask)
        Wc, Hinv, bl = acc[7], acc[5], acc[6]
        dxp = (captured["ba_backsub"][3] if label == "captured" else torch.as_tensor(
            rng.normal(0, 1e-3, (wk, 6)), dtype=torch.float32).to(dev))
        cost_in = [inst[k] for k in ("cam5", "posesT", "X", "slot", "u", "v", "ur", "isig2", "act",
                                     "n_pts")]
        cost_v1 = torch.empty((1, 1), dtype=torch.float32, device=dev)
        cost_pt_v1 = torch.empty((L,), dtype=torch.float32, device=dev)
        dx_v1 = torch.empty((3, L), dtype=torch.float32, device=dev)
        dx_var = torch.empty((3, L), dtype=torch.float32, device=dev)
        cost_var = torch.empty((1, 1), dtype=torch.float32, device=dev)
        arrived = torch.zeros((1,), dtype=torch.int32, device=dev)
        acc_in = [inst[k] for k in ("lam", "cam5", "posesT", "X", "slot", "u", "v", "ur",
                                    "isig2", "act", "povar", "n_pts")]
        acc_var = [torch.empty_like(t) for t in acc[:7]] + [
            torch.zeros_like(Wc), ba_cuda.ba_scratch(wk, L, dev), torch.empty_like(cost_pt_v1),
            ba_cuda.ba_mask(L, dev)]

        def run_cost_v1():
            v1_cost(*[t.data_ptr() for t in cost_in], WF, O, L, int(inst["huber"]),
                    cost_v1.data_ptr(), cost_pt_v1.data_ptr(), stream())

        def run_cost():
            return ba_cuda.ba_cost(*cost_in[1:9], inst["cam5"], inst["huber"], n_pts=n_pts)

        def run_sub_v1(step=dxp):
            v1_sub(Wc.data_ptr(), Hinv.data_ptr(), bl.data_ptr(), step.data_ptr(),
                   n_pts.data_ptr(), wk, L, dx_v1.data_ptr(), stream())

        def run_sub(step=dxp):
            return ba_cuda.ba_backsub(Wc, Hinv, bl, step, n_pts=n_pts, mask=mask)

        def run_cost_shape(shape):
            shapes[shape](*[t.data_ptr() for t in cost_in], WF, O, L, int(inst["huber"]),
                          cost_var.data_ptr(), cost_pt_v1.data_ptr(), arrived.data_ptr(),
                          stream())

        def run_loads_acc(key):
            loads[key][0](*[t.data_ptr() for t in acc_in], WF, wk, O, L, int(inst["huber"]),
                          *[t.data_ptr() for t in acc_var], stream())

        def run_loads_cost(key):
            loads[key][1](*[t.data_ptr() for t in cost_in], WF, O, L, int(inst["huber"]),
                          cost_var.data_ptr(), cost_pt_v1.data_ptr(), arrived.data_ptr(),
                          stream())

        def run_variant(threads, rec_rows):
            variant(Wc.data_ptr(), scratch.data_ptr(), Hinv.data_ptr(), bl.data_ptr(),
                    dxp.data_ptr(), mask.data_ptr(), n_pts.data_ptr(), wk, L, threads, rec_rows,
                    dx_var.data_ptr(), stream())

        run_cost_v1()
        cost = run_cost()
        check(f"{label}: ba_cost, current against v1's", cost, cost_v1)
        check(f"{label}: ba_cost against ba_accumulate's cost", cost, acc[4])
        for shape in COST_SHAPES:
            run_cost_shape(shape)
            check(f"{label}: ba_cost with {shape[0]} blocks per SM of {shape[1]} threads against "
                  f"v1's", cost_var, cost_v1)
        for key in SUM_LOADS:
            run_loads_acc(key)
            check(f"{label}: ba_accumulate with cost_sum loads {key}, against the current",
                  torch.cat([t.flatten() for t in acc_var[:7]]),
                  torch.cat([t.flatten() for t in acc[:7]]))
            run_loads_cost(key)
            check(f"{label}: ba_cost with cost_sum loads {key}, against v1's", cost_var, cost_v1)
        run_sub_v1()
        check(f"{label}: ba_backsub (finite step), current against v1's", run_sub(), dx_v1)
        for threads in (32, 64, 128):
            for rec_rows in (0, 1):
                run_variant(threads, rec_rows)
                check(f"{label}: ba_backsub variant ({'record' if rec_rows else 'Wc'} rows, "
                      f"{threads} threads) against v1's", dx_var, dx_v1)
        nan_step = dxp.clone()
        nan_step[0, 0] = float("nan")
        run_sub_v1(nan_step)
        got = run_sub(nan_step)
        torch.cuda.synchronize()
        n = int(n_pts)
        print(f"  {label}: ba_backsub with a NaN step: live points all non-finite "
              f"{not bool(torch.isfinite(got[:, :n]).any())}, dead points bit-equal to v1's "
              f"{chip_smoke.bits_equal(got[:, n:], dx_v1[:, n:])}, all bits equal to v1's "
              f"{chip_smoke.bits_equal(got, dx_v1)}")

        times = []
        for name, fn in (("ba_cost v1", run_cost_v1), ("ba_cost current", run_cost),
                         ("ba_cost current", run_cost), ("ba_cost v1", run_cost_v1),
                         ("ba_backsub v1", run_sub_v1), ("ba_backsub current", run_sub),
                         ("ba_backsub current", run_sub), ("ba_backsub v1", run_sub_v1)):
            times.append(f"{name} {chip_smoke.time_graph_ms(fn):.4f}")
        print(f"  {label}: ms (CUDA-graph replays, in turns): " + ", ".join(times))
        var_times = [f"{'record' if r else 'Wc'} rows {th} threads "
                     f"{chip_smoke.time_graph_ms(lambda: run_variant(th, r)):.4f}"
                     for r in (0, 1) for th in (32, 64, 128)]
        print(f"  {label}: ba_backsub variants ms: " + ", ".join(var_times))
        shape_times = [f"{b} x {th} {chip_smoke.time_graph_ms(lambda: run_cost_shape((b, th))):.4f}"
                       for b, th in COST_SHAPES]
        print(f"  {label}: ba_cost by grid (blocks per SM x threads) ms: " + ", ".join(shape_times)
              + f"; arrival counter after the replays {int(arrived)}")
        time = chip_smoke.time_graph_ms
        loads_times = [f"{key} ba_accumulate {time(lambda: run_loads_acc(key)):.4f} ba_cost "
                       f"{time(lambda: run_loads_cost(key)):.4f}" for key in SUM_LOADS]
        print(f"  {label}: by cost_sum's loads in flight per thread, ms: "
              + ", ".join(loads_times))
        print(f"  {label}: by launch (profiler): ba_cost v1 "
              f"{chip_smoke.launch_times_ms(run_cost_v1)}; current "
              f"{chip_smoke.launch_times_ms(run_cost)}; ba_backsub v1 "
              f"{chip_smoke.launch_times_ms(run_sub_v1)}; current "
              f"{chip_smoke.launch_times_ms(run_sub)}")
        if label == "seeded":  # every block arrives with no point: grid, fence and count alone
            none = torch.zeros((), dtype=torch.int32, device=dev)
            ms = chip_smoke.time_graph_ms(
                lambda: ba_cuda.ba_cost(*cost_in[1:9], inst["cam5"], True, n_pts=none))
            print(f"  ba_cost current with n_pts = 0: {ms:.4f} ms")
    return differ


# match.cu built with other shapes and edits: {label: ({#define: value}, [(old, new)
# text], whether the outputs stay the function's)}; the first is the source as it stands
SORT_ALONE = ("    if (walk) {\n      // the gate", "    if (false) {  // no row walks\n      // the gate")
TOP2_VARIANTS = {
    "as it stands": ({}, [], True),
    "2 blocks per SM": ({"MIN_BLOCKS": 2}, [], True),
    "1 step, queue of 32": ({"STEPS": 1, "QCAP": 32}, [], True),
    "bands of 4 px": ({"NB": 128, "BAND_PX": 4}, [], True),
    "bands of 16 px": ({"NB": 32, "BAND_PX": 16}, [], True),
    "bands of 4 px, 2 blocks per SM": ({"NB": 128, "BAND_PX": 4, "MIN_BLOCKS": 2}, [], True),
    "sort alone (no row walks)": ({}, [SORT_ALONE], False),
}
# orb.cu built with other counts of keypoints (warps) per block; the first is
# the source as it stands
ORB_KPB = (4, 2, 8)


def corner_frames(dev):
    """``chip_smoke.py``'s phase 1-3 inputs from the corner sequence's frames 0 and 1."""
    from vo_slam_test_tpu_torch.config import SlamConfig
    from vo_slam_test_tpu_torch.datasets import SyntheticRGBD

    seq = SyntheticRGBD(n_frames=30, seed=0, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    return chip_smoke.frame_instances(seq, cfg, dev)


def top2_instances(dev, frame, captured):
    """[(label, args, kw)]: the four call sites as ``chip_smoke.py`` captures
    them (the frame pair as its phase 3 builds it), then its seeded instances
    (the same seeds, in the same order)."""
    seeded = chip_smoke.seeded_mapping_instances(dev)
    return [
        ("frame pair 1024x1024 (row 3)", frame["top2_args"], {}),
        ("captured local map 4096x1024 (row 3)", *captured["top2_m4096"]),
        ("captured chi2 4096x1024 (row 4)", *captured["top2_chi2"]),
        ("captured batched 16x1024x1024 (row 5)", *captured["top2_nb"]),
        ("seeded 1024x1024", chip_smoke.random_top2_instance(np.random.default_rng(0), 1024, 1024,
                                                             dev), {}),
        ("seeded 4096x1024", *seeded["top2_m4096"]),
        ("seeded chi2 4096x1024", *seeded["top2_chi2"]),
        ("seeded batched 16x1024x1024", *seeded["top2_nb"]),
    ]


def dead_block_share(row_ok, rows_per_block):
    """Blocks of ``rows_per_block`` rows (per search) that hold no live row."""
    ok = row_ok.reshape(-1, row_ok.shape[-1])
    B, M = ok.shape
    pad = torch.zeros((B, -M % rows_per_block), dtype=torch.bool, device=ok.device)
    blocks = torch.cat([ok, pad], 1).reshape(B, -1, rows_per_block).any(-1)
    return int((~blocks).sum()), blocks.numel()


def edited(src, defines, edits):
    """``src`` with its ``#define``s set (``define``) and each (old, new) text edit made
    (each old text must be there once)."""
    for name, value in defines.items():
        src = define(src, name, value)
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def top2_variants(_build):
    """``csrc/match.cu`` built as each of TOP2_VARIANTS -> {label: launch}."""
    from vo_slam_test_tpu_torch.ops import match_cuda

    src = (_build.CSRC / "match.cu").read_text()
    names = {label: f"match_variant_{i}" for i, label in enumerate(TOP2_VARIANTS)}
    libs = source_variants(_build, {names[label]: edited(src, d, e)
                                    for label, (d, e, _) in TOP2_VARIANTS.items()})
    return {label: bind(libs[names[label]], "masked_top2_launch", match_cuda.KERNEL.argtypes)
            for label in TOP2_VARIANTS}


def top2_phase(_build, dev, captured, v1_only) -> list:
    """-> the labels of the outputs that are not bit-equal (empty: all are)."""
    from vo_slam_test_tpu_torch.ops import match_cuda

    _, top2_v1, _ = chip_smoke.v1_launchers(_build)
    time = chip_smoke.time_graph_ms
    shapes = {} if v1_only else top2_variants(_build)
    differ = []
    for label, args, kw in top2_instances(dev, corner_frames(dev), captured):
        chi2 = kw.get("chi2_gate", False)
        _, _, counted = chip_smoke.top2_bound(args, kw.get("col_isig2"), chi2)
        dead8, dead16 = dead_block_share(args[9], 8), dead_block_share(args[9], 16)
        dead = list(args)
        dead[9] = torch.zeros_like(args[9])
        v1 = lambda mode, a=args: chip_smoke.top2_call(top2_v1(mode), a, kw)  # noqa: E731
        print(f"  {label}: {counted}; blocks with no live row: {dead8[0]} of {dead8[1]} of 8 "
              f"rows (v1), {dead16[0]} of {dead16[1]} of 16 rows (current)")
        print(f"  {label}: v1 whole {time(lambda: v1(0)):.4f} ms, staging alone (no lane loop) "
              f"{time(lambda: v1(1)):.4f} ms, every row dead "
              f"{time(lambda: v1(0, dead)):.4f} ms")
        if v1_only:
            continue
        want = torch.cat([o.flatten() for o in v1(0)])
        cur = lambda a=args: chip_smoke.top2_call(match_cuda.KERNEL, a, kw)  # noqa: E731
        for name, got in [("current", cur()), ("current, every row dead", cur(dead))] + [
                (f"variant {vname}", chip_smoke.top2_call(fn, args, kw))
                for vname, fn in shapes.items() if TOP2_VARIANTS[vname][2]]:
            ref = want if "dead" not in name else torch.cat([o.flatten() for o in v1(0, dead)])
            ok = chip_smoke.bits_equal(torch.cat([o.flatten() for o in got]), ref)
            if not ok:
                differ.append(f"{label}: {name}")
                print(f"  {label}: {name} NOT bit-equal to v1")
        turns = [f"{name} {time(fn):.4f}" for name, fn in
                 (("v1", lambda: v1(0)), ("current", cur), ("current", cur), ("v1", lambda: v1(0)))]
        print(f"  {label}: ms in turns: " + ", ".join(turns) + f"; current with every row dead "
              f"{time(lambda: cur(dead)):.4f}")
        print(f"  {label}: current built as each variant, ms: " + ", ".join(
            f"{name} {time(lambda fn=fn: chip_smoke.top2_call(fn, args, kw)):.4f}"
            for name, fn in shapes.items()))
    return differ


def orb_variants(_build):
    """``csrc/orb.cu`` built with each count of ORB_KPB -> {count: launch}."""
    from vo_slam_test_tpu_torch.ops import orb_cuda

    src = (_build.CSRC / "orb.cu").read_text()
    libs = source_variants(_build, {f"orb_{k}": define(src, "KPB", k) for k in ORB_KPB})
    return {k: bind(libs[f"orb_{k}"], "orb_angle_desc_launch", orb_cuda.KERNEL.argtypes)
            for k in ORB_KPB}


def orb_phase(_build, dev, v1_only) -> list:
    """-> the labels of the outputs that are not bit-equal (empty: all are)."""
    from vo_slam_test_tpu_torch.ops import orb_cuda

    orb_v1, _, _ = chip_smoke.v1_launchers(_build)
    time = chip_smoke.time_graph_ms
    frame = corner_frames(dev)
    pyr, sel = frame["pyr"], frame["sel"]
    orb_in = (pyr.raw, pyr.blur, sel.level, sel.ys, sel.xs)
    print(f"  orb on frame 0's keypoints: N={sel.level.shape[0]} ({int(sel.valid.sum())} valid), "
          f"canvas {tuple(pyr.raw.shape)}")
    labels = {0: "whole", 1: "without the disc loop", 2: "without thread 0's tail (fixed angle)",
              3: "without the pattern samples"}
    print("  orb v1: " + ", ".join(
        f"{labels[m]} {time(lambda m=m: chip_smoke.orb_call(orb_v1(m), *orb_in)):.4f} ms"
        for m in labels))
    if v1_only:
        return []
    want = chip_smoke.orb_call(orb_v1(0), *orb_in)
    variants = orb_variants(_build)
    differ = []
    for name, fn in [("current", orb_cuda.KERNEL)] + [(f"{k} keypoints per block", v)
                                                      for k, v in variants.items()]:
        got = chip_smoke.orb_call(fn, *orb_in)
        if not all(chip_smoke.bits_equal(g, w) for g, w in zip(got, want)):
            differ.append(f"orb {name}")
            print(f"  orb {name}: NOT bit-equal to v1 (angle and descriptor)")
    v1 = lambda: chip_smoke.orb_call(orb_v1(0), *orb_in)  # noqa: E731
    cur = lambda: orb_cuda.orb_angle_desc(*orb_in)  # noqa: E731
    print("  orb ms in turns: " + ", ".join(
        f"{name} {time(fn):.4f}" for name, fn in (("v1", v1), ("current", cur), ("current", cur),
                                                  ("v1", v1))))
    print("  orb current by keypoints per block, ms: " + ", ".join(
        f"{k} {time(lambda v=v: chip_smoke.orb_call(v, *orb_in)):.4f}"
        for k, v in variants.items()))
    return differ


# epi.cu built with other shapes and edits: {label: ({#define: value}, whether the
# descriptor stage is cut (EPI_NO_DESC), whether the outputs stay the function's)};
# the first is the source as it stands
EPI_DESC_STAGE = ("    // the descriptors of the columns some row allows", "  __syncthreads();\n")
EPI_NO_DESC = """#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)  // no descriptor round: the gate's keys alone
      if (am[i]) atomicMin(&skey[__ffs(am[i]) - 1], (unsigned)(c0 + t + i * THREADS));
  }

"""
EPI_VARIANTS = {
    "as it stands": ({}, False, True),
    "8 rows, 256 threads": ({"ROWS": 8, "THREADS": 256, "PER_THREAD": 4}, False, True),
    "32 rows": ({"ROWS": 32}, False, True),
    "256 threads": ({"THREADS": 256, "PER_THREAD": 4}, False, True),
    "no descriptor round": ({}, True, False),
}


def epi_variants(_build):
    """``csrc/epi.cu`` built as each of EPI_VARIANTS -> {label: launch}."""
    from vo_slam_test_tpu_torch.ops import match_cuda

    src = (_build.CSRC / "epi.cu").read_text()
    start, end = src.index(EPI_DESC_STAGE[0]), src.index(EPI_DESC_STAGE[1])
    no_desc = [(src[start:end], EPI_NO_DESC)]
    names = {label: f"epi_variant_{i}" for i, label in enumerate(EPI_VARIANTS)}
    libs = source_variants(_build, {names[label]: edited(src, d, no_desc if cut else [])
                                    for label, (d, cut, _) in EPI_VARIANTS.items()})
    return {label: bind(libs[names[label]], "masked_top1_epi_launch",
                        match_cuda.KERNEL_EPI.argtypes) for label in EPI_VARIANTS}


def main_path_epi_calls(cfg, frames):
    """The arguments of every epipolar search of one SlamSystem run (main
    path 2: local BA on every keyframe event) over ``frames``."""
    from vo_slam_test_tpu_torch.ops import match_cuda
    from vo_slam_test_tpu_torch.pipeline import system

    calls = []
    orig = match_cuda.masked_top1_epi

    def recorded(*args):
        calls.append([a.clone() for a in args])
        return orig(*args)

    match_cuda.masked_top1_epi = recorded
    try:
        s = system.SlamSystem(cfg)
        for f in frames:
            s.track(*f)
        torch.cuda.synchronize()
    finally:
        match_cuda.masked_top1_epi = orig
    return calls


def epi_phase(_build, dev, captured, v1_only) -> list:
    """-> the labels of the outputs that are not bit-equal (empty: all are)."""
    from vo_slam_test_tpu_torch.ops import match_cuda, match_pallas

    _, _, epi_v1 = chip_smoke.v1_launchers(_build)
    time = chip_smoke.time_graph_ms
    variants = {} if v1_only else epi_variants(_build)
    differ = []

    def check(label, got, want):
        if not chip_smoke.bits_equal(torch.cat(got), torch.cat(want)):
            differ.append(label)
            print(f"  {label}: NOT bit-equal to v1")

    cfg, frames = room_orbit(chip_smoke.SLICE_FRAMES)
    calls = main_path_epi_calls(cfg, frames)
    print(f"  main path 2 ({len(frames)} frames): {len(calls)} launches; per launch (live rows, "
          f"live columns, allowed pairs, rows with an allowed pair, 16-row blocks with no live "
          f"row): " + ", ".join(
              f"({c['live_rows']}, {c['live_cols']}, {c['allowed_pairs']}, "
              f"{int((match_pallas.masked_top1_epi_plain(*a)[1] < match_pallas.BIG).sum())}, "
              f"{dead_block_share(a[5], 16)[0]})"
              for a, c in ((a, chip_smoke.epi_bound(a)[2]) for a in calls)))
    live = sorted(int(a[5].sum()) for a in calls)
    print(f"  main path 2: live rows per launch, sorted {live}; median {live[len(live) // 2]}, "
          f"sum {sum(live)}")

    seeded = chip_smoke.seeded_mapping_instances(dev)["top1_epi"][0]
    for label, args in (("captured main path 2 1024x1024 (row 6)", captured["top1_epi"][0]),
                        ("seeded 1024x1024", seeded)):
        _, _, counted = chip_smoke.epi_bound(args)
        dead8, dead16 = dead_block_share(args[5], 8), dead_block_share(args[5], 16)
        dead = list(args)
        dead[5] = torch.zeros_like(args[5])
        v1 = lambda mode, a=args: chip_smoke.epi_call(epi_v1(mode), a)  # noqa: E731
        print(f"  {label}: {counted}; blocks with no live row: {dead8[0]} of {dead8[1]} of 8 "
              f"rows (v1), {dead16[0]} of {dead16[1]} of 16 rows")
        print(f"  {label}: v1 whole {time(lambda: v1(0)):.4f} ms, staging alone (no lane loop) "
              f"{time(lambda: v1(1)):.4f} ms, every row dead {time(lambda: v1(0, dead)):.4f} ms")
        if v1_only:
            continue
        cur = lambda a=args: match_cuda.masked_top1_epi(*a)  # noqa: E731
        check(f"{label}: current", cur(), v1(0))
        check(f"{label}: current, every row dead", cur(dead), v1(0, dead))
        for vname, fn in variants.items():
            if EPI_VARIANTS[vname][2]:
                check(f"{label}: variant {vname}", chip_smoke.epi_call(fn, args), v1(0))
        turns = [f"{name} {time(fn):.4f}" for name, fn in
                 (("v1", lambda: v1(0)), ("current", cur), ("current", cur), ("v1", lambda: v1(0)))]
        print(f"  {label}: ms in turns: " + ", ".join(turns) + f"; current with every row dead "
              f"{time(lambda: cur(dead)):.4f}")
        print(f"  {label}: current built as each variant, ms: " + ", ".join(
            f"{name} {time(lambda fn=fn: chip_smoke.epi_call(fn, args)):.4f}"
            for name, fn in variants.items()))

    # every launch of main path 2, each design timed on it in turns: row 6's
    # device time over the run, and its loss against the bounds
    bounds = [chip_smoke.epi_bound(a)[0] for a in calls]
    v1_ms, cur_ms = [], []
    for a in calls:
        v1 = lambda a=a: chip_smoke.epi_call(epi_v1(0), a)  # noqa: E731
        if v1_only:
            v1_ms.append(time(v1))
            continue
        check(f"main path 2 launch {len(cur_ms)}: current", match_cuda.masked_top1_epi(*a), v1())
        cur = lambda a=a: match_cuda.masked_top1_epi(*a)  # noqa: E731
        t = [time(v1), time(cur), time(cur), time(v1)]
        v1_ms.append((t[0] + t[3]) / 2)
        cur_ms.append((t[1] + t[2]) / 2)
    for name, ms in (("v1", v1_ms), ("current", cur_ms)):
        if ms:
            print(f"  main path 2, {name}: {sum(ms):.4f} ms over the {len(ms)} launches (per "
                  f"launch {[round(x, 4) for x in ms]}); lost against the bounds "
                  f"{sum(m - b for m, b in zip(ms, bounds)):.4f} ms")
    if not v1_only:
        for kind, M, N in EPI_EDGE_CASES:
            args = chip_smoke.epi_edge_instance(kind, M, N, dev)
            got = match_cuda.masked_top1_epi(*args)
            check(f"edge {kind} {M}x{N}: current", got, chip_smoke.epi_call(epi_v1(0), args))
            check(f"edge {kind} {M}x{N}: plain", match_pallas.masked_top1_epi_plain(*args),
                  chip_smoke.epi_call(epi_v1(0), args))
        print(f"  edge instances {len(EPI_EDGE_CASES)}: current and plain checked "
              f"against v1")
    return differ


PHASES = ("dpx", "fast", "ba", "ba_tail", "top2", "orb", "epi")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device available", file=sys.stderr)
        return 1
    v1_only = "--v1-only" in argv
    against = None
    if "--fast-against" in argv:
        i = argv.index("--fast-against")
        against = Path(argv[i + 1]) / "vo_slam_test_tpu_torch" / "csrc"
        argv = argv[:i] + argv[i + 2:]
    phases = [a for a in argv if a != "--v1-only"] or PHASES
    if set(phases) - set(PHASES):
        print(f"kernel_split: phases are {PHASES}", file=sys.stderr)
        return 2
    from vo_slam_test_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build(extra=[(n, ROOT / "perf") for n in (
        "dpx_bench", "fast_v1", "fast_nms_v1", "ba_v1", "ba_tail_v1", "ba_backsub_variants",
        "match_v1", "orb_v1", "epi_v1")])
    for k, v in built.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {k}.cu: {line.strip()}")
    noop = bind(_build.load("noop"), "noop_launch", [_I, _P])
    for n in (1, 2):
        print(f"  launch floor, {n} empty launch(es) in a row: "
              f"{chip_smoke.time_graph_ms(lambda: noop(n, stream())):.4f} ms")
    if "dpx" in phases:
        dpx_phase(_build, dev)
    differ = []
    if "fast" in phases:
        print("FAST (row 1) and its 3x3-NMS mode (row 1b), the first designs (v1) beside the "
              "current kernels:")
        differ += fast_phase(_build, dev, against)
    if {"ba", "ba_tail", "top2", "epi"} & set(phases):
        captured = capture()
        if "ba" in phases:
            ba_phase(_build, dev, captured)
        if "ba_tail" in phases:
            print("ba_cost and ba_backsub, the earlier designs (v1) beside the current kernels:")
            differ += ba_tail_phase(_build, dev, captured)
        if "top2" in phases:
            print("masked top-2 (rows 3-5), the first design (v1) beside the current kernel:")
            differ += top2_phase(_build, dev, captured, v1_only)
        if "epi" in phases:
            print("epipolar top-1 (row 6), the first design (v1) beside the current kernel:")
            differ += epi_phase(_build, dev, captured, v1_only)
    if "orb" in phases:
        print("IC angle + rBRIEF (row 2), the first design (v1) beside the current kernel:")
        differ += orb_phase(_build, dev, v1_only)
    if differ:
        print(f"kernel_split: outputs not bit-equal: {differ}")
        return 1
    print("kernel_split: done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
