"""The hand kernels' rooflines in a cell: which kernels the window launched, and
how close each comes to its bound.

- Launches are counted on the device: the trace run captures its step
  programs inside ``graphs.counting()``, so each replay counts the kernel
  launches of every conditional body it runs; the launches made outside the
  programs (each system's first frame) are the wrappers' own counts.
- Instances are recorded at the cell's own call sites: an eager system (the
  same functions, run without graphs) over the recording's first frames,
  keeping for each site the call with the most work.
- Each instance is timed alone: 20 calls captured in a CUDA graph, replayed
  5 times between CUDA events.
- Bounds: the least time the work needs on an H100 at its published peaks,
  the larger of bytes over 3.35 TB/s and operations by instruction class over
  the f32 lane rate (a copy of the port's smoke test's bound functions,
  checked by brute force in ``tests/test_bounds.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .reference import RING

# published H100 SXM peaks (dense): HBM bandwidth and the f32 rate, an FMA
# counted as two operations; instruction classes by compute capability 9.0's
# per-SM throughput: f32 128 lanes a clock, 32-bit integer and logic 64,
# popc 16, f64 64; four schedulers issue at most 128 lanes a clock in all
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FMA_PER_S = F32_FLOPS / 2
OP_RATES = {"f32": FMA_PER_S, "alu": FMA_PER_S / 2, "popc": FMA_PER_S / 8, "f64": FMA_PER_S / 2}
DISPATCH_PER_S = FMA_PER_S
# per pair of live pixels (two 16-bit lanes a word): 17 packed subtracts and 80
# three-input packed minima and maxima
FAST_PAIR_OPS = {"alu": 17 + 2 * (16 + 16 + 8)}
TOP2_PAIR_OPS = {"alu": 19, "popc": 8}
TOP1_PAIR_OPS = {"alu": 18, "popc": 8}
CHI2_MONO, CHI2_STEREO = 5.991, 7.815
N_DISC = 749  # pixels of the 31x31 orientation disc (reference.disc_mask)
RECORD_FRAMES = 24  # frames of the eager pass that records the instances


def bound_ms(n_bytes: float, ops: dict):
    """Least time for the work -> (ms, "bytes" or "operations"): the larger of
    bytes over the memory rate and the operations' time (each class over its
    rate, and all of them over the dispatch rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max([n / OP_RATES[k] for k, n in ops.items()] + [sum(ops.values()) / DISPATCH_PER_S])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _count(ops: dict, n: int, into: dict) -> None:
    for k, v in ops.items():
        into[k] = into.get(k, 0) + v * n


def fast_live_pixels(levels: torch.Tensor) -> int:
    """Pixels whose FAST score can be non-zero: the centre or a ring pixel is
    non-zero (indices wrap)."""
    nz = levels != 0
    live = nz.clone()
    for dx, dy in RING:
        live |= torch.roll(nz, shifts=(-dy, -dx), dims=(-2, -1))
    return int(live.sum())


def fast_bound(levels: torch.Tensor):
    """Every pixel read once and its score written once; operations for the
    live pixels, two to a word."""
    n, live = levels.numel(), fast_live_pixels(levels)
    ms, by = bound_ms(8 * n, {k: v * ((live + 1) // 2) for k, v in FAST_PAIR_OPS.items()})
    return ms, by


def orb_bound(n_kp: int):
    """Per keypoint: the disc and the 512 pattern samples read, 12 bytes in and
    36 out, the pattern once; 2 FMAs a disc pixel, 9 per pattern pair, 30 more."""
    return bound_ms(n_kp * (N_DISC + 512) * 4 + n_kp * 12 + 256 * 16 + n_kp * 36,
                    {"f32": n_kp * (2 * N_DISC + 256 * 9 + 30)})


def allowed_mask(row_u, row_v, row_rw, row_ur, row_rur, row_lo, row_hi, row_ok,
                 col_u, col_v, col_ur, col_oct, col_ok, col_isig2=None, chi2: bool = False):
    """[M, N] bool: the top-2 search's gates (window, octave, stereo or chi2)."""
    du = col_u[None, :] - row_u[:, None]
    dv = col_v[None, :] - row_v[:, None]
    ok = (row_ok[:, None] & col_ok[None, :] & (du.abs() < row_rw[:, None])
          & (dv.abs() < row_rw[:, None]) & (col_oct[None, :] >= row_lo[:, None])
          & (col_oct[None, :] <= row_hi[:, None]))
    if chi2:
        e2 = du * du + dv * dv
        dur = row_ur[:, None] - col_ur[None, :]
        return ok & torch.where(col_ur[None, :] >= 0.0,
                                (e2 + dur * dur) * col_isig2[None, :] <= CHI2_STEREO,
                                e2 * col_isig2[None, :] <= CHI2_MONO)
    return ok & ((col_ur[None, :] <= 0.0)
                 | ((row_ur[:, None] - col_ur[None, :]).abs() <= row_rur[:, None]))


def epi_allowed_mask(row_l, row_den, row_g, row_ok, row_mono,
                     col_u, col_v, col_thr, col_g, col_ok, col_flag):
    """[M, N] bool: the epipolar search's gates."""
    num = row_l[:, 0:1] * col_u[None, :] + row_l[:, 1:2] * col_v[None, :] + row_l[:, 2:3]
    return (row_ok[:, None] & col_ok[None, :] & (num * num < row_den[:, None] * col_thr[None, :])
            & ((row_g[:, None] == col_g[None, :]) | (row_g < 0)[:, None] | (col_g < 0)[None, :])
            & ~(row_mono[:, None] & col_flag[None, :]))


def top2_bound(args, col_isig2=None, chi2: bool = False):
    """One top-2 launch ([M,...] or batched [B,M,...]): bytes for row flags and
    outputs, live rows' and columns' gate data, and the descriptors of rows
    and columns with an allowed pair; operations on each live pair (the gates)
    and on each allowed pair (the distance and the top-2 update)."""
    batched = args[0].dim() == 3
    x = [t if batched else t[None] for t in args]
    isig = None if col_isig2 is None else (col_isig2 if batched else col_isig2[None])
    B, M, N = x[0].shape[0], x[0].shape[1], x[1].shape[1]
    row_ok, col_ok = x[9], x[14]
    live_r = row_ok.sum(1, dtype=torch.int64)
    live_c = col_ok.sum(1, dtype=torch.int64)
    mask = torch.stack([allowed_mask(*[t[b] for t in x[2:15]],
                                     None if isig is None else isig[b], chi2) for b in range(B)])
    allowed = int(mask.sum())
    rows_a = mask.any(2)
    src_rows = (int(rows_a.any(0).sum()) if batched and args[0].stride(0) == 0
                else int(rows_a.sum()))
    cols_a = int(mask.any(1).sum())
    col_bytes = (N + live_c * (16 + (4 if chi2 else 0))) * (live_r > 0)
    n_bytes = B * M * 17 + int(live_r.sum()) * 28 + int(col_bytes.sum()) + (src_rows + cols_a) * 32
    live_pairs = int((live_r * live_c).sum())
    ops: dict = {}
    if chi2:
        stereo_c = (col_ok & (x[12] >= 0)).sum(1, dtype=torch.int64)
        _count({"f32": 6, "alu": 6}, live_pairs, ops)
        _count({"f32": 3}, int((live_r * stereo_c).sum()), ops)
    else:
        _count({"f32": 3, "alu": 7}, live_pairs, ops)
    _count(TOP2_PAIR_OPS, allowed, ops)
    return bound_ms(n_bytes, ops)


def epi_bound(args):
    """One epipolar top-1 launch, counted as the top-2's."""
    M, N = args[0].shape[0], args[1].shape[0]
    live_r, live_c = int(args[5].sum()), int(args[11].sum())
    mask = epi_allowed_mask(*args[2:])
    allowed = int(mask.sum())
    rows_a, cols_a = int(mask.any(1).sum()), int(mask.any(0).sum())
    ops: dict = {}
    _count({"f32": 6, "alu": 5}, live_r * live_c, ops)
    _count(TOP1_PAIR_OPS, allowed, ops)
    n_bytes = M * 9 + live_r * 21 + ((N + live_c * 17) if live_r else 0) + (rows_a + cols_a) * 32
    return bound_ms(n_bytes, ops)


def ba_counts(inst: dict) -> dict:
    slot, povar, wk = inst["slot"], inst["povar"] > 0, inst["wk"]
    n = int(inst["n_pts"])
    valid = slot[:, :n] >= 0
    win = (slot[:, :n, None] == torch.arange(wk, device=slot.device)) & povar[:, :n, None]
    per_pt = win.any(0).sum(1)
    return dict(live_points=n, observations=int(valid.sum()), window_observations=int(win.sum()),
                point_slots=int(per_pt.sum()), slot_pairs=int((per_pt * per_pt).sum()))


def ba_bound(kind: str, inst: dict):
    """One BA kernel call, live points only: bytes of each input read once and
    each output written once; f32 instructions per observation, per window
    observation, per (point, window slot), per pair of window slots and per
    point (the residual, Jacobians, Schur terms, inverse, back-substitution)."""
    c = ba_counts(inst)
    O = inst["slot"].shape[0]
    WF, wk = inst["posesT"].shape[1], inst["wk"]
    pts, obs, wobs, ps, pairs = (c[k] for k in ("live_points", "observations",
                                                 "window_observations", "point_slots",
                                                 "slot_pairs"))
    if kind == "acc":
        n_bytes = (64 * WF + pts * (12 + 4 * O) + obs * 24 + pts * 48 + ps * 72
                   + 4 * (wk * 42 + (wk * 6) ** 2 + wk * 6 + 1))
        ops = obs * (38 + 108 + 36) + wobs * (72 + 108) + ps * 72 + pairs * 108 + pts * 40
    elif kind == "cost":
        n_bytes = 64 * WF + pts * (12 + 4 * O) + obs * 20 + 4
        ops = obs * 38
    else:
        n_bytes = pts * (48 + 12) + ps * 72 + wk * 24
        ops = ps * 18 + pts * 12
    return bound_ms(n_bytes, {"f32": ops})


def kernel_names() -> dict:
    """Each hand kernel's launch counter (``_build.Kernel``) -> its name."""
    from vo_slam_test_tpu_torch.ops import ba_cuda, fast_cuda, match_cuda, orb_cuda, symeig_cuda

    return {fast_cuda.KERNEL: "fast", fast_cuda.KERNEL_NMS: "fast_nms", orb_cuda.KERNEL: "orb",
            match_cuda.KERNEL: "top2", match_cuda.KERNEL_LOCAL: "top2_m4096",
            match_cuda.KERNEL_CHI2: "top2_chi2", match_cuda.KERNEL_NB: "top2_nb",
            match_cuda.KERNEL_EPI: "top1_epi", ba_cuda.KERNEL_ACC: "ba_acc",
            ba_cuda.KERNEL_COST: "ba_cost", ba_cuda.KERNEL_BACKSUB: "ba_backsub",
            symeig_cuda.KERNEL: "symeig"}


def wrapper_counts() -> Dict[str, int]:
    return {name: k.launches for k, name in kernel_names().items()}


def window_launches(systems, eager_before: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Launches by kernel name in the window: every system's replays counted on
    the device, plus the wrappers' own launches since ``eager_before``."""
    names = kernel_names()
    out: Dict[str, int] = {}
    for s in systems:
        for prog in (s.track_graph, s.background_graph):
            if prog.last is None or prog.last.graph is None:
                continue
            for k, n in prog.launches().items():
                if k in names:
                    out[names[k]] = out.get(names[k], 0) + n
    if eager_before is not None:
        for name, n in wrapper_counts().items():
            out[name] = out.get(name, 0) + n - eager_before.get(name, 0)
    return {k: v for k, v in out.items() if v}


def time_graph_ms(fn: Callable, n_per_graph: int = 20, reps: int = 5) -> float:
    """Device ms of one call: ``n_per_graph`` calls in a CUDA graph, replayed
    ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n_per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * n_per_graph)


def _keep(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class Recorder:
    """Wraps the kernel wrappers and keeps, per call site, the call with the
    most work: the top-2 and top-1 searches by rows with an allowed pair, the
    BA kernels by live points (the accumulate, the first back-substitution
    after it with a finite pose step, and the cost, of one LM iteration)."""

    def __init__(self):
        from vo_slam_test_tpu_torch.ops import ba_cuda, fast_cuda, match_cuda, orb_cuda

        self.mods = dict(fast=fast_cuda, orb=orb_cuda, match=match_cuda, ba=ba_cuda)
        self.got: dict = {}
        self.score: dict = {}
        self.saved: list = []
        self.ba: dict = {"n": -1}

    def _wrap(self, mod, attr, on_call):
        fn = getattr(mod, attr)
        self.saved.append((mod, attr, fn))

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            on_call(args, kw, out)
            return out

        setattr(mod, attr, wrapped)

    def _put(self, site, score, args, kw):
        if score >= self.score.get(site, -1):
            self.score[site] = score
            self.got[site] = ([_keep(a) for a in args], {k: _keep(v) for k, v in kw.items()})

    def __enter__(self):
        m = self.mods
        match = m["match"]

        def fast(args, kw, out):
            if not kw.get("with_nms"):
                self._put("fast", 0, args, kw)

        def orb(args, kw, out):
            self._put("orb", int(args[2].shape[0]), args, kw)

        def top2(args, kw, out):
            site = ("top2_chi2" if kw.get("chi2_gate") else
                    "top2_m4096" if kw.get("kernel") is match.KERNEL_LOCAL else "top2")
            self._put(site, int((out[1] < (1 << 20)).sum()), args, kw)

        def top2_nb(args, kw, out):
            n = int((out[1] < (1 << 20)).sum())
            self._put("top2_nb", n, args, kw)
            if self.score["top2_nb"] == n and args[0].stride(0) == 0:
                # the neighbours share one source set: keep it shared (stride 0)
                kept = self.got["top2_nb"][0]
                kept[0] = kept[0][0][None].expand_as(kept[0])

        def epi(args, kw, out):
            self._put("top1_epi", int((out[1] < (1 << 20)).sum()), args, kw)

        ba = self.ba

        def acc(args, kw, out):
            n = int(kw["n_pts"])
            if n > ba["n"]:
                ba.clear()
                ba.update(n=n, acc=([_keep(a) for a in args], {k: _keep(v) for k, v in kw.items()}))

        def backsub(args, kw, out):
            if "acc" in ba and "sub" not in ba and bool(torch.isfinite(args[3]).all()):
                ba["sub"] = ([_keep(a) for a in args], {k: _keep(v) for k, v in kw.items()})

        def cost(args, kw, out):
            if "acc" in ba and "cost" not in ba:
                ba["cost"] = ([_keep(a) for a in args], {k: _keep(v) for k, v in kw.items()})

        self._wrap(m["fast"], "fast_score", fast)
        self._wrap(m["orb"], "orb_angle_desc", orb)
        self._wrap(match, "masked_top2", top2)
        self._wrap(match, "masked_top2_nb", top2_nb)
        self._wrap(match, "masked_top1_epi", epi)
        self._wrap(m["ba"], "ba_accumulate", acc)
        self._wrap(m["ba"], "ba_backsub", backsub)
        self._wrap(m["ba"], "ba_cost", cost)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []


def time_instances(rec: Recorder) -> Dict[str, dict]:
    """Each recorded instance timed alone, with its bound -> name -> {ms,
    bound_ms, bound_by}."""
    m = rec.mods
    out: Dict[str, dict] = {}
    for site, (args, kw) in rec.got.items():
        if site == "fast":
            fn, (b, by) = (lambda: m["fast"].fast_score(*args, **kw)), fast_bound(args[0])
        elif site == "orb":
            fn, (b, by) = (lambda: m["orb"].orb_angle_desc(*args, **kw)), orb_bound(args[2].shape[0])
        elif site == "top2_nb":
            fn = lambda: m["match"].masked_top2_nb(*args, **kw)  # noqa: E731
            isig = kw.get("col_isig2", args[15] if len(args) > 15 else None)
            b, by = top2_bound(args, isig, True)
        elif site == "top1_epi":
            fn, (b, by) = (lambda: m["match"].masked_top1_epi(*args, **kw)), epi_bound(args)
        else:
            fn = lambda: m["match"].masked_top2(*args, **kw)  # noqa: E731
            isig = kw.get("col_isig2", args[15] if len(args) > 15 else None)
            b, by = top2_bound(args, isig, bool(kw.get("chi2_gate")))
        out[site] = dict(ms=time_graph_ms(fn), bound_ms=b, bound_by=by)
    ba = rec.ba
    if "acc" in ba:
        (lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk, huber), akw = ba["acc"]
        inst = dict(posesT=posesT, slot=slot, povar=povar, wk=wk, n_pts=akw["n_pts"])
        a_args = ba["acc"][0]
        b, by = ba_bound("acc", inst)
        out["ba_acc"] = dict(ms=time_graph_ms(lambda: m["ba"].ba_accumulate(*a_args, **akw)),
                             bound_ms=b, bound_by=by)
        for site, key, kind, fn_name in (("ba_backsub", "sub", "backsub", "ba_backsub"),
                                         ("ba_cost", "cost", "cost", "ba_cost")):
            if key in ba:
                args_k, kw_k = ba[key]
                b, by = ba_bound(kind, inst)
                fn = getattr(m["ba"], fn_name)
                out[site] = dict(ms=time_graph_ms(lambda f=fn, a=args_k, k=kw_k: f(*a, **k)),
                                 bound_ms=b, bound_by=by)
    return out


def record_instances(inp, chunk: int, device) -> Dict[str, dict]:
    """An eager system over the recording's first RECORD_FRAMES frames with the
    recorder on, then each site's instance timed alone."""
    from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

    with Recorder() as rec:
        s = SlamSystem(inp.slam_cfg, vocabulary=inp.voc, chunk=chunk, device=device, graphs=False)
        for i in range(min(RECORD_FRAMES, inp.frames)):
            s.track(*inp.frame(i))
        s.results()
    torch.cuda.synchronize()
    return time_instances(rec)
