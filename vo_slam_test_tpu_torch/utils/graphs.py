"""Device-side control flow and captured step programs: the port's
counterparts of ``lax.cond``, ``lax.while_loop``, ``lax.scan``,
``lax.fori_loop`` and ``jax.jit``.

The JAX package compiles each step into one program whose branches are
``lax.cond`` on device scalars, so a step never waits for the host. Here a
step runs in one of three modes (``use(mode)``):

- ``eager``: ``cond`` reads its predicate back and runs one branch (one host
  read). This is the default, and the CPU's mode;
- ``select``: both branches run and their outputs are merged with
  ``torch.where`` (how ``lax.cond`` acts under ``vmap``). Nothing is read
  back; on the CPU it stands in for a conditional node, and on the card it
  is the warm-up pass that runs every branch once before a capture;
- ``capture``: inside ``StepGraph``'s CUDA-graph capture, each ``cond``
  becomes two IF nodes, the second on the negated predicate; the taken side
  writes the outputs. The card's PyTorch (2.11) has no
  ``CUDAGraph.begin_capture_to_if_node``, so ``csrc/graph_if.cu`` makes the
  same CUDA calls (a conditional handle, a kernel that sets it from the
  predicate, ``cudaGraphAddNode`` and a capture of the body into the node's
  graph on a stream of its own), with the bodies' allocations routed to a
  second private pool of the capture. A loop (``while_capped``, ``scan``,
  ``fori_loop``) becomes one WHILE node whose body, one trip, is captured
  once: its carry lives in buffers the loop owns, rewritten in place by each
  trip, and the body's last kernel counts the trip and sets the node's
  handle from the loop's flag and the trip cap.

A predicate that is a Python bool branches on the host in every mode (no
read). Branch functions are pure functions of their operands and return
pytrees (tuples, lists, dicts, dataclasses, NamedTuples) of tensors with the
same structure, shapes and dtypes on both sides.

``while_capped`` is ``lax.while_loop`` with a trip cap, ``scan`` is
``lax.scan`` over a trip range with an optional early exit (``fori_loop`` the
same without per-trip inputs or outputs, ``repeat`` the same for a body
that reads no trip index); ``StepGraph`` owns a
step's static inputs and carried state, warms it up, captures it and replays
it; ``no_host_reads`` raises on every operation that reads a device value
back to the host (or could not be captured for that reason).

The process's step programs live in one table, the counterpart of
``jax.jit``'s cache: ``program(key, ...)`` returns the StepGraph of a key
(the device, the program's name, its statics and the signature of its traced
constants), building it on first use, so every caller of one static
configuration shares one warm-up and one capture; ``clear_programs()`` (the
counterpart of ``jax.clear_caches()``) drops them all. A ``Program`` is one
owner's share of such a StepGraph: its replays, warm-up and capture seconds
and launches, and the hand-over of the static buffers (``StepGraph.run``
with an owner: before a replay for an owner that is not the resident one,
the resident's tensors that are static buffers are cloned into tensors of
its own, so no owner ever sees another's state).

Spans and counters (``counting``; off by default, and then nothing of this
is captured, so a graph is node for node the one without it): ``span(name)``
around a stage of a step puts two one-thread stamp kernels of the card's
``%globaltimer`` into the capture (``csrc/graph_if.cu``), and each
conditional node gets a counter of its executions; both live in one int64
buffer per StepGraph, split between its owners as the launches are.
``cond``/``while_capped``/``scan``/``fori_loop``/``repeat`` take a ``name``
for their node; an unnamed node is labelled by its innermost span and its
ordinal there. A counted capture's copy of its outputs and new state at its
end is a ``carry`` span, as is a ``scan``'s own copying where its
``carry_span`` names one. The top-level ``program`` span also writes each
replay's stamps into a ring (``RING`` replays), which ``calibrate``/
``to_host`` put on the host's ``time.perf_counter_ns`` clock. On the CPU a
program's run (select mode, the stand-in for a replay) records the same
spans with the host's clock and counts the nodes its taken paths pass
(``Tally``). Outside a program, ``span`` records into the host ``Recorder``
that ``recording`` names (a ``SlamSystem``'s spans). Whichever path,
``span`` opens a ``torch.profiler.record_function`` of its name while a
profiler records.

Whether a value lives on the host or on the device is decided here and
nowhere else: ``fetch`` reads the values a step branches on back when eager
(one read) and leaves them on the device otherwise; ``where`` selects with a
host or a device predicate; ``scalar`` makes a count in the mode's form;
``on_device`` fills a host value on the device; ``scan`` hands a trip the
row of what ``fetch`` gave in either form.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import record_function

MODES = ("eager", "select", "capture")
_MODE = ["eager"]


@dataclasses.dataclass
class _Capture:
    """The capture under way: its device and the nesting depth of the
    conditional nodes open (each depth captures its bodies on a stream of its
    own). When counting (``counting``): the device counters of the nodes'
    executions (an IF node's runs, a WHILE node's trips),
    the kernel wrapper calls recorded in each node's own body, and a stack of
    (wrapper calls at entry, calls recorded in the inner nodes) per open
    node, the capture itself at the bottom."""

    device: torch.device
    depth: int = 0
    n_if: int = 0          # IF nodes made
    n_while: int = 0       # WHILE nodes made
    body_nodes: int = 0    # nodes of their bodies (an inner node counts as one)
    counts: Optional[torch.Tensor] = None
    nodes: list = dataclasses.field(default_factory=list)
    stack: list = dataclasses.field(default_factory=list)
    # when counting: each node's label and its body's node count, by slot
    # (slots 0..); each span's (total, count) slots and the open stamps'
    # slots, taken from the top of ``counts`` down to ``top``
    labels: list = dataclasses.field(default_factory=list)
    body_n: list = dataclasses.field(default_factory=list)
    span_slots: dict = dataclasses.field(default_factory=dict)
    top: int = 0
    names: Optional["_Labels"] = None


_CAPTURING: List[Optional[_Capture]] = [None]
_COUNTING = [False]
MAX_COUNTED_NODES = 4096  # counter slots of a counted StepGraph: nodes and spans
RING = 4096  # replays whose program-span stamps a counted StepGraph keeps
_BODY_STREAMS: dict = {}  # (device, depth) -> stream for conditional-node body captures
# device -> the stream every StepGraph captures on (one per device, as
# torch.cuda.graph's default capture stream: cuBLAS keeps a workspace for each
# stream it meets, for the process's lifetime)
_CAPTURE_STREAMS: dict = {}


@contextlib.contextmanager
def use(mode: str):
    """Run the enclosed steps in ``mode`` (one of ``MODES``)."""
    if mode not in MODES:
        raise ValueError(f"unknown graph mode {mode!r}; expected one of {MODES}")
    prev = _MODE[0]
    _MODE[0] = mode
    try:
        yield
    finally:
        _MODE[0] = prev


def mode() -> str:
    """The current mode."""
    return _MODE[0]


def traced() -> bool:
    """True in ``select`` and ``capture``: values stay on the device."""
    return _MODE[0] != "eager"


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[list, Any]:
    """(leaves, spec): tensors are leaves; tuples, lists, dicts, dataclasses
    and NamedTuples are walked; any other value is part of the spec (a
    static, compared when two trees are matched)."""
    leaves: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T",)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            return ("D", type(x), tuple(names), tuple(walk(getattr(x, n)) for n in names))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("N", type(x), tuple(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return ("L", type(x), tuple(walk(v) for v in x))
        if isinstance(x, dict):
            keys = tuple(x)
            return ("M", keys, tuple(walk(x[k]) for k in keys))
        return ("S", x)

    spec = walk(tree)
    return leaves, spec


def unflatten(spec, leaves: Sequence[torch.Tensor]):
    """The inverse of ``flatten``."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "T":
            return next(it)
        if kind == "D":
            _, cls, names, subs = s
            return cls(**{n: build(c) for n, c in zip(names, subs)})
        if kind == "N":
            return s[1](*[build(c) for c in s[2]])
        if kind == "L":
            return s[1](build(c) for c in s[2])
        if kind == "M":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        return s[1]

    return build(spec)


def _same_spec(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:  # a static without a plain ``==`` (never expected)
        return False


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor leaf."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(x) for x in leaves])


def signature(tree) -> tuple:
    """A pytree's abstract value, as ``jax.jit`` keys its cache: the
    structure with its statics, and each leaf's shape, dtype and device."""
    leaves, spec = flatten(tree)
    return spec, tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)


def _check_leaves(name: str, what: str, want: Sequence[torch.Tensor],
                  got: Sequence[torch.Tensor]) -> None:
    for i, (a, b) in enumerate(zip(want, got)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: {what} leaf {i} is {b.dtype}{tuple(b.shape)}, the "
                             f"captured one {a.dtype}{tuple(a.shape)}")


def _storage_span(t: torch.Tensor) -> Tuple[int, int]:
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def copy_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``d.copy_(s)`` for each pair, safe when a source shares memory with a
    destination (such a source is cloned before the first write)."""
    spans = [_storage_span(d) for d in dst]
    pairs = []
    for d, s in zip(dst, src):
        if s is d or (s.data_ptr() == d.data_ptr() and s.shape == d.shape
                      and s.stride() == d.stride() and s.dtype == d.dtype):
            continue
        lo, hi = _storage_span(s)
        if any(lo < b and a < hi for a, b in spans):
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


# ---------------------------------------------------------------------------
# host or device values
# ---------------------------------------------------------------------------


def fetch(*tensors):
    """The integer or bool ``tensors`` a step branches on, as the mode takes
    them: eager, Python values (a scalar per 0-d tensor, a list per 1-d one)
    from one host read; in ``select``/``capture`` mode the tensors
    themselves, nothing read. A value that is not a tensor (already on the
    host) passes through unchanged in every mode."""
    if _MODE[0] != "eager":
        return tensors if len(tensors) > 1 else tensors[0]
    dev = [t for t in tensors if isinstance(t, torch.Tensor)]
    for t in dev:
        if t.is_floating_point() or t.is_complex():
            raise TypeError(f"fetch takes integer or bool tensors, not {t.dtype}")
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in dev]).tolist() if dev else []
    out, at = [], 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        vals = flat[at:at + t.numel()]
        at += t.numel()
        if t.dtype == torch.bool:
            vals = [bool(v) for v in vals]
        out.append(vals[0] if t.dim() == 0 else vals)
    return tuple(out) if len(out) > 1 else out[0]


def where(c, a, b):
    """``a if c else b`` for a host bool ``c``; ``torch.where(c, a, b)`` for
    a device one (``jnp.where``'s counterpart for both forms)."""
    if isinstance(c, torch.Tensor):
        return torch.where(c, a, b)
    return a if c else b


def scalar(v, dtype: torch.dtype, device):
    """A count in the mode's form: the Python value when eager, a 0-d device
    tensor (filled there) in ``select``/``capture`` mode."""
    if _MODE[0] == "eager":
        return v
    return torch.full((), v, dtype=dtype, device=device)


def on_device(v, dtype: torch.dtype, device) -> torch.Tensor:
    """``v`` as a 0-d device tensor: a tensor is cast, a Python value filled
    on the device (no host copy, so no sync)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# cond / while_capped
# ---------------------------------------------------------------------------


def host_bool(pred) -> bool:
    """``pred`` as a Python bool: a host read of a tensor (eager only)."""
    if isinstance(pred, torch.Tensor):
        if traced():
            raise RuntimeError(f"host read of a predicate in {mode()} mode")
        return bool(pred)
    return bool(pred)


def cond(pred, true_fn: Callable, false_fn: Callable, operands: tuple = (),
         name: Optional[str] = None):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` (module docstring);
    ``name`` labels its nodes when counting (the taken side's node; the
    other's gets ``.else``)."""
    if not isinstance(pred, torch.Tensor):
        return true_fn(*operands) if pred else false_fn(*operands)
    m = _MODE[0]
    if m == "eager":
        return true_fn(*operands) if bool(pred) else false_fn(*operands)
    pred = pred.reshape(()).to(torch.bool)
    if m == "select":
        tally = _tally()
        label = tally.names.label(name) if tally is not None else None
        taken = tally is None or cpu_flag(pred)  # a tally runs on the CPU: read for free
        with _tally_node(tally, label, taken):
            t_leaves, t_spec = flatten(true_fn(*operands))
        with _tally_node(tally, label and label + ".else", not taken):
            f_leaves, f_spec = flatten(false_fn(*operands))
        _check_match(t_spec, f_spec, t_leaves, f_leaves)
        return unflatten(t_spec, [torch.where(pred, a, b) for a, b in zip(t_leaves, f_leaves)])
    cap = _CAPTURING[0]
    if cap is None:
        raise RuntimeError("cond in capture mode outside a StepGraph capture")
    label = cap.names.label(name) if cap.counts is not None else None
    # two IF nodes, the second on the negated predicate (torch's
    # if_else_node); the taken side's results land in buffers made inside
    # the first body
    with _if_body(cap, pred, negate=False, label=label):
        t_leaves, t_spec = flatten(true_fn(*operands))
        outs = [x.clone() for x in t_leaves]
    with _if_body(cap, pred, negate=True, label=label and label + ".else"):
        f_leaves, f_spec = flatten(false_fn(*operands))
        _check_match(t_spec, f_spec, t_leaves, f_leaves)
        copy_into(outs, f_leaves)
    return unflatten(t_spec, outs)


def _check_match(t_spec, f_spec, t_leaves, f_leaves) -> None:
    if not _same_spec(t_spec, f_spec):
        raise TypeError(f"cond: the branches return different structures:\n{t_spec}\n{f_spec}")
    for i, (a, b) in enumerate(zip(t_leaves, f_leaves)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise TypeError(f"cond: output {i} differs between branches: "
                            f"{a.dtype}{tuple(a.shape)} / {b.dtype}{tuple(b.shape)}")


def _graph_kernels() -> dict:
    """``csrc/graph_if.cu``'s functions, bound at the first capture."""
    if not _GRAPH_KERNELS:
        from ..ops import _build

        P = ctypes.c_void_p
        U = ctypes.c_ulonglong
        N = ctypes.POINTER(U)
        L = ctypes.c_longlong
        I = ctypes.c_int
        _GRAPH_KERNELS.update(
            if_begin=_build.Kernel("graph_if", "graph_if_begin", [P, P, P, ctypes.c_int]),
            if_end=_build.Kernel("graph_if", "graph_if_end", [P, N]),
            while_begin=_build.Kernel("graph_if", "graph_while_begin", [P, P, P, P, L, N]),
            while_end=_build.Kernel("graph_if", "graph_while_end", [P, U, P, P, L, N]),
            stream_create=_build.Kernel("graph_if", "graph_stream_create", [ctypes.POINTER(P)]),
            count=_build.Kernel("graph_if", "graph_if_count", [P, P, ctypes.c_int]),
            capture_nodes=_build.Kernel("graph_if", "graph_capture_nodes", [P, N]),
            span_open=_build.Kernel("graph_if", "graph_span_open", [P, P, I]),
            span_close=_build.Kernel("graph_if", "graph_span_close", [P, P, I, I, I, P, I]),
            clock_stamp=_build.Kernel("graph_if", "graph_clock_stamp", [P, P]),
            clock_step=_build.Kernel("graph_if", "graph_clock_step", [P, P, I, L]))
    return _GRAPH_KERNELS


@contextlib.contextmanager
def counting():
    """StepGraphs captured inside count their kernels' launches
    (``StepGraph.launches``) and their spans: each conditional body gets a
    one-thread kernel that counts the node's executions (a WHILE node's
    trips) on the device, each ``span`` two stamp kernels, and the capture a
    ``program`` span around it all. Host ``Recorder`` spans and a CPU
    program's ``Tally`` record only inside it. Off by default: it adds
    those kernels to the graphs (and is part of a program's key)."""
    prev = _COUNTING[0]
    _COUNTING[0] = True
    try:
        yield
    finally:
        _COUNTING[0] = prev


# ---------------------------------------------------------------------------
# spans and node labels
# ---------------------------------------------------------------------------


_NULL = contextlib.nullcontext()
_SINK: list = [None]  # where ``span`` records outside a capture: a Recorder or a Tally


def _profiled(name: str):
    """A ``record_function`` range of ``name`` while a torch profiler
    records (what ``bench.py`` reads), else nothing."""
    return record_function(name) if torch._C._autograd._profiler_enabled() else _NULL


def span(name: str):
    """A stage of a step, as a context manager (module docstring). Inside
    ``counting()``: in a capture, two stamp kernels around the enclosed work
    (the span's time and count in the StepGraph's counters); elsewhere a
    host record in the current ``recording`` sink. Outside ``counting()``
    nothing (a profiler range while a profiler records)."""
    if _COUNTING[0]:
        cap = _CAPTURING[0]
        if cap is not None:
            if cap.counts is not None:
                return _device_span(cap, name)
        elif _SINK[0] is not None:
            return _SINK[0].span(name)
    return _profiled(name)


def _named_span(name: Optional[str]):
    """``span(name)``, or nothing for None."""
    return _NULL if name is None else span(name)


def recording(sink):
    """Inside ``counting()``: the enclosed ``span``s outside a capture record
    into ``sink`` (a ``Recorder``, a ``Tally``, or None: nowhere)."""
    return _recording(sink) if _COUNTING[0] else _NULL


@contextlib.contextmanager
def _recording(sink):
    prev = _SINK[0]
    _SINK[0] = sink
    try:
        yield
    finally:
        _SINK[0] = prev


class _Labels:
    """The labels of one run's conditional nodes (``Program.node_runs``): a
    named node keeps its name, an unnamed one is ``<innermost span>#<its
    ordinal there>``, and a label met again in the run gets ``#<k>``. A
    select-mode loop runs its body once a trip: ``mark``/``rewind`` label
    every trip as the first (as a capture records the body once)."""

    def __init__(self):
        self.spans = [["program", 0]]  # [span name, nodes labelled in it]
        self.seen: dict = {}

    def label(self, name: Optional[str]) -> str:
        if name is None:
            top = self.spans[-1]
            top[1] += 1
            name = f"{top[0]}#{top[1]}"
        n = self.seen.get(name, 0) + 1
        self.seen[name] = n
        return name if n == 1 else f"{name}#{n}"

    def mark(self):
        return [c for _, c in self.spans], dict(self.seen)

    def rewind(self, mark) -> None:
        counts, seen = mark
        for sp, c in zip(self.spans, counts):
            sp[1] = c
        self.seen = dict(seen)


def _take_slot(cap: _Capture) -> int:
    """A counter slot for a span, from the top of the capture's buffer."""
    cap.top -= 1
    if cap.top < len(cap.nodes):
        raise RuntimeError(f"more than {cap.counts.numel()} node counters and span slots")
    return cap.top


@contextlib.contextmanager
def _device_span(cap: _Capture, name: str, ring: Optional[torch.Tensor] = None):
    """Stamp kernels around the enclosed capture: the open stamp into a slot
    of its own, the close adding the time and one run to the name's slots
    (and, with ``ring``, the replay's stamps into it)."""
    if name not in cap.span_slots:
        cap.span_slots[name] = (_take_slot(cap), _take_slot(cap))
    total, count = cap.span_slots[name]
    opened = _take_slot(cap)
    k = _graph_kernels()
    ptr = cap.counts.data_ptr()
    k["span_open"](torch.cuda.current_stream(cap.device).cuda_stream, ptr, opened)
    cap.names.spans.append([name, 0])
    try:
        yield
    finally:
        cap.names.spans.pop()
    k["span_close"](torch.cuda.current_stream(cap.device).cuda_stream, ptr, opened, total, count,
                    None if ring is None else ring.data_ptr(), RING)


class Tally:
    """A program's spans and node runs recorded on the host, for a run that
    is not a replay (the CPU's select mode, the stand-in for one): a span's
    host nanoseconds and runs by name, and each node's runs by label,
    counting only the paths taken (a predicate on the CPU is read for free;
    select mode also runs the sides not taken, which count nothing)."""

    def __init__(self):
        self.spans: dict = {}      # name -> [ns, runs]
        self.node_runs: dict = {}  # label -> runs
        self.names = _Labels()
        self._taken = [True]

    def run(self, fn: Callable):
        """``fn()`` as one program run: its spans and nodes recorded here,
        the whole as ``program`` -> (result, start ns, end ns)."""
        prev = _SINK[0]
        _SINK[0] = self
        self.names = _Labels()
        t0 = time.perf_counter_ns()
        try:
            out = fn()
        finally:
            _SINK[0] = prev
        t1 = time.perf_counter_ns()
        self._add("program", t1 - t0)
        return out, t0, t1

    def _add(self, name: str, ns: int) -> None:
        tot = self.spans.setdefault(name, [0, 0])
        tot[0] += ns
        tot[1] += 1

    @contextlib.contextmanager
    def span(self, name: str):
        taken = self._taken[-1]
        self.names.spans.append([name, 0])
        t0 = time.perf_counter_ns()
        try:
            with _profiled(name):
                yield
        finally:
            self.names.spans.pop()
            if taken:
                self._add(name, time.perf_counter_ns() - t0)

    @contextlib.contextmanager
    def node(self, label: str, taken: bool):
        """The enclosed work is the body of node ``label``, run when
        ``taken`` and every enclosing node ran."""
        run = self._taken[-1] and bool(taken)
        self.node_runs[label] = self.node_runs.get(label, 0) + int(run)
        self._taken.append(run)
        try:
            yield
        finally:
            self._taken.pop()


def _tally() -> Optional[Tally]:
    sink = _SINK[0]
    return sink if _COUNTING[0] and isinstance(sink, Tally) else None


def _tally_node(tally: Optional[Tally], label, taken):
    return _NULL if tally is None else tally.node(label, taken)


class Recorder:
    """Host spans (``SlamSystem``'s): [frame, name, start ns, end ns, parent
    index or -1] per span, in the order opened, on ``time.perf_counter_ns``.
    A span records only inside ``counting()`` (outside it costs one flag
    check, and a profiler range while a profiler records); ``frame``
    defaults to the enclosing span's."""

    def __init__(self):
        self.records: list = []
        self._open: list = []

    def span(self, name: str, frame: Optional[int] = None):
        if not _COUNTING[0]:
            return _profiled(name)
        return self._span(name, frame)

    def current(self) -> int:
        """The innermost open span's index (-1: none)."""
        return self._open[-1] if self._open else -1

    @contextlib.contextmanager
    def _span(self, name: str, frame: Optional[int]):
        parent = self.current()
        if frame is None:
            frame = self.records[parent][0] if parent >= 0 else -1
        rec = [frame, name, time.perf_counter_ns(), None, parent]
        self._open.append(len(self.records))
        self.records.append(rec)
        try:
            with _profiled(name):
                yield
        finally:
            rec[3] = time.perf_counter_ns()
            self._open.pop()


# ---------------------------------------------------------------------------
# one clock: the card's %globaltimer on the host's perf_counter_ns
# ---------------------------------------------------------------------------


_CLOCK: dict = {}  # device -> [(host ns, card ns, half the bracket ns)] per calibration


def calibrate(device):
    """One calibration point of the card's ``%globaltimer`` against
    ``time.perf_counter_ns``: a stamp kernel on the idle device between two
    host reads around its synchronize, the narrowest of five brackets
    -> (host ns at the bracket's middle, card ns, half the bracket: the
    error bound). None off the card. Synchronizes the device."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    k = _graph_kernels()
    buf = torch.zeros(5, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    brackets = []
    for i in range(buf.numel()):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter_ns()
        k["clock_stamp"](stream.cuda_stream, buf.data_ptr() + 8 * i)
        stream.synchronize()
        brackets.append((t0, time.perf_counter_ns()))
    card = buf.tolist()
    i = min(range(len(brackets)), key=lambda j: brackets[j][1] - brackets[j][0])
    t0, t1 = brackets[i]
    point = ((t0 + t1) // 2, card[i], (t1 - t0) / 2)
    _CLOCK.setdefault(dev, []).append(point)
    return point


def clock(device) -> Optional[dict]:
    """The card's clock on the host's, from the first and the latest
    calibration: ``offset_ns`` (card − host at the first), ``drift`` (the
    offset's change per host ns between them), ``error_ns`` (the larger
    half-bracket), ``points``. None before a calibration (the CPU's spans are
    on the host's clock already)."""
    pts = _CLOCK.get(_device(device))
    if not pts:
        return None
    (h0, g0, e0), (h1, g1, e1) = pts[0], pts[-1]
    drift = ((g1 - h1) - (g0 - h0)) / (h1 - h0) if h1 != h0 else 0.0
    return dict(offset_ns=g0 - h0, drift=drift, error_ns=max(e0, e1), at_ns=h0, points=len(pts))


def to_host(device, card_ns: int) -> float:
    """A ``%globaltimer`` stamp on the host's ``perf_counter_ns`` clock
    (``clock``); unchanged without a calibration."""
    c = clock(device)
    if c is None:
        return card_ns
    d = c["drift"]
    return (card_ns - c["offset_ns"] + d * c["at_ns"]) / (1.0 + d)


def timer_resolution(device) -> dict:
    """``%globaltimer``'s resolution on the card: one thread reads it until
    it changed 64 times (or 2^26 reads went by) -> {"step_ns": the smallest
    change, "changes", "reads"}. Synchronizes the device."""
    dev = _device(device)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    _graph_kernels()["clock_step"](torch.cuda.current_stream(dev).cuda_stream, out.data_ptr(),
                                   64, 1 << 26)
    step, changes, reads = out.tolist()
    return dict(step_ns=step, changes=changes, reads=reads)


def _wrapper_calls() -> dict:
    """Every kernel wrapper's call count (``ops._build.Kernel``), the
    conditional nodes' own helpers left out."""
    from ..ops import _build

    return {k: k.launches for k in _build.Kernel.ALL if k.source != "graph_if"}


def _minus(a: dict, b: dict) -> dict:
    return {k: v - b.get(k, 0) for k, v in a.items()}


def _add_into(into: dict, calls: dict) -> None:
    for k, v in calls.items():
        into[k] = into.get(k, 0) + v


_GRAPH_KERNELS: dict = {}  # graph_if.cu's functions (_graph_kernels)


def _body_stream(dev: torch.device, depth: int):
    key = (dev, depth)
    if key not in _BODY_STREAMS:
        out = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _graph_kernels()["stream_create"](ctypes.byref(out))
        _BODY_STREAMS[key] = torch.cuda.ExternalStream(out.value, device=dev)
    return _BODY_STREAMS[key]


@contextlib.contextmanager
def _cond_body(cap: _Capture, begin: Callable, end: Callable, label: Optional[str] = None):
    """Capture the enclosed work into the body of the conditional node that
    ``begin(parent stream, body stream)`` adds; ``end(body stream, node
    count out)`` closes it. The body is captured on a stream of its own,
    whose allocations go to the StepGraph's body pool. When counting, the
    node's counter slot is its ``label``'s."""
    dev = cap.device
    parent = torch.cuda.current_stream(dev)
    body = _body_stream(dev, cap.depth)
    begin(parent.cuda_stream, body.cuda_stream)
    cap.depth += 1
    slot = None
    if cap.counts is not None:
        slot = len(cap.nodes)
        if slot >= cap.top:
            raise RuntimeError(f"more than {cap.counts.numel()} node counters and span slots")
        cap.nodes.append({})
        cap.labels.append(label)
        cap.body_n.append(0)
        _graph_kernels()["count"](body.cuda_stream, cap.counts.data_ptr(), slot)
        cap.stack.append((_wrapper_calls(), {}))
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        if slot is not None:
            entry, inner = cap.stack.pop()
            calls = _minus(_wrapper_calls(), entry)
            cap.nodes[slot] = _minus(calls, inner)
            _add_into(cap.stack[-1][1], calls)
        cap.depth -= 1
        n = ctypes.c_ulonglong()
        end(body.cuda_stream, ctypes.byref(n))
        cap.body_nodes += n.value
        if slot is not None:
            cap.body_n[slot] = n.value


def _if_body(cap: _Capture, pred: torch.Tensor, negate: bool, label: Optional[str] = None):
    """Capture the enclosed work into an IF node on ``pred`` (negated when
    ``negate``)."""
    k = _graph_kernels()
    pred = pred.contiguous()
    cap.n_if += 1
    return _cond_body(cap, lambda s, b: k["if_begin"](s, b, pred.data_ptr(), int(negate)),
                      k["if_end"], label)


def _while_body(cap: _Capture, flag: torch.Tensor, counter: torch.Tensor, max_trips: int,
                name: Optional[str] = None):
    """Capture the enclosed work, one trip, into a WHILE node: a trip runs
    while the bool ``flag`` is set and fewer than ``max_trips`` trips ran.
    ``counter`` (int64, 0-d) holds the trip's number from 0; the body must
    leave the next trip's flag in ``flag``."""
    k = _graph_kernels()
    handle = ctypes.c_ulonglong()
    args = (flag.data_ptr(), counter.data_ptr(), int(max_trips))
    cap.n_while += 1
    label = cap.names.label(name) if cap.counts is not None else None
    return _cond_body(
        cap, lambda s, b: k["while_begin"](s, b, *args, ctypes.byref(handle)),
        lambda b, n: k["while_end"](b, handle.value, *args, n), label)


class _Trips:
    """A select-mode loop's trips on a ``Tally`` (None: nothing recorded):
    each trip is the body of the loop's node, labelled as the first."""

    def __init__(self, name: Optional[str]):
        self.tally = _tally()
        if self.tally is not None:
            self.label = self.tally.names.label(name)
            self.tally.node_runs.setdefault(self.label, 0)
            self.mark = self.tally.names.mark()

    def trip(self):
        if self.tally is None:
            return _NULL
        self.tally.names.rewind(self.mark)
        return self.tally.node(self.label, True)


def _cpu_int(t: torch.Tensor) -> int:
    """A CPU tensor's value, read under ``no_host_reads`` too (``cpu_flag``)."""
    if t.device.type != "cpu":
        raise HostReadError(f"a read of a {t.device.type} tensor inside a step")
    with torch._C.DisableTorchFunction():
        return int(t)


def while_capped(cond_fn: Callable, body_fn: Callable, state, max_iters: int, active=None,
                 name: Optional[str] = None):
    """``lax.while_loop(cond_fn, body_fn, state)`` cut at ``max_iters`` trips:
    a trip runs while the device flag ``active`` is set, and ``cond_fn`` of
    the new state clears it. ``active`` is the first test (default
    ``cond_fn(state)``); a Python bool there needs no read. Eager reads
    ``active`` once per trip and stops at the first False; ``select`` runs
    every trip and keeps the state of the active ones (on the CPU it stops
    at the first inactive trip, read for free: the trips left change
    nothing); ``capture`` records one WHILE node whose body, one trip, is
    captured once, so a trip that does not run runs nothing. ``name``
    labels its node when counting."""
    if active is None:
        active = cond_fn(state)
    m = _MODE[0]
    if m == "eager":
        for _ in range(max_iters):
            if not host_bool(active):
                break
            state = body_fn(state)
            active = cond_fn(state)
        return state
    leaves, spec = flatten(state)
    if not leaves:
        raise ValueError("while_capped: the state holds no tensor")
    dev = leaves[0].device
    if not isinstance(active, torch.Tensor):
        active = torch.full((), bool(active), dtype=torch.bool, device=dev)
    active = active.reshape(()).to(torch.bool)
    if m == "select":
        trips = _Trips(name)
        for _ in range(max_iters):
            if dev.type == "cpu" and not cpu_flag(active):
                break  # as the WHILE node stops
            with trips.trip():
                new = body_fn(state)
            n_leaves, n_spec = flatten(new)
            _check_match(spec, n_spec, leaves, n_leaves)
            leaves = [torch.where(active, a, b) for a, b in zip(n_leaves, leaves)]
            state = unflatten(spec, leaves)
            active = active & cond_fn(state)
        return state
    cap = _CAPTURING[0]
    if cap is None:
        raise RuntimeError("while_capped in capture mode outside a StepGraph capture")
    # the carried state lives in buffers owned by the loop; a trip writes
    # them in place inside the WHILE body, so a trip that does not run
    # copies nothing
    carry = [x.clone() for x in leaves]
    flag = active.clone()
    counter = torch.empty((), dtype=torch.int64, device=dev)
    with _while_body(cap, flag, counter, max_iters, name):
        new = body_fn(unflatten(spec, carry))
        n_leaves, n_spec = flatten(new)
        _check_match(spec, n_spec, carry, n_leaves)
        nxt = cond_fn(new).reshape(()).to(torch.bool)
        copy_into(carry, n_leaves)
        flag.copy_(nxt)
    return unflatten(spec, carry)


def _host_rows(a) -> bool:
    """A list of host numbers: what ``fetch`` gives for a 1-d tensor eagerly."""
    return isinstance(a, list) and all(isinstance(v, (bool, int)) for v in a)


def _trip_rows(xs, i: torch.Tensor, t: Optional[int] = None):
    """Row ``i`` (a 0-d int64 device tensor) of every leaf of ``xs``; eager
    (``t`` the trip's host number), item ``t`` of a list of host numbers in
    ``xs`` (so nothing is read)."""
    if xs is None:
        return None
    if _host_rows(xs):
        if t is None:
            raise TypeError("scan: host values in xs outside eager mode")
        return xs[t]
    if isinstance(xs, tuple) and not hasattr(xs, "_fields"):
        return tuple(_trip_rows(x, i, t) for x in xs)
    idx = i.reshape(1)
    return tree_map(lambda a: a.index_select(0, idx).squeeze(0), xs)


def _write_rows(bufs: list, i: torch.Tensor, y_leaves, keep=None) -> None:
    """Row ``i`` of each buffer := the matching leaf of ``y_leaves`` (only
    where the device bool ``keep`` holds, when given)."""
    idx = i.reshape(1)
    for b, y in zip(bufs, y_leaves):
        if keep is not None:
            y = torch.where(keep, y, b.index_select(0, idx).squeeze(0))
        b.index_copy_(0, idx, y.unsqueeze(0))


def _check_rows(ys_spec, y_spec, bufs, y_leaves) -> None:
    if not _same_spec(ys_spec, y_spec):
        raise TypeError(f"scan: the body's outputs differ in structure from ys:\n{y_spec}\n"
                        f"{ys_spec}")
    for j, (b, y) in enumerate(zip(bufs, y_leaves)):
        if b.shape[1:] != y.shape or b.dtype != y.dtype:
            raise TypeError(f"scan: output {j} is {y.dtype}{tuple(y.shape)}, its rows "
                            f"{b.dtype}{tuple(b.shape[1:])}")


def scan(body: Callable, carry, xs=None, length: Optional[int] = None, *, ys=None, start=0,
         n=None, until: Optional[Callable] = None, name: Optional[str] = None,
         carry_span: Optional[str] = None):
    """``lax.scan(body, carry, xs)`` over the trips i = start, start+1, ...:
    ``body(i, carry, x) -> (carry, y)``, with ``i`` the trip index as a 0-d
    int64 device tensor in every mode (so every mode runs the same indexing
    code) and ``x`` the rows ``i`` of ``xs`` (``index_select``; eager, a
    list of host numbers that ``fetch`` gave is indexed on the host; None
    without ``xs``). Each trip's ``y`` (a pytree of tensors, or None) is written into
    row ``i`` of [``length``, ...] buffers the loop owns (``index_copy_``),
    which start as ``ys`` (the rows of trips that do not run; default zeros)
    -> (carry, ys; None without outputs).

    ``length`` (a Python int; default the rows of ``xs``) caps the trips;
    ``start`` and ``n`` (host ints or 0-d device ints; ``n`` defaults to the
    rows from ``start`` on) give the trip range [start, start + n) within
    it; ``until(carry)``, a device bool, is the early exit, tested before
    each trip. Eager reads the range and the exit test on the host; select
    runs every trip of the range and keeps the carry and the rows of the
    trips the exit skips (a device range runs ``length`` trips on the card;
    on the CPU the range and the exit are read for free, and the loop stops
    where a WHILE node stops); capture records one WHILE node whose body,
    one trip, is captured once. ``name`` labels its node when counting.
    ``carry_span`` names a ``span`` around the loop's own copying outside
    the body: the carry's copy before the first trip, each trip's output
    rows and carry update, and the rows of the trips not run zeroed after
    the last (select mode: each trip's part)."""
    if length is None:
        if xs is None:
            raise ValueError("scan: give xs or length")
        length = flatten(xs)[0][0].shape[0]
    leaves, spec = flatten(carry)
    if not leaves:
        raise ValueError("scan: the carry holds no tensor")
    dev = leaves[0].device
    if n is None:
        n = length - start
    if isinstance(n, torch.Tensor) or isinstance(start, torch.Tensor):
        lim = torch.clamp(torch.minimum(on_device(n, torch.int64, dev),
                                        length - on_device(start, torch.int64, dev)), min=0)
    else:
        lim = max(min(n, length - start), 0)
    start_d = on_device(start, torch.int64, dev)
    bufs = ys_spec = None
    if ys is not None:
        y0, ys_spec = flatten(ys)
        bufs = [b.clone() for b in y0]

    def rows_for(y_leaves, y_spec, alloc):
        nonlocal bufs, ys_spec
        if bufs is None:
            bufs = [alloc((length,) + tuple(y.shape), y.dtype) for y in y_leaves]
            ys_spec = y_spec
        _check_rows(ys_spec, y_spec, bufs, y_leaves)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def outputs():
        return None if bufs is None else unflatten(ys_spec, bufs)

    m = _MODE[0]
    if m == "eager":
        lo, trips = fetch(start, lim)
        for t in range(trips):
            if until is not None and host_bool(until(carry)):
                break
            i = torch.full((), lo + t, dtype=torch.int64, device=dev)
            carry, y = body(i, carry, _trip_rows(xs, i, lo + t))
            y_leaves, y_spec = flatten(y)
            if y_leaves:
                rows_for(y_leaves, y_spec, zeros)
                _write_rows(bufs, i, y_leaves)
        return carry, outputs()
    if m == "select":
        if isinstance(lim, torch.Tensor) and dev.type == "cpu":
            lim = _cpu_int(lim)
        exact = not isinstance(lim, torch.Tensor)
        trips = _Trips(name)
        for t in range(lim if exact else length):
            go = None if exact else t < lim
            if until is not None:
                stop = until(carry).reshape(()).to(torch.bool)
                if dev.type == "cpu" and cpu_flag(stop):
                    break  # as the WHILE node stops
                go = ~stop if go is None else go & ~stop
            i = start_d + t if exact else torch.clamp(start_d + t, max=length - 1)
            with trips.trip():
                new, y = body(i, carry, _trip_rows(xs, i))
            with _named_span(carry_span):
                n_leaves, n_spec = flatten(new)
                _check_match(spec, n_spec, leaves, n_leaves)
                if go is not None:
                    n_leaves = [torch.where(go, a, b) for a, b in zip(n_leaves, leaves)]
                leaves, carry = n_leaves, unflatten(spec, n_leaves)
                y_leaves, y_spec = flatten(y)
                if y_leaves:
                    rows_for(y_leaves, y_spec, zeros)
                    _write_rows(bufs, i, y_leaves, go)
        return carry, outputs()
    cap = _CAPTURING[0]
    if cap is None:
        raise RuntimeError("scan in capture mode outside a StepGraph capture")
    with _named_span(carry_span):
        lim_d = on_device(lim, torch.int64, dev)
        flag = lim_d > 0
        if until is not None:
            flag = flag & ~until(carry).reshape(()).to(torch.bool)
        flag = flag.clone()
        counter = torch.empty((), dtype=torch.int64, device=dev)
        own = [x.clone() for x in leaves]
    masked = bufs is None  # rows made in the body: those of trips not run are zeroed after
    parent = torch.cuda.current_stream(dev)

    def outside(shape, dtype):
        # rows that outlive a trip: allocated on the parent stream (no kernel
        # is captured), never from the body stream's free blocks, which the
        # body's own temporaries rewrite at every trip
        with torch.cuda.stream(parent):
            return torch.empty(shape, dtype=dtype, device=dev)

    with _while_body(cap, flag, counter, length, name):
        i = start_d + counter
        new, y = body(i, unflatten(spec, own), _trip_rows(xs, i))
        with _named_span(carry_span):
            n_leaves, n_spec = flatten(new)
            _check_match(spec, n_spec, own, n_leaves)
            nxt = counter + 1 < lim_d
            if until is not None:
                nxt = nxt & ~until(new).reshape(()).to(torch.bool)
            y_leaves, y_spec = flatten(y)
            if y_leaves:
                rows_for(y_leaves, y_spec, outside)
                _write_rows(bufs, i, y_leaves)
            copy_into(own, n_leaves)
            flag.copy_(nxt)
    if masked and bufs is not None:
        # the counter holds the number of trips run
        with _named_span(carry_span):
            r = torch.arange(length, device=dev)
            ran = (r >= start_d) & (r < start_d + counter)
            bufs = [torch.where(ran.reshape((length,) + (1,) * (b.dim() - 1)), b,
                                torch.zeros((), dtype=b.dtype, device=dev)) for b in bufs]
    return unflatten(spec, own), outputs()


def fori_loop(lower, upper: int, body: Callable, carry, name: Optional[str] = None):
    """``lax.fori_loop(lower, upper, body, carry)``: ``body(i, carry) ->
    carry`` for i in [lower, upper) (``upper`` a Python int, ``lower`` a
    host or device int), through ``scan``."""
    return scan(lambda i, c, _: (body(i, c), None), carry, length=upper, start=lower,
                name=name)[0]


def repeat(n: int, body: Callable, carry, name: Optional[str] = None):
    """``lax.fori_loop(0, n, lambda _, c: body(c), carry)`` for a body that
    does not read its trip index (``n`` a Python int): eager, ``n`` calls of
    ``body`` (no trip index is made, so an eager trip launches only the
    body's own work, as the unrolled loop did); in ``select`` and
    ``capture``, one ``scan`` of ``n`` trips (one WHILE node in a capture).
    With ``n`` 0 nothing runs in any mode."""
    if n <= 0:
        return carry
    if _MODE[0] == "eager":
        for _ in range(n):
            carry = body(carry)
        return carry
    return scan(lambda i, c, _: (body(c), None), carry, length=n, name=name)[0]


# ---------------------------------------------------------------------------
# host-read guard
# ---------------------------------------------------------------------------


class HostReadError(RuntimeError):
    """An operation that reads a device value to the host ran where a step
    must not read."""


_T = torch.Tensor
_READS = {
    _T.item: "Tensor.item", _T.tolist: "Tensor.tolist", _T.__bool__: "Tensor.__bool__",
    _T.__int__: "Tensor.__int__", _T.__float__: "Tensor.__float__",
    _T.__index__: "Tensor.__index__", _T.numpy: "Tensor.numpy", _T.cpu: "Tensor.cpu",
    _T.__format__: "Tensor.__format__",
    # data-dependent output shapes: the card syncs to size the result
    torch.nonzero: "torch.nonzero", _T.nonzero: "Tensor.nonzero", torch.argwhere: "torch.argwhere",
    torch.masked_select: "torch.masked_select", _T.masked_select: "Tensor.masked_select",
    torch.unique: "torch.unique", _T.unique: "Tensor.unique",
    torch.unique_consecutive: "torch.unique_consecutive", torch.bincount: "torch.bincount",
    _T.bincount: "Tensor.bincount",
    # library solvers that check their status on the host (the _ex forms do not)
    torch.linalg.svd: "torch.linalg.svd", torch.svd: "torch.svd",
    torch.linalg.eigh: "torch.linalg.eigh", torch.linalg.eig: "torch.linalg.eig",
    torch.linalg.solve: "torch.linalg.solve", torch.linalg.inv: "torch.linalg.inv",
    torch.linalg.cholesky: "torch.linalg.cholesky", torch.linalg.lstsq: "torch.linalg.lstsq",
    torch.linalg.pinv: "torch.linalg.pinv", torch.linalg.matrix_rank: "torch.linalg.matrix_rank",
}


def _bad_index(idx) -> Optional[str]:
    items = idx if isinstance(idx, tuple) else (idx,)
    for i in items:
        if isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                return "a bool mask index (sized on the host)"
            if i.dim() == 0:
                return "a 0-d tensor index (read back as a Python int)"
    return None


class _NoHostReads(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _READS.get(func)
        if name is not None:
            raise HostReadError(f"{name}: a host read inside a step")
        if func is torch.where and len(args) + len(kwargs) == 1:
            raise HostReadError("torch.where(cond): a host read inside a step (nonzero)")
        if func in (_T.__getitem__, _T.__setitem__) and len(args) > 1:
            why = _bad_index(args[1])
            if why:
                raise HostReadError(f"Tensor.{func.__name__} with {why}: a host read inside a step")
        return func(*args, **kwargs)


def cpu_flag(t: torch.Tensor) -> bool:
    """A CPU tensor's truth value, read under ``no_host_reads`` too: for the
    plain versions of the kernels, which run only on CPU tensors (a CPU read
    synchronizes nothing and no capture holds it), to stop a loop early; a
    tensor on another device raises ``HostReadError``."""
    if t.device.type != "cpu":
        raise HostReadError(f"cpu_flag of a {t.device.type} tensor: a host read inside a step")
    with torch._C.DisableTorchFunction():
        return bool(t)


@contextlib.contextmanager
def no_host_reads():
    """Raise ``HostReadError`` on any operation that reads a device value
    back to the host: ``item``, ``tolist``, ``bool``/``int``/``float``/
    ``index`` of a tensor (``if t:`` among them), ``numpy``, ``cpu``,
    formatting, operations whose output size depends on the data, indexing
    with a bool mask or a 0-d tensor, and the library solvers that check
    their status on the host."""
    with _NoHostReads():
        yield


# ---------------------------------------------------------------------------
# StepGraph
# ---------------------------------------------------------------------------


class StepGraph:
    """A step ``fn(inputs, state) -> (state, outputs)`` as a captured CUDA
    graph (the counterpart of ``jax.jit`` with the state donated).

    On the card the first call is the warm-up: ``fn`` runs in ``select`` mode
    under ``no_host_reads``, so every branch of every ``cond`` builds its
    kernels, library handles and cached tables once, and its result is the
    step's (select equals eager). The second call copies
    its inputs and state into static buffers and captures ``fn`` in
    ``capture`` mode into a private memory pool, with the new state copied
    back into the static state at the end; that call and every later one
    then replays the graph. ``run`` returns the static state (rewritten by the
    next replay: clone what must outlive it) and the outputs, which are
    cloned after each replay. A capture failure raises; nothing falls back
    to eager.

    The state's non-tensor values are statics: a step whose output state
    changes one, or a call whose inputs or state differ in one, in structure
    or in a leaf's shape or dtype from the captured ones, raises. On the CPU
    every call runs the warm-up form (``select`` under ``no_host_reads``),
    the stand-in for a replay.

    Owners (``run(..., owner=)``, a ``Program``): the resident owner is the
    one whose state the static buffers hold. Before a replay for another
    owner, the resident's tensors that are static state buffers are cloned
    on the device into tensors of its own (``Program.evict``; no host read),
    then the newcomer's inputs and state are loaded. An input leaf that is
    the very tensor the resident owner loaded last, unchanged since (its
    version counter; so an input must not be a buffer that a graph replay
    rewrites, since a replay bumps no counter), is not copied again.
    ``replays``, ``warm_s``, ``capture_s`` and ``launches()`` are the totals;
    each owner keeps its share (``Program``).

    When the StepGraph is collected, its graph is reset and both private
    pools are released (the conditional bodies' pool is opened here, so the
    graph's own ``reset`` does not release it); ``torch.cuda.empty_cache`` then
    returns their memory."""

    def __init__(self, fn: Callable, device, name: str = "step"):
        self.fn = fn
        self.device = _device(device)
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._release: Optional[weakref.finalize] = None
        self.warmed = False
        self.replays = 0
        self.hits = 0  # owners that found it built (``Program.step``)
        self._in = self._state = self._outs = None
        self._in_spec = self._state_spec = self._out_spec = None
        self._pool = self._body_pool = None
        # counted captures (``counting``): the wrapper calls recorded while
        # capturing (not launches), those outside every conditional node, those in each
        # node's own body, and the nodes' execution counters
        self.capture_calls: dict = {}
        self._top_calls: dict = {}
        self._node_calls: Optional[list] = None
        self._counts: Optional[torch.Tensor] = None
        # and its spans: each node's label and body node count, each span's
        # (total, count) slots, the top level's nodes, and the ring of each
        # replay's program-span stamps (entry = the replay's number mod RING)
        self._labels: list = []
        self._body_n: list = []
        self._span_slots: dict = {}
        self.n_top = 0
        self._ring: Optional[torch.Tensor] = None
        # the capture's size and cost: graph nodes (the top level plus every
        # conditional body's, each captured once), IF and WHILE nodes, and
        # the capture call's host wall seconds; the warm-up call's host wall
        # seconds
        self.n_nodes = self.n_if = self.n_while = 0
        self.capture_s = self.warm_s = 0.0
        # owners: the resident (a weak reference), the (weak reference,
        # version) of each input leaf it loaded last, each owner's replays and
        # its node executions settled on the device when it left, and the
        # counters when the resident took over
        self._resident: Optional[weakref.ref] = None
        self._loaded: list = []
        self._owner_replays = weakref.WeakKeyDictionary()
        self._owner_runs = weakref.WeakKeyDictionary()
        self._mark: Optional[torch.Tensor] = None

    def launches(self, owner: Optional["Program"] = None) -> dict:
        """Launches of each kernel wrapper (``ops._build.Kernel`` -> count)
        by this graph's replays so far (those for ``owner`` when given),
        counted on the device: a call recorded
        outside every conditional node once per replay, one recorded in a
        node's own body (not an inner node's) once per execution of the node
        (a WHILE node's trip). Needs a
        capture made inside ``counting()``; reads the counters back (one host
        read). Launches made through the wrappers (the warm-up) are theirs."""
        if self._node_calls is None:
            raise RuntimeError(f"{self.name}: not captured inside graphs.counting()")
        runs, replays = self._runs(owner)
        n = len(self._node_calls)
        per_node = runs[:n].tolist() if n and runs is not None else [0] * n
        out = {k: v * replays for k, v in self._top_calls.items()}
        for calls, r in zip(self._node_calls, per_node):
            _add_into(out, {k: v * r for k, v in calls.items()})
        return out

    def _runs(self, owner: Optional["Program"]) -> Tuple[Optional[torch.Tensor], int]:
        """The counters of ``owner``'s replays (all replays without one): a
        device tensor (None before any), and the replays."""
        if owner is None:
            return self._counts, self.replays
        runs, replays = self._owner_runs.get(owner), self._owner_replays.get(owner, 0)
        if self._resident_owner() is owner:
            live = self._counts - self._mark
            runs = live if runs is None else runs + live
        return runs, replays

    def counters(self, owner: Optional["Program"] = None) -> Optional[dict]:
        """What a counted capture's replays for ``owner`` (all without one)
        ran, in one host read: ``spans`` {name: (device ns, runs)},
        ``node_runs`` {label: executions}, ``graph_nodes`` (the graph nodes
        executed: the top level's per replay, each body's per execution of
        its node). None without a counted capture."""
        if self._node_calls is None:
            return None
        runs, replays = self._runs(owner)
        runs = runs.tolist() if runs is not None else [0] * self._counts.numel()
        nodes = runs[:len(self._labels)]
        return dict(
            spans={k: (runs[t], runs[c]) for k, (t, c) in self._span_slots.items()},
            node_runs=dict(zip(self._labels, nodes)),
            graph_nodes=self.n_top * replays + sum(b * r for b, r in zip(self._body_n, nodes)))

    def _select(self, inputs, state):
        with use("select"), no_host_reads():
            return self.fn(inputs, state)

    def run(self, inputs, state, owner: Optional["Program"] = None):
        _release_deferred()
        if self.device.type != "cuda" or not self.warmed:
            first, self.warmed = not self.warmed, True
            t0 = time.perf_counter()
            if self.device.type != "cuda" and owner is not None and _COUNTING[0]:
                # the CPU's stand-in for a replay: its spans and nodes on the host
                out, a, b = owner.tally.run(lambda: self._select(inputs, state))
                owner.replay_log.append((None, None, a, b, a, b))
            else:
                with recording(None):  # a warm-up on the card records nothing
                    out = self._select(inputs, state)
            if first:
                self.warm_s = time.perf_counter() - t0
                if owner is not None:
                    owner.warm_s = self.warm_s
            return out
        if self.graph is None:
            self._capture(inputs, state)
            self._resident = None if owner is None else weakref.ref(owner)
            self._remember(owner, inputs)
            if self._counts is not None:
                self._mark = torch.zeros_like(self._counts)
            if owner is not None:
                owner.capture_s, owner.capture_calls = self.capture_s, self.capture_calls
        else:
            self._load(inputs, state, owner)
        if self._ring is not None and owner is not None:
            # a counted replay: the host's clock at the launch call and its
            # return, beside the replay's number (its ring entry)
            t0 = time.perf_counter_ns()
            self.graph.replay()
            owner.replay_log.append((weakref.ref(self), self.replays, t0, time.perf_counter_ns(),
                                     None, None))
        else:
            self.graph.replay()
        self.replays += 1
        if owner is not None:
            owner.replays += 1
            self._owner_replays[owner] = self._owner_replays.get(owner, 0) + 1
        return (unflatten(self._state_spec, self._state),
                unflatten(self._out_spec, [x.clone() for x in self._outs]))

    def _resident_owner(self) -> Optional["Program"]:
        return None if self._resident is None else self._resident()

    def _remember(self, owner, inputs) -> None:
        """The input leaves ``owner`` just loaded (none for an anonymous
        caller: its inputs are copied at every replay)."""
        self._loaded = ([] if owner is None else
                        [(weakref.ref(x), x._version) for x in flatten(inputs)[0]])

    def _hand_over(self, prev: Optional["Program"], new: Optional["Program"]) -> None:
        """The static buffers pass from ``prev`` to ``new``: ``prev``'s
        tensors among them are cloned into its own, and its node executions
        so far are settled to it on the device."""
        if prev is new:
            return
        if prev is not None:
            prev.evict(self)
        if self._counts is not None:
            if prev is not None:
                ran = self._counts - self._mark
                had = self._owner_runs.get(prev)
                self._owner_runs[prev] = ran if had is None else had + ran
            self._mark = self._counts.clone()
        self._resident = None if new is None else weakref.ref(new)

    def _load(self, inputs, state, owner: Optional["Program"] = None) -> None:
        in_leaves, in_spec = flatten(inputs)
        st_leaves, st_spec = flatten(state)
        if not _same_spec(in_spec, self._in_spec):
            raise ValueError(f"{self.name}: inputs differ in structure from the captured ones")
        if not _same_spec(st_spec, self._state_spec):
            raise ValueError(f"{self.name}: the state differs in a static value or in structure "
                             f"from the captured one")
        prev = self._resident_owner()
        if owner is None or prev is not owner:
            _check_leaves(self.name, "input", self._in, in_leaves)
            _check_leaves(self.name, "state", self._state, st_leaves)
            self._hand_over(prev, owner)
            dst, src = self._in, in_leaves
        else:
            moved = [i for i, (x, (ref, ver)) in enumerate(zip(in_leaves, self._loaded))
                     if ref() is not x or x._version != ver]
            dst, src = [self._in[i] for i in moved], [in_leaves[i] for i in moved]
        copy_into(dst, src)
        copy_into(self._state, st_leaves)
        self._remember(owner, inputs)

    def _capture(self, inputs, state) -> None:
        t0 = time.perf_counter()
        in_leaves, self._in_spec = flatten(inputs)
        st_leaves, self._state_spec = flatten(state)
        self._in = [x.clone() for x in in_leaves]
        self._state = [x.clone() for x in st_leaves]
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        self._pool = torch.cuda.graph_pool_handle()
        self._body_pool = torch.cuda.graph_pool_handle()
        # registered before the capture, so a failed capture releases too
        self._release = weakref.finalize(self, _release_graph, graph, dev.index, self._body_pool)
        self._release.atexit = False  # the CUDA context may be gone at exit
        if dev not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side = _CAPTURE_STREAMS[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        cap = _Capture(dev)
        ring = None
        if _COUNTING[0]:
            cap.counts = torch.zeros(MAX_COUNTED_NODES, dtype=torch.int64, device=dev)
            cap.top, cap.names = MAX_COUNTED_NODES, _Labels()
            cap.stack.append((_wrapper_calls(), {}))
            ring = torch.zeros(2 * RING, dtype=torch.int64, device=dev)
        _CAPTURING[0] = cap
        try:
            # capture_begin/end rather than torch.cuda.graph, whose entry
            # synchronizes the device: the capture makes no host sync
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool)
                # the conditional bodies are captured on streams of their own: their
                # allocations go to a second private pool (the allocator
                # records one pool per capture, and the first filter that
                # takes a stream wins: the capture's own stream stays in the
                # first), released with the graph (_release_graph)
                torch._C._cuda_beginAllocateToPool(dev.index, self._body_pool)
                try:
                    with use("capture"), no_host_reads(), (
                            _NULL if ring is None else _device_span(cap, "program", ring)):
                        new_state, outs = self.fn(unflatten(self._in_spec, self._in),
                                                  unflatten(self._state_spec, self._state))
                        n_leaves, n_spec = flatten(new_state)
                        if not _same_spec(n_spec, self._state_spec):
                            raise ValueError(f"{self.name}: the step changes a static of its "
                                             f"state (a host value a graph would freeze)")
                        o_leaves, self._out_spec = flatten(outs)
                        # outputs first: the state copy may rewrite what they alias
                        with span("carry"):
                            self._outs = [x.clone() for x in o_leaves]
                            copy_into(self._state, n_leaves)
                    top = ctypes.c_ulonglong()
                    _graph_kernels()["capture_nodes"](side.cuda_stream, ctypes.byref(top))
                    self.n_top = top.value
                    self.n_nodes = top.value + cap.body_nodes
                    self.n_if, self.n_while = cap.n_if, cap.n_while
                finally:
                    torch._C._cuda_endAllocateToPool(dev.index, self._body_pool)
                    graph.capture_end()
        finally:
            _CAPTURING[0] = None
        _release_deferred()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        if cap.counts is not None:
            entry, inner = cap.stack.pop()
            self.capture_calls = _minus(_wrapper_calls(), entry)
            self._top_calls = _minus(self.capture_calls, inner)
            self._node_calls, self._counts = cap.nodes, cap.counts
            self._labels, self._body_n, self._span_slots = cap.labels, cap.body_n, cap.span_slots
            self._ring = ring
            calibrate(dev)  # the clock's first point, at the counted capture


_DEFERRED: list = []  # releases that fell inside a capture


def _release_graph(graph: torch.cuda.CUDAGraph, device_index: int, body_pool) -> None:
    """Free a StepGraph's graph and its pools: ``reset`` releases the
    capture's pool, ``_cuda_releasePool`` the conditional bodies' pool that
    ``_cuda_beginAllocateToPool`` opened. The collector may run this in the
    middle of another capture, where destroying a graph invalidates that
    capture: there it is deferred to the capture's end (or the next
    ``StepGraph.run``)."""
    if _CAPTURING[0] is not None or torch.cuda.is_current_stream_capturing():
        _DEFERRED.append((graph, device_index, body_pool))
        return
    graph.reset()
    torch._C._cuda_releasePool(device_index, body_pool)


def _release_deferred() -> None:
    while _DEFERRED:
        _release_graph(*_DEFERRED.pop())


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# the process's programs (jax.jit's cache)
# ---------------------------------------------------------------------------


_PROGRAMS: dict = {}  # key -> StepGraph


def program(key: tuple, fn: Callable, device, name: str = "step") -> StepGraph:
    """The process's StepGraph for ``key`` (hashable: the device, the
    program's name, its statics and its traced constants' ``signature``),
    built from ``fn`` on first use; every later caller of the key gets the
    same one, warmed up and captured once."""
    sg = _PROGRAMS.get(key)
    if sg is None:
        sg = _PROGRAMS[key] = StepGraph(fn, device, name)
    return sg


def programs() -> list:
    """(key, StepGraph) for every program of the table."""
    return list(_PROGRAMS.items())


def clear_programs() -> None:
    """Drop every program of the table (``jax.clear_caches``): a program
    that no caller holds is collected, which releases its graph and both
    pools (``torch.cuda.empty_cache`` then returns their memory). An owner's
    next run builds, warms up and captures its program again; the state it
    holds is its own tensors."""
    _PROGRAMS.clear()


class Program:
    """One owner's share of the process's StepGraph for a key
    (``program``): ``run`` looks the StepGraph up (the key also holds
    whether ``counting()`` is on), building it on first use, and runs it as
    this owner. ``replays``, ``warm_s``, ``capture_s``, ``capture_calls``,
    ``launches()``, ``spans()``, ``node_runs()``, ``graph_nodes_run()`` and
    ``replay_log`` / ``replay_times()`` are this owner's: a program found
    built costs it no warm-up and no capture (both 0). ``graph``, ``n_nodes``, ``n_if``,
    ``n_while`` and ``hits`` are those of the StepGraph it last ran (else
    the table's entry for its key); ``step().warmed`` tells whether the
    next ``run`` warms the program up. ``owner`` (held weakly) and
    ``fields``: the owner's attributes that may hold the program's static
    state buffers; ``evict`` clones those into tensors of the owner's own
    when another owner's replay takes the buffers over. No StepGraph is held
    here, so ``clear_programs`` releases them while owners live."""

    def __init__(self, name: str, key: tuple, fn: Callable, device, owner, fields: Sequence[str]):
        self.name = name
        self.device = _device(device)
        self.key = (self.device, name) + tuple(key)
        self.fn = fn
        self._owner = weakref.ref(owner)
        self._fields = tuple(fields)
        self.replays = 0
        self.warm_s = self.capture_s = 0.0
        self.capture_calls: dict = {}
        self._bound: Optional[weakref.ref] = None
        # inside counting(): the CPU's runs recorded on the host, and per run
        # (StepGraph or None, replay number or None, host ns at the launch
        # call, at its return, the program span's open and close: host ns on
        # the CPU, None on the card until read from the ring)
        self.tally = Tally()
        self.replay_log: list = []

    def step(self) -> StepGraph:
        """The process's StepGraph for this key now (built on first use)."""
        key = self.key + (_COUNTING[0],)
        built = key not in _PROGRAMS
        sg = program(key, self.fn, self.device, self.name)
        if self._bound is None or self._bound() is not sg:
            self._bound = weakref.ref(sg)
            if not built:
                sg.hits += 1
        return sg

    def run(self, inputs, state):
        return self.step().run(inputs, state, owner=self)

    @property
    def last(self) -> Optional[StepGraph]:
        """The StepGraph this owner last ran (None before its first run, or
        once the table dropped it and it was collected)."""
        return None if self._bound is None else self._bound()

    def _current(self) -> Optional[StepGraph]:
        sg = self.last
        return sg if sg is not None else _PROGRAMS.get(self.key + (_COUNTING[0],))

    def _get(self, attr: str, default):
        sg = self._current()
        return default if sg is None else getattr(sg, attr)

    graph = property(lambda self: self._get("graph", None))
    n_nodes = property(lambda self: self._get("n_nodes", 0))
    n_if = property(lambda self: self._get("n_if", 0))
    n_while = property(lambda self: self._get("n_while", 0))
    hits = property(lambda self: self._get("hits", 0))

    def launches(self) -> dict:
        """This owner's launches of each kernel wrapper by its replays of the
        StepGraph it last ran (``StepGraph.launches``)."""
        sg = self.last
        if sg is None:
            raise RuntimeError(f"{self.name}: no program run")
        return sg.launches(self)

    def _counters(self) -> Optional[dict]:
        sg = self.last
        return None if sg is None else sg.counters(self)

    def spans(self) -> dict:
        """This owner's spans of the program, {name: (ns, runs)}, in one
        host read: device ns from a counted capture's replays (``program``
        the whole replay, first node to last), host ns from the CPU's runs
        (``Tally``); empty outside ``counting()``."""
        out = {k: tuple(v) for k, v in self.tally.spans.items()}
        got = self._counters()
        if got is not None:
            for k, (ns, n) in got["spans"].items():
                a, b = out.get(k, (0, 0))
                out[k] = (a + ns, b + n)
        return out

    def node_runs(self) -> dict:
        """This owner's executions of each conditional node, {label: runs}
        (a WHILE node's trips; ``cond``'s untaken side is ``<label>.else``),
        counted on the device by a counted capture's replays, or on the host
        along the taken paths of the CPU's runs."""
        got = self._counters()
        return dict(self.tally.node_runs) if got is None else got["node_runs"]

    def graph_nodes_run(self) -> int:
        """The graph nodes this owner's counted replays executed (0 without
        a counted capture: the CPU runs no graph)."""
        got = self._counters()
        return 0 if got is None else got["graph_nodes"]

    def replay_times(self) -> list:
        """Per run of ``replay_log``: (host ns at the launch call, at its
        return, the program span's first stamp, its last) on the host's
        clock (``to_host``), in one read of the ring; None for a replay whose
        ring entry was overwritten or whose StepGraph is gone."""
        rings: dict = {}
        out = []
        for ref, k, call, ret, opened, closed in self.replay_log:
            if ref is not None:
                sg = ref()
                if sg is None or sg._ring is None or sg.replays - k > RING:
                    out.append(None)
                    continue
                if sg not in rings:
                    rings[sg] = sg._ring.tolist()
                r = 2 * (k % RING)
                opened, closed = (to_host(self.device, v) for v in rings[sg][r:r + 2])
            out.append((call, ret, opened, closed))
        return out

    def evict(self, sg: StepGraph) -> None:
        """Clone the owner's tensors that are ``sg``'s static state buffers
        into tensors of its own (device copies, no host read)."""
        owner = self._owner()
        if owner is None:
            return
        mine = {id(x) for x in sg._state}
        for f in self._fields:
            leaves, spec = flatten(getattr(owner, f))
            if any(id(x) in mine for x in leaves):
                setattr(owner, f, unflatten(spec, [x.clone() if id(x) in mine else x
                                                   for x in leaves]))
