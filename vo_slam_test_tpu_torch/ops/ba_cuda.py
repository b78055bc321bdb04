"""Wrappers of the local-BA kernels (``csrc/ba.cu``).

Each wrapper launches its kernel for CUDA tensors and runs the plain version
in ``ops/ba_pallas.py`` for CPU tensors; any other device raises. One
``_build.Kernel`` per call site, each with its own launch count:

- ``KERNEL_ACC``: ``ba_accumulate`` (one LM iteration's normal equations and
  Schur reduction; two launches inside, counted once; ``ba_scratch`` makes
  the buffer its first launch hands to its second);
- ``KERNEL_COST``: ``ba_cost`` (the robust cost of the candidate step; one
  launch whose last block sums, counting the blocks on a per-device integer,
  ``cost_counter``);
- ``KERNEL_BACKSUB``: ``ba_backsub`` (the point update; it reads the window
  mask words that ``ba_accumulate`` wrote into the caller's ``ba_mask``
  buffer).

The arguments keep the JAX package's layouts (``ops/ba_pallas.py``); the five
camera scalars come as one [5] tensor ``cam5`` and the Pallas grid's static
sizes are read from the shapes. ``n_pts`` (0-d int32 on the card, default L)
is the count of live points, which the problem builder compacts first: the
kernels' cross-point sums stop there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ba_pallas

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL_ACC = _build.Kernel("ba", "ba_accumulate_launch", [_P] * 12 + [_I] * 5 + [_P] * 12)
KERNEL_COST = _build.Kernel("ba", "ba_cost_launch", [_P] * 10 + [_I] * 4 + [_P] * 4)
KERNEL_BACKSUB = _build.Kernel("ba", "ba_backsub_launch", [_P] * 6 + [_I] * 2 + [_P] * 2)

MAX_WK = 32  # the window slots fit one mask word per point
MAX_O = 16   # the observers of a point fit one group of lanes
REC = 132    # floats per (window slot, point) record of the scratch
_F32, _I32 = torch.float32, torch.int32
_COUNTERS = {}  # device -> ba_cost's arrival counter


def _check(fn: str, dev: torch.device, specs) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _n_pts(n_pts: Optional[torch.Tensor], L: int, dev) -> torch.Tensor:
    return torch.full((), L, dtype=_I32, device=dev) if n_pts is None else n_pts


def _obs_specs(posesT, X, slot, u, v, ur, isig2, act):
    O, L = slot.shape
    return [("posesT", posesT, _F32, (16, posesT.shape[1])), ("X", X, _F32, (3, L)),
            ("slot", slot, _I32, (O, L))] + [
        (n, t, _F32, (O, L)) for n, t in
        (("u", u), ("v", v), ("ur", ur), ("isig2", isig2), ("act", act))]


def ba_scratch(wk: int, L: int, device) -> Optional[torch.Tensor]:
    """The [wk, L, 132] f32 scratch of ``ba_accumulate`` on the card (one
    record per window slot and point, handed from its first launch to its
    second; never zeroed, and only the records of observing slots are
    touched; 104 MB at wk 24 and L 8192), to be made once per BA call; None
    for the CPU."""
    if torch.device(device).type == "cpu":
        return None
    return torch.empty((wk, L, REC), dtype=_F32, device=device)


def ba_mask(L: int, device) -> Optional[torch.Tensor]:
    """The [L] int32 buffer of the points' window mask words on the card
    (bit a: window slot a observes the point with a varying pose), which
    ``ba_accumulate`` writes and ``ba_backsub`` reads, to be made once per BA
    call; None for the CPU."""
    if torch.device(device).type == "cpu":
        return None
    return torch.empty((L,), dtype=_I32, device=device)


def cost_counter(device) -> torch.Tensor:
    """``ba_cost``'s arrival counter on ``device``: one int32, zeroed once at
    first use (outside a CUDA-graph capture) and back at 0 after every
    launch. All streams of the device share it, so two ``ba_cost`` calls must
    not run at once on two streams (the solver makes them in one stream)."""
    dev = torch.device(device)
    if dev not in _COUNTERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ba_cost: make the first call outside a CUDA-graph capture")
        _COUNTERS[dev] = torch.zeros((1,), dtype=_I32, device=dev)
    return _COUNTERS[dev]


def ba_accumulate(lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk: int,
                  use_huber: bool, n_pts: Optional[torch.Tensor] = None,
                  wc: Optional[torch.Tensor] = None, scratch: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None):
    """-> (Hpp [wk,36], bp [wk,6], S_red [wk6,wk6], rhs_red [wk6,1], cost
    [1,1], Hinv [9,L], bl [3,L], Wc [wk,18,L]). ``lam`` is a 0-d f32 tensor.
    On the card ``wc``, when given, is the [wk,18,L] buffer of an earlier
    call on the same problem (the kernel writes only the rows of observing
    window slots, which the problem fixes); otherwise a zeroed one is made.
    ``scratch`` is ``ba_scratch(wk, L, device)`` and ``mask`` is ``ba_mask(L,
    device)``, which receives the mask words that ``ba_backsub`` reads; each
    is made here when not given. The CPU path ignores both. Does not
    synchronize."""
    if slot.shape[0] > MAX_O:
        raise ValueError(f"ba_accumulate: O={slot.shape[0]} observers per point, at most {MAX_O}")
    if posesT.device.type == "cpu":
        return ba_pallas.ba_accumulate_plain(lam, posesT, X, slot, u, v, ur, isig2, act, povar,
                                             cam5, wk, use_huber)
    dev = posesT.device
    O, L = slot.shape
    WF = posesT.shape[1]
    if not 1 <= wk <= min(MAX_WK, WF):
        raise ValueError(f"ba_accumulate: wk={wk} must be in [1, min({MAX_WK}, WF={WF})]")
    n_pts = _n_pts(n_pts, L, dev)
    if wc is None:
        wc = torch.zeros((wk, 18, L), dtype=_F32, device=dev)
    specs = ([("lam", lam, _F32, ()), ("cam5", cam5, _F32, (5,))]
             + _obs_specs(posesT, X, slot, u, v, ur, isig2, act)
             + [("povar", povar, _F32, (O, L)), ("n_pts", n_pts, _I32, ())])
    if scratch is None:
        scratch = ba_scratch(wk, L, dev)
    if mask is None:
        mask = ba_mask(L, dev)
    _check("ba_accumulate", dev, specs + [("wc", wc, _F32, (wk, 18, L)),
                                          ("scratch", scratch, _F32, (wk, L, REC)),
                                          ("mask", mask, _I32, (L,))])
    outs = [torch.empty(s, dtype=_F32, device=dev) for s in
            ((wk, 36), (wk, 6), (wk * 6, wk * 6), (wk * 6, 1), (1, 1), (9, L), (3, L))]
    cost_pt = torch.empty((L,), dtype=_F32, device=dev)
    KERNEL_ACC(*[t.data_ptr() for _, t, _, _ in specs], WF, wk, O, L, int(use_huber),
               *[t.data_ptr() for t in outs], wc.data_ptr(), scratch.data_ptr(),
               cost_pt.data_ptr(), mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return (*outs, wc)


def ba_cost(posesT, X, slot, u, v, ur, isig2, act, cam5, use_huber: bool,
            n_pts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The robust cost alone -> [1,1], summed in ``ba_accumulate``'s order
    (bit-equal to its cost on the same inputs). Uses ``cost_counter``: one
    call at a time per device. Does not synchronize."""
    if slot.shape[0] > MAX_O:
        raise ValueError(f"ba_cost: O={slot.shape[0]} observers per point, at most {MAX_O}")
    if posesT.device.type == "cpu":
        return ba_pallas.ba_cost_plain(posesT, X, slot, u, v, ur, isig2, act, cam5, use_huber)
    dev = posesT.device
    O, L = slot.shape
    n_pts = _n_pts(n_pts, L, dev)
    specs = ([("cam5", cam5, _F32, (5,))] + _obs_specs(posesT, X, slot, u, v, ur, isig2, act)
             + [("n_pts", n_pts, _I32, ())])
    _check("ba_cost", dev, specs)
    cost = torch.empty((1, 1), dtype=_F32, device=dev)
    cost_pt = torch.empty((L,), dtype=_F32, device=dev)
    KERNEL_COST(*[t.data_ptr() for _, t, _, _ in specs], posesT.shape[1], O, L, int(use_huber),
                cost.data_ptr(), cost_pt.data_ptr(), cost_counter(dev).data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return cost


def ba_backsub(Wc, Hinv, bl, dx_pose, n_pts: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx_pt [3,L] = -Hinv (bl + Wc^T dx_pose); Wc [wk,18,L], Hinv [9,L],
    bl [3,L], dx_pose [wk,6] (the TPU kernel's 8-row MXU padding is not
    needed). On the card ``mask`` is required: the [L] int32 mask words that
    the ``ba_accumulate`` call which wrote ``Wc`` put in its ``mask`` buffer.
    The kernel reads only the ``Wc`` rows they name (the others are zero)
    while ``dx_pose`` is finite, and every row otherwise. The CPU path
    ignores it. Does not synchronize."""
    if Wc.device.type == "cpu":
        return ba_pallas.ba_backsub_plain(Wc, Hinv, bl, dx_pose)
    dev = Wc.device
    wk, _, L = Wc.shape
    if not 1 <= wk <= MAX_WK:
        raise ValueError(f"ba_backsub: wk={wk} must be in [1, {MAX_WK}]")
    if mask is None:
        raise ValueError("ba_backsub: the card needs the mask words of the ba_accumulate call "
                         "that wrote Wc (its mask buffer)")
    n_pts = _n_pts(n_pts, L, dev)
    specs = [("Wc", Wc, _F32, (wk, 18, L)), ("Hinv", Hinv, _F32, (9, L)),
             ("bl", bl, _F32, (3, L)), ("dx_pose", dx_pose, _F32, (wk, 6)),
             ("mask", mask, _I32, (L,)), ("n_pts", n_pts, _I32, ())]
    _check("ba_backsub", dev, specs)
    dx = torch.empty((3, L), dtype=_F32, device=dev)
    KERNEL_BACKSUB(*[t.data_ptr() for _, t, _, _ in specs], wk, L, dx.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    return dx
