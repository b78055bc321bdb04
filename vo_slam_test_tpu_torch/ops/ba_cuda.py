"""Wrappers of the local-BA kernels (``csrc/ba.cu``).

Each wrapper launches its kernel for CUDA tensors and runs the plain version
in ``ops/ba_pallas.py`` for CPU tensors; any other device raises. One
``_build.Kernel`` per call site, each with its own launch count:

- ``KERNEL_ACC``: ``ba_accumulate`` (one LM iteration's normal equations and
  Schur reduction; two launches inside, counted once);
- ``KERNEL_COST``: ``ba_cost`` (the robust cost of the candidate step);
- ``KERNEL_BACKSUB``: ``ba_backsub`` (the point update).

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
KERNEL_ACC = _build.Kernel("ba", "ba_accumulate_launch", [_P] * 12 + [_I] * 5 + [_P] * 11)
KERNEL_COST = _build.Kernel("ba", "ba_cost_launch", [_P] * 10 + [_I] * 4 + [_P] * 3)
KERNEL_BACKSUB = _build.Kernel("ba", "ba_backsub_launch", [_P] * 5 + [_I] * 2 + [_P] * 2)

MAX_WK = 32  # the window slots fit one mask word per point
_F32, _I32 = torch.float32, torch.int32


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


def ba_accumulate(lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5, wk: int,
                  use_huber: bool, n_pts: Optional[torch.Tensor] = None,
                  wc: Optional[torch.Tensor] = None):
    """-> (Hpp [wk,36], bp [wk,6], S_red [wk6,wk6], rhs_red [wk6,1], cost
    [1,1], Hinv [9,L], bl [3,L], Wc [wk,18,L]). ``lam`` is a 0-d f32 tensor.
    On the card ``wc``, when given, is the [wk,18,L] buffer of an earlier
    call on the same problem (the kernel writes only the rows of observing
    window slots, which the problem fixes); otherwise a zeroed one is made.
    Does not synchronize."""
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
    _check("ba_accumulate", dev, specs + [("wc", wc, _F32, (wk, 18, L))])
    outs = [torch.empty(s, dtype=_F32, device=dev) for s in
            ((wk, 36), (wk, 6), (wk * 6, wk * 6), (wk * 6, 1), (1, 1), (9, L), (3, L))]
    cost_pt = torch.empty((L,), dtype=_F32, device=dev)
    mask = torch.empty((L,), dtype=_I32, device=dev)
    KERNEL_ACC(*[t.data_ptr() for _, t, _, _ in specs], WF, wk, O, L, int(use_huber),
               *[t.data_ptr() for t in outs], wc.data_ptr(), cost_pt.data_ptr(),
               mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return (*outs, wc)


def ba_cost(posesT, X, slot, u, v, ur, isig2, act, cam5, use_huber: bool,
            n_pts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The robust cost alone -> [1,1], summed in ``ba_accumulate``'s order.
    Does not synchronize."""
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
                cost.data_ptr(), cost_pt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return cost


def ba_backsub(Wc, Hinv, bl, dx_pose, n_pts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx_pt [3,L] = -Hinv (bl + Wc^T dx_pose); Wc [wk,18,L], Hinv [9,L],
    bl [3,L], dx_pose [wk,6] (the TPU kernel's 8-row MXU padding is not
    needed). Does not synchronize."""
    if Wc.device.type == "cpu":
        return ba_pallas.ba_backsub_plain(Wc, Hinv, bl, dx_pose)
    dev = Wc.device
    wk, _, L = Wc.shape
    if not 1 <= wk <= MAX_WK:
        raise ValueError(f"ba_backsub: wk={wk} must be in [1, {MAX_WK}]")
    n_pts = _n_pts(n_pts, L, dev)
    specs = [("Wc", Wc, _F32, (wk, 18, L)), ("Hinv", Hinv, _F32, (9, L)),
             ("bl", bl, _F32, (3, L)), ("dx_pose", dx_pose, _F32, (wk, 6)),
             ("n_pts", n_pts, _I32, ())]
    _check("ba_backsub", dev, specs)
    dx = torch.empty((3, L), dtype=_F32, device=dev)
    KERNEL_BACKSUB(*[t.data_ptr() for _, t, _, _ in specs], wk, L, dx.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    return dx
