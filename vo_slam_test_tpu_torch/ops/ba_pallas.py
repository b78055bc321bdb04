"""Local-BA Levenberg-Marquardt iteration: the plain versions of the CUDA
kernels in ``csrc/ba.cu`` (see ``ops/ba_cuda.py``).

Same path and role as ``vo_slam_test_tpu/ops/ba_pallas.py`` and the same
layout contract (all f32 unless noted, the point axis L last):

  posesT   [16, WF]    poses.reshape(WF,16).T (row-major 4x4 rows)
  X        [3, L]      point coordinates
  slot     [O, L] i32  observer slot into kf_ids (-1 invalid)
  u, v     [O, L]      observed pixels
  ur       [O, L]      observed right coordinate (-1 mono)
  isig2    [O, L]      1/sigma^2 per observation
  act      [O, L]      1.0 where the observation participates
  povar    [O, L]      1.0 where the observer pose is a variable (slot<wk)
  cam5     [5]         fx, fy, cx, cy, bf
Outputs of ``ba_accumulate_plain``:
  Hpp [wk, 36], bp [wk, 6], S_red [wk*6, wk*6], rhs_red [wk*6, 1],
  cost [1, 1], Hinv [9, L] (damped-inverse point blocks), bl [3, L],
  Wc [wk, 18, L] (pose-point cross blocks)

The element-wise math is the JAX package's CPU path (``_lm_pass_ol`` and
``_jacobians_ol`` in ``solvers/local_ba.py``: weighted residual ``e*isig``,
Huber on its norm, Jacobians scaled by ``isig``), gathered per observation
slot instead of contracted with a one-hot; the damped 3x3 inverse is the TPU
kernel's closed form on the symmetric upper triangle (``_make_acc_kernel``).
An observation with slot -1 contributes nothing.
"""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = math.sqrt(CHI2_MONO)
DELTA_STEREO = math.sqrt(CHI2_STEREO)


def observations(posesT, X, slot, u, v, ur, cam5):
    """Per observation: the camera-frame point, 1/z, the residual and the
    observer's rotation. -> (pc [3,O,L], invz [O,L], e [3,O,L] (row 3 zero
    for mono), stereo [O,L], R [3,3,O,L]). A slot of -1 takes an all-zero
    pose (the one-hot of the JAX layout selects nothing)."""
    WF = posesT.shape[1]
    fx, fy, cx, cy, bf = cam5.unbind(0)
    ext = torch.cat([posesT, posesT.new_zeros((16, 1))], 1)
    Tm = ext[:, torch.where(slot >= 0, slot, WF).long()].reshape(4, 4, *slot.shape)
    R, t = Tm[:3, :3], Tm[:3, 3]                                     # slices: no host copy
    pc = R[:, 0] * X[0] + R[:, 1] * X[1] + R[:, 2] * X[2] + t        # [3,O,L]
    z = pc[2]
    invz = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    uu = fx * pc[0] * invz + cx
    vv = fy * pc[1] * invz + cy
    stereo = ur >= 0
    e = torch.stack([uu - u, vv - v, torch.where(stereo, (uu - bf * invz) - ur, 0.0)])
    return pc, invz, e, stereo, R


def robust(ew, stereo, use_huber: bool):
    """Weighted residual [3,O,L] -> (rho, Huber weight), each [O,L]."""
    s2 = torch.sum(ew * ew, 0)
    if not use_huber:
        return s2, torch.ones_like(s2)
    delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO)
    s = torch.sqrt(s2 + 1e-12)
    rho = torch.where(s <= delta, s2, 2 * delta * s - delta * delta)
    return rho, torch.minimum(torch.ones_like(s), delta / s)


def inv3x3_sym(hll, lam):
    """Damped closed-form inverse of the symmetric point blocks: ``hll`` the
    six upper entries (00, 01, 02, 11, 12, 22), each [L] -> [9, L]."""
    a = hll[0] + lam + 1e-8
    b_, c_ = hll[1], hll[2]
    e_ = hll[3] + lam + 1e-8
    f_ = hll[4]
    i_ = hll[5] + lam + 1e-8
    A = e_ * i_ - f_ * f_
    B = -(b_ * i_ - f_ * c_)
    C3 = b_ * f_ - e_ * c_
    det = a * A + b_ * B + c_ * C3
    idet = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    return torch.stack([
        A * idet, B * idet, C3 * idet,
        B * idet, (a * i_ - c_ * c_) * idet, -(a * f_ - c_ * b_) * idet,
        C3 * idet, -(a * f_ - b_ * c_) * idet, (a * e_ - b_ * b_) * idet,
    ])


def ba_accumulate_plain(lam, posesT, X, slot, u, v, ur, isig2, act, povar, cam5,
                        wk: int, use_huber: bool):
    """One LM iteration's normal-equation build + Schur reduction -> (Hpp,
    bp, S_red, rhs_red, cost, Hinv, bl, Wc), shapes as in the module doc."""
    O, L = slot.shape
    fx, fy, bf = cam5[0], cam5[1], cam5[4]
    pc, invz, e, stereo, R = observations(posesT, X, slot, u, v, ur, cam5)
    inv_sig = torch.sqrt(isig2)
    ew = e * inv_sig[None]
    rho, wrob = robust(ew, stereo, use_huber)
    act = torch.where(slot >= 0, act, 0.0)
    w = act * wrob
    cost = torch.sum(torch.where(act > 0, rho, 0.0)).reshape(1, 1)

    x, y, z = pc[0], pc[1], pc[2]
    invz2 = invz * invz
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    du = torch.stack([fx * invz, zero, -fx * x * invz2])
    dv = torch.stack([zero, fy * invz, -fy * y * invz2])
    dur = du + torch.stack([zero, zero, bf * invz2])
    dproj = torch.stack([du, dv, torch.where(stereo[None], dur, 0.0)])   # [r,b,O,L]
    dpc = torch.stack([torch.stack([one, zero, zero, zero, z, -y]),
                       torch.stack([zero, one, zero, -z, zero, x]),
                       torch.stack([zero, zero, one, y, -x, zero])])       # [b,c,O,L]
    Jp = torch.einsum("rbol,bcol->rcol", dproj, dpc) * inv_sig
    Jl = torch.einsum("rbol,bjol->rjol", dproj, R) * inv_sig

    Hll = torch.einsum("riol,rjol,ol->ijl", Jl, Jl, w)
    bl = torch.einsum("riol,rol,ol->il", Jl, ew, w)
    Jpw = Jp * w[None, None]
    ohw = (slot[None] == torch.arange(wk, device=slot.device)[:, None, None]) * povar[None]
    oh2 = ohw.reshape(wk, O * L)
    Hpp = oh2 @ torch.einsum("riol,rjol->ijol", Jpw, Jp).reshape(36, O * L).T
    bp = oh2 @ torch.einsum("riol,rol->iol", Jpw, ew).reshape(6, O * L).T
    Wc = torch.einsum("wol,ijol->wijl", ohw, torch.einsum("riol,rjol->ijol", Jpw, Jl))

    hinv = inv3x3_sym(torch.stack([Hll[0, 0], Hll[0, 1], Hll[0, 2], Hll[1, 1], Hll[1, 2],
                                   Hll[2, 2]]), lam)
    WH = torch.einsum("wikl,kjl->wijl", Wc, hinv.reshape(3, 3, L))
    S_red = torch.einsum("wikl,vmkl->wivm", WH, Wc).reshape(wk * 6, wk * 6)
    rhs_red = torch.einsum("wikl,kl->wi", WH, bl).reshape(wk * 6, 1)
    return (Hpp, bp, S_red, rhs_red, cost, hinv, bl, Wc.reshape(wk, 18, L))


def ba_cost_plain(posesT, X, slot, u, v, ur, isig2, act, cam5, use_huber: bool):
    """The robust cost alone (LM accept/reject) -> [1, 1]."""
    _, _, e, stereo, _ = observations(posesT, X, slot, u, v, ur, cam5)
    rho, _ = robust(e * torch.sqrt(isig2)[None], stereo, use_huber)
    return torch.sum(torch.where((slot >= 0) & (act > 0), rho, 0.0)).reshape(1, 1)


def window_mask(slot, povar, wk: int):
    """Each point's window mask word -> [L] int32: bit a is set where window
    slot a observes the point with a varying pose (some o with slot[o] == a
    and povar[o] != 0). Exactly the slots whose rows of ``Wc`` may be
    non-zero; the CUDA accumulate kernel writes these words for
    ``ba_backsub``."""
    a = torch.arange(wk, device=slot.device)
    has = ((slot[None] == a[:, None, None]) & (povar[None] != 0)).any(1)      # [wk,L]
    word = (has.to(torch.int64) << a[:, None]).sum(0)
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def ba_backsub_plain(Wc, Hinv, bl, dx_pose):
    """dx_pt [3,L] = -Hinv (bl + Wc^T dx_pose); Wc [wk,18,L], Hinv [9,L],
    bl [3,L], dx_pose [wk,6]."""
    wk, _, L = Wc.shape
    wt = torch.einsum("wikl,wi->kl", Wc.reshape(wk, 6, 3, L), dx_pose)
    return -torch.einsum("ijl,jl->il", Hinv.reshape(3, 3, L), bl + wt)
