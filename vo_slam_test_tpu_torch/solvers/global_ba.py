"""Global bundle adjustment, matrix-free Schur CG (port of the single-device
``global_bundle_adjust`` of ``vo_slam_test_tpu/solvers/global_ba.py``).

The reference stops at the essential graph after a loop closure (SURVEY §2);
upstream ORB-SLAM2 runs a global BA, so it exists here behind
``SlamSystem(enable_global_ba=True)``.

The reduced camera system S = Hpp - W Hll^-1 W^T is never formed: each CG
matvec evaluates it observation by observation,

    v_p = sum over p's observations of Jl^T Jp x_kf
    u_p = Hll^-1 v_p                       (closed-form 3x3 inverses)
    y_k = sum over k's observations of Jp^T Jl u_p
    Sx  = Hpp_blockdiag x - y

over the full [K,N] keypoint-to-point table (fixed shapes; keyframe 0 is the
usual gauge). Huber weights per LM iteration (chi2 5.991 / 7.815).

The solve runs in float64 (the map stays float32), a deliberate deviation
from the JAX package's float32: a point with one monocular observation has
a damped point block with a null direction, whose f32 adjugate determinant
is all cancellation, and the reduced camera system is then indefinite in
f32, so the CG's curvature can turn negative and the JAX package's
``max(p.Ap, 1e-20)`` step explodes (that LM step is rejected). In f64 the
port lands within a few mm of the JAX package's poses and meets its tests'
ground-truth bounds (tests/test_torch_global_ba.py).

Every sum is independent of scheduling, so two runs give the same map: the
JAX package's ``segment_sum`` becomes ``torch.segment_reduce``, which adds a
segment's entries one after another in order. Per keyframe the observations
are already keyframe-major; per point they are sorted once per call, stably,
so each point's observations keep that order. Invalid observations stay in
the table with point 0 and weight 0, as in the JAX package, and in every
per-keyframe sum; the per-point sums leave them out (they add zeros there,
and one thread sums a segment, so point 0's would hold every free slot of
the [K,N] table). The multi-device ``global_bundle_adjust_mesh`` is not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import lie
from ..camera import Camera
from ..slam_map.map_state import MapCaps, MapState
from ..utils import linalg
from .pose_only import CHI2_MONO, CHI2_STEREO


def _obs_table(m: MapState):
    """The [K,N] binding table flattened keyframe-major -> (o_kf, o_kp, o_pt
    (0 where unbound), valid)."""
    K, N = m.kf_mp.shape
    dev = m.device
    o_kf = torch.arange(K, device=dev).repeat_interleave(N)
    o_kp = torch.arange(N, device=dev).repeat(K)
    o_pt = m.kf_mp.reshape(-1).long()
    valid = ((o_pt >= 0) & m.kf_valid[o_kf] & m.kf_kp_valid.reshape(-1)
             & m.pt_valid[o_pt.clamp(min=0)])
    return o_kf, o_kp, o_pt.clamp(min=0), valid


def _prep_obs(m: MapState, inv_level_sigma2: Optional[torch.Tensor]):
    """Per-observation constants, gathered once (they do not change across
    LM iterations): indices, measurements, weights, validity."""
    o_kf, o_kp, o_pt, o_valid = _obs_table(m)
    uv = m.kf_uv_und.reshape(-1, 2)
    ur_obs = m.kf_u_right.reshape(-1)
    obs_oct = m.kf_octave.reshape(-1).long()
    if inv_level_sigma2 is None:
        inv_sig2 = 1.0 / (1.2 ** (2.0 * obs_oct.to(torch.float32)))
    else:
        inv_sig2 = inv_level_sigma2[obs_oct]
    return o_kf, o_pt, o_valid, uv, ur_obs, inv_sig2


def _residuals_jacs(poses, points, o_kf, o_pt, uv, ur_obs, cam: Camera):
    T = poses[o_kf]
    X = points[o_pt]
    pc = torch.einsum("mij,mj->mi", T[:, :3, :3], X) + T[:, :3, 3]
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    invz = 1.0 / safe_z
    u = cam.fx * pc[:, 0] * invz + cam.cx
    v = cam.fy * pc[:, 1] * invz + cam.cy
    stereo = ur_obs >= 0
    ur = u - cam.bf * invz
    e = torch.stack([u - uv[:, 0], v - uv[:, 1], torch.where(stereo, ur - ur_obs, 0.0)], -1)
    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * invz, zero, -cam.fx * pc[:, 0] * invz * invz], -1)
    dv = torch.stack([zero, cam.fy * invz, -cam.fy * pc[:, 1] * invz * invz], -1)
    dur = du + torch.stack([zero, zero, cam.bf * invz * invz], -1)
    dproj = torch.stack([du, dv, torch.where(stereo[:, None], dur, 0.0)], -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc = torch.cat([eye, -lie.hat(pc)], -1)
    return e, dproj @ dpc, dproj @ T[:, :3, :3], stereo


def _gba_optimize(poses0, points0, o_kf, o_pt, o_valid, uv, ur_obs, inv_sig2, free, pt_valid,
                  cam: Camera, iters: int, cg_iters: int):
    """The LM / CG core -> (poses, points)."""
    K = free.shape[0]
    P = pt_valid.shape[0]
    M = o_kf.shape[0]
    dev, dt = poses0.device, poses0.dtype
    len_kf = torch.full((K,), M // K, dtype=torch.int64, device=dev)
    # per point: the bound observations only, in keyframe-major order; the
    # unbound ones (o_pt 0, weight 0) sort last, into a segment P that is
    # cut off, so no segment's length grows with the free slots
    key = torch.where(o_valid, o_pt, P)
    by_pt = torch.argsort(key, stable=True)[:int(o_valid.sum())]
    len_pt = torch.bincount(key, minlength=P + 1)[:P]

    def sum_kf(x):  # observations are keyframe-major
        return torch.segment_reduce(x, "sum", lengths=len_kf, axis=0, unsafe=True)

    def sum_pt(x):
        return torch.segment_reduce(x[by_pt], "sum", lengths=len_pt, axis=0, unsafe=True)

    inv_sig = torch.sqrt(inv_sig2)
    d_mono = CHI2_MONO ** 0.5
    d_stereo = CHI2_STEREO ** 0.5
    free_f = free.to(dt)[:, None]
    eye3, eye6 = torch.eye(3, dtype=dt, device=dev), torch.eye(6, dtype=dt, device=dev)

    def cost(ps, xs):
        ee, _, _, st = _residuals_jacs(ps, xs, o_kf, o_pt, uv, ur_obs, cam)
        ew = ee * inv_sig[:, None]
        s2 = torch.sum(ew * ew, -1)
        dd = torch.where(st, d_stereo, d_mono)
        ss = torch.sqrt(s2 + 1e-12)
        rho = torch.where(ss <= dd, s2, 2 * dd * ss - dd * dd)
        return torch.sum(torch.where(o_valid, rho, 0.0))

    poses, points = poses0, points0
    for _ in range(iters):
        e, Jp, Jl, stereo = _residuals_jacs(poses, points, o_kf, o_pt, uv, ur_obs, cam)
        ew = e * inv_sig[:, None]
        nrm = torch.sqrt(torch.sum(ew * ew, -1) + 1e-12)
        delta = torch.where(stereo, d_stereo, d_mono)
        w = o_valid.to(e.dtype) * torch.clamp(delta / nrm, max=1.0) * inv_sig2
        wp = w * free_f[o_kf, 0]

        # block-diagonal Hessians and gradients
        Hpp = sum_kf(wp[:, None, None] * torch.einsum("mri,mrj->mij", Jp, Jp))
        bp = sum_kf(wp[:, None] * torch.einsum("mri,mr->mi", Jp, e))
        Hll = sum_pt(w[:, None, None] * torch.einsum("mri,mrj->mij", Jl, Jl))
        bl = sum_pt(w[:, None] * torch.einsum("mri,mr->mi", Jl, e))
        lam = 1e-3
        Hll_inv = linalg.inv3x3(Hll + (lam + 1e-7) * eye3)
        Hpp_d = Hpp + lam * eye6

        def schur_matvec(x):  # [K,6] -> [K,6]
            px = torch.einsum("mri,mi->mr", Jp, x[o_kf])
            v = sum_pt(wp[:, None] * torch.einsum("mri,mr->mi", Jl, px))
            u_ = torch.einsum("pij,pj->pi", Hll_inv, v)
            back = torch.einsum("mri,mi->mr", Jl, u_[o_pt])
            y = sum_kf(wp[:, None] * torch.einsum("mri,mr->mi", Jp, back))
            return torch.einsum("kij,kj->ki", Hpp_d, x) - y

        u0 = torch.einsum("pij,pj->pi", Hll_inv, bl)
        back0 = torch.einsum("mri,mi->mr", Jl, u0[o_pt])
        r_rhs = bp - sum_kf(wp[:, None] * torch.einsum("mri,mr->mi", Jp, back0))
        rhs = -r_rhs * free_f

        # CG preconditioned by the 6x6 diagonal blocks
        Hpp_inv = torch.linalg.inv_ex(Hpp_d + 1e-6 * eye6)[0]

        def precond(r):
            return torch.einsum("kij,kj->ki", Hpp_inv, r) * free_f

        x = torch.zeros((K, 6), dtype=dt, device=dev)
        r = rhs
        p_ = precond(rhs)
        rz = torch.sum(rhs * p_)
        for _ in range(cg_iters):
            Ap = schur_matvec(p_) * free_f
            alpha = rz / torch.clamp(torch.sum(p_ * Ap), min=1e-20)
            x = x + alpha * p_
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p_ = z + beta * p_
            rz = rz_new
        dx_pose = x * free_f

        # back-substitute the points: dx_l = -Hll^-1 (bl + W^T dx)
        px = torch.einsum("mri,mi->mr", Jp, dx_pose[o_kf])
        wtd = sum_pt(wp[:, None] * torch.einsum("mri,mr->mi", Jl, px))
        dx_pt = -torch.einsum("pij,pj->pi", Hll_inv, bl + wtd) * pt_valid.to(dt)[:, None]

        poses_new = torch.where(free[:, None, None],
                                lie.orthonormalize(lie.se3_exp(dx_pose) @ poses), poses)
        points_new = points + dx_pt
        # accept only if the robust cost decreased
        better = cost(poses_new, points_new) < cost(poses, points)
        poses = torch.where(better, poses_new, poses)
        points = torch.where(better, points_new, points)
    return poses, points


def global_bundle_adjust(m: MapState, caps: MapCaps, cam: Camera, fixed_kf: int, iters: int = 10,
                         cg_iters: int = 24, inv_level_sigma2: Optional[torch.Tensor] = None
                         ) -> MapState:
    """Whole-map BA with keyframe ``fixed_kf`` held fixed -> the map with
    new keyframe poses and point positions."""
    o_kf, o_pt, o_valid, uv, ur_obs, inv_sig2 = _prep_obs(m, inv_level_sigma2)
    free = m.kf_valid & (torch.arange(caps.max_kf, device=m.device) != fixed_kf)
    f64 = torch.float64
    poses, points = _gba_optimize(m.kf_pose.to(f64), m.pt_pos.to(f64), o_kf, o_pt, o_valid,
                                  uv.to(f64), ur_obs.to(f64), inv_sig2.to(f64), free, m.pt_valid,
                                  cam, iters, cg_iters)
    # slots the solve holds fixed keep their f32 values exactly
    return m.replace(kf_pose=torch.where(free[:, None, None], poses.to(torch.float32), m.kf_pose),
                     pt_pos=torch.where(m.pt_valid[:, None], points.to(torch.float32), m.pt_pos))
