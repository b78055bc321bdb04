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
the [K,N] table): they sort after the bound ones, into segments of their
own that are cut off.

The LM iterations and the CG iterations nested in each are
``utils.graphs.fori_loop``s (the JAX package's ``fori_loop``s; in a capture
each is one WHILE node whose body is captured once), and nothing is read
back: every shape is fixed (the whole sort, the segment lengths counted on
the device) and ``fixed_kf`` may be a device int. ``program`` is the
process's global-BA step program for a static configuration
(``SlamSystem`` runs it with ``graphs=True``), the counterpart of the JAX
package's jitted ``global_bundle_adjust``.

``global_bundle_adjust_mesh`` runs the same core with the [K*N] observation
axis split over the shards of a ``parallel.ObsMesh``: every sum over
observations (``sum_kf``, ``sum_pt``, the costs) becomes a shard's partial,
then a psum in shard order; poses, points and the CG state stay on the
mesh's first device. A shard boundary may cut through a keyframe's N
observations, so each shard sums its keyframes over the lengths of its own
runs. ``global_bundle_adjust`` is the one-shard case; ``program`` with a
mesh is its step program.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import lie
from ..camera import Camera
from ..parallel.sharded import ObsMesh, one_device
from ..slam_map.insert import Index
from ..slam_map.map_state import MapCaps, MapState
from ..utils import graphs, linalg
from .pose_only import CHI2_MONO, CHI2_STEREO


CUT_SEGMENT = 32  # table slots per cut-off segment of the per-point sums (_gba_optimize)


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


def _gba_optimize(poses0, points0, obs, len_kf, free, pt_valid, cams, iters: int,
                  cg_iters: int, mesh: ObsMesh):
    """The LM / CG core -> (poses, points). ``obs``: per shard (o_kf, o_pt,
    o_valid, uv, ur_obs, inv_sig2) on the shard's device; ``len_kf``: per
    shard the [K] lengths of its keyframe-major runs; ``cams``: the camera on
    each shard's device. Poses and points live on the mesh's first device."""
    K = free.shape[0]
    P = pt_valid.shape[0]
    dev, dt = poses0.device, poses0.dtype
    shards = range(mesh.n_shards)
    # per point: the bound observations in keyframe-major order; the unbound
    # ones (o_pt 0, weight 0) sort last, into segments P + j of at most
    # CUT_SEGMENT table slots each, which are cut off. One thread sums a
    # segment, serially: one segment P of every free slot made the solve ~8x
    # slower at the default caps, one per keyframe row (N slots) doubled it
    # on main path 5. The lengths are counted on the device
    by_pt, len_pt = [], []
    for o_kf, o_pt, o_valid, *_ in obs:
        M = o_pt.shape[0]
        slot = torch.arange(M, device=o_pt.device)
        key = torch.where(o_valid, o_pt, P + torch.div(slot, CUT_SEGMENT, rounding_mode="floor"))
        by_pt.append(torch.argsort(key, stable=True))
        len_pt.append(torch.zeros(P + -(-M // CUT_SEGMENT), dtype=torch.int64,
                                  device=key.device).index_add_(0, key, torch.ones_like(key)))

    def sum_kf(xs):  # each shard's observations are keyframe-major
        return mesh.psum([torch.segment_reduce(x, "sum", lengths=n, axis=0, unsafe=True)
                          for x, n in zip(xs, len_kf)])

    def sum_pt(xs):
        return mesh.psum([torch.segment_reduce(x[b], "sum", lengths=n, axis=0, unsafe=True)[:P]
                          for x, b, n in zip(xs, by_pt, len_pt)])

    d_mono = CHI2_MONO ** 0.5
    d_stereo = CHI2_STEREO ** 0.5
    free_f = free.to(dt)[:, None]
    free_s = [f[o[0], 0] for f, o in zip(mesh.replicate(free_f), obs)]
    inv_sig = [torch.sqrt(o[5]) for o in obs]
    eye3, eye6 = torch.eye(3, dtype=dt, device=dev), torch.eye(6, dtype=dt, device=dev)

    def residuals(ps, xs):
        return [_residuals_jacs(P_s, X_s, o[0], o[1], o[3], o[4], c)
                for P_s, X_s, o, c in zip(mesh.replicate(ps), mesh.replicate(xs), obs, cams)]

    def cost(ps, xs):
        parts = []
        for (ee, _, _, st), o, isg in zip(residuals(ps, xs), obs, inv_sig):
            ew = ee * isg[:, None]
            s2 = torch.sum(ew * ew, -1)
            dd = torch.where(st, d_stereo, d_mono)
            ss = torch.sqrt(s2 + 1e-12)
            rho = torch.where(ss <= dd, s2, 2 * dd * ss - dd * dd)
            parts.append(torch.sum(torch.where(o[2], rho, 0.0)))
        return mesh.psum(parts)

    def lm_iter(_, carry):
        poses, points = carry
        res = residuals(poses, points)
        w, wp = [], []
        for (e, _, _, stereo), o, isg, fs in zip(res, obs, inv_sig, free_s):
            ew = e * isg[:, None]
            nrm = torch.sqrt(torch.sum(ew * ew, -1) + 1e-12)
            delta = torch.where(stereo, d_stereo, d_mono)
            w.append(o[2].to(e.dtype) * torch.clamp(delta / nrm, max=1.0) * o[5])
            wp.append(w[-1] * fs)
        e, Jp, Jl = ([r[i] for r in res] for i in range(3))

        # block-diagonal Hessians and gradients
        Hpp = sum_kf([a[:, None, None] * torch.einsum("mri,mrj->mij", J, J)
                      for a, J in zip(wp, Jp)])
        bp = sum_kf([a[:, None] * torch.einsum("mri,mr->mi", J, r) for a, J, r in zip(wp, Jp, e)])
        Hll = sum_pt([a[:, None, None] * torch.einsum("mri,mrj->mij", J, J)
                      for a, J in zip(w, Jl)])
        bl = sum_pt([a[:, None] * torch.einsum("mri,mr->mi", J, r) for a, J, r in zip(w, Jl, e)])
        lam = 1e-3
        Hll_inv = linalg.inv3x3(Hll + (lam + 1e-7) * eye3)
        Hpp_d = Hpp + lam * eye6

        def pose_to_points(x):  # [K,6] -> sum over each point's obs of Jl^T Jp x_kf
            return sum_pt([a[:, None] * torch.einsum("mri,mr->mi", Jl_s, torch.einsum(
                "mri,mi->mr", Jp_s, x_s[o[0]])) for a, Jl_s, Jp_s, x_s, o in
                zip(wp, Jl, Jp, mesh.replicate(x), obs)])

        def points_to_poses(u):  # [P,3] -> sum over each keyframe's obs of Jp^T Jl u_pt
            return sum_kf([a[:, None] * torch.einsum("mri,mr->mi", Jp_s, torch.einsum(
                "mri,mi->mr", Jl_s, u_s[o[1]])) for a, Jl_s, Jp_s, u_s, o in
                zip(wp, Jl, Jp, mesh.replicate(u), obs)])

        def schur_matvec(x):  # [K,6] -> [K,6]
            u_ = torch.einsum("pij,pj->pi", Hll_inv, pose_to_points(x))
            return torch.einsum("kij,kj->ki", Hpp_d, x) - points_to_poses(u_)

        u0 = torch.einsum("pij,pj->pi", Hll_inv, bl)
        r_rhs = bp - points_to_poses(u0)
        rhs = -r_rhs * free_f

        # CG preconditioned by the 6x6 diagonal blocks
        Hpp_inv = torch.linalg.inv_ex(Hpp_d + 1e-6 * eye6)[0]

        def precond(r):
            return torch.einsum("kij,kj->ki", Hpp_inv, r) * free_f

        def cg_body(_, st):
            x, r, p_, rz = st
            Ap = schur_matvec(p_) * free_f
            alpha = rz / torch.clamp(torch.sum(p_ * Ap), min=1e-20)
            x = x + alpha * p_
            r = r - alpha * Ap
            z = precond(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.clamp(rz, min=1e-20)
            return x, r, z + beta * p_, rz_new

        z0 = precond(rhs)
        x = graphs.fori_loop(0, cg_iters, cg_body, (
            torch.zeros((K, 6), dtype=dt, device=dev), rhs, z0, torch.sum(rhs * z0)))[0]
        dx_pose = x * free_f

        # back-substitute the points: dx_l = -Hll^-1 (bl + W^T dx)
        wtd = pose_to_points(dx_pose)
        dx_pt = -torch.einsum("pij,pj->pi", Hll_inv, bl + wtd) * pt_valid.to(dt)[:, None]

        poses_new = torch.where(free[:, None, None],
                                lie.orthonormalize(lie.se3_exp(dx_pose) @ poses), poses)
        points_new = points + dx_pt
        # accept only if the robust cost decreased
        better = cost(poses_new, points_new) < cost(poses, points)
        return torch.where(better, poses_new, poses), torch.where(better, points_new, points)

    return graphs.fori_loop(0, iters, lm_iter, (poses0, points0))


def _global_ba(m: MapState, caps: MapCaps, cam: Camera, fixed_kf: Index, iters: int,
               cg_iters: int, inv_level_sigma2: Optional[torch.Tensor],
               mesh: Optional[ObsMesh]) -> MapState:
    f64 = torch.float64
    o_kf, o_pt, o_valid, uv, ur_obs, inv_sig2 = _prep_obs(m, inv_level_sigma2)
    free = m.kf_valid & (torch.arange(caps.max_kf, device=m.device) != fixed_kf)
    K, N = m.kf_mp.shape
    cols = (o_kf, o_pt, o_valid, uv.to(f64), ur_obs.to(f64), inv_sig2.to(f64))
    if mesh is None:
        mesh = ObsMesh(1, [m.device])
        obs = [cols]
        len_kf = [torch.full((K,), N, dtype=torch.int64, device=m.device)]
    else:
        if (K * N) % mesh.n_shards:
            raise ValueError(f"global BA: K*N={K * N} observations not divisible by "
                             f"{mesh.n_shards} shards")
        obs = list(zip(*[mesh.split(c) for c in cols]))
        # shard s holds table rows [s M/n, (s+1) M/n): its run of keyframe k is
        # the overlap with [k N, (k+1) N), computed on the shard's device (a
        # host-to-device copy would replay from a freed buffer in a graph)
        n = K * N // mesh.n_shards
        len_kf = []
        for s, dev in enumerate(mesh.shard_devices):
            kf0 = torch.arange(K, device=dev) * N
            len_kf.append(torch.clamp(torch.clamp(kf0 + N, max=(s + 1) * n)
                                      - torch.clamp(kf0, min=s * n), min=0))
    poses, points = _gba_optimize(m.kf_pose.to(f64), m.pt_pos.to(f64), obs, len_kf, free,
                                  m.pt_valid, mesh.replicate_fields(cam), iters, cg_iters, mesh)
    # slots the solve holds fixed keep their f32 values exactly
    return m.replace(kf_pose=torch.where(free[:, None, None], poses.to(torch.float32), m.kf_pose),
                     pt_pos=torch.where(m.pt_valid[:, None], points.to(torch.float32), m.pt_pos))


def global_bundle_adjust(m: MapState, caps: MapCaps, cam: Camera, fixed_kf: Index,
                         iters: int = 10, cg_iters: int = 24,
                         inv_level_sigma2: Optional[torch.Tensor] = None) -> MapState:
    """Whole-map BA with keyframe ``fixed_kf`` (a Python int or a 0-d device
    int) held fixed -> the map with new keyframe poses and point positions."""
    return _global_ba(m, caps, cam, fixed_kf, iters, cg_iters, inv_level_sigma2, None)


def global_ba_step(inputs, m: MapState, *, caps: MapCaps, iters: int, cg_iters: int,
                   mesh: Optional[ObsMesh] = None):
    """``global_bundle_adjust`` (``global_bundle_adjust_mesh`` with a
    ``mesh``) as a step program's function, ``(inputs, map) -> (map, ())``:
    ``inputs`` are the camera, ``inv_level_sigma2`` (or None) and
    ``fixed_kf`` as a 0-d device int; the statics are bound by keyword, so it
    closes over no system."""
    cam, inv_level_sigma2, fixed_kf = inputs
    return _global_ba(m, caps, cam, fixed_kf, iters, cg_iters, inv_level_sigma2, mesh), ()


class MapOwner:
    """The owner of a ``program`` run outside a ``SlamSystem``: ``map`` holds
    the map the program last returned (``graphs.Program`` clones it into
    tensors of its own when another owner's replay takes the static buffers
    over)."""

    def __init__(self, m: MapState):
        self.map = m


def program(owner, caps: MapCaps, cam: Camera, inv_level_sigma2: Optional[torch.Tensor],
            mesh: Optional[ObsMesh] = None) -> graphs.Program:
    """``owner``'s share of the process's global-BA step program
    (``global_ba_step`` at ``global_bundle_adjust``'s 10 LM and 24 CG
    iterations), keyed as the JAX package's jit: ``caps``, the iterations
    and the signature of the traced camera and scale table, and with a
    ``mesh`` (``global_bundle_adjust_mesh``, the JAX package's jit of the
    ``shard_map``) its layout, the shards and their devices. ``owner.map``
    may hold the program's static map (a ``SlamSystem``, or a
    ``MapOwner``). Run it as ``program.run((cam, inv_level_sigma2,
    fixed_kf), map)``. A mesh over more than one device raises
    ``ValueError`` (``parallel.sharded.one_device``)."""
    statics = dict(caps=caps, iters=10, cg_iters=24)
    key = tuple(sorted(statics.items()))
    name, device = "global_ba", cam.fx.device
    if mesh is not None:
        one_device(mesh, "global BA mesh program")
        name, device = "global_ba_mesh", mesh.root
        key += (("mesh", (mesh.n_shards, mesh.shard_devices)),)
        statics["mesh"] = mesh
    return graphs.Program(name, key + (graphs.signature((cam, inv_level_sigma2)),),
                          functools.partial(global_ba_step, **statics), device, owner, ("map",))


def global_bundle_adjust_mesh(m: MapState, caps: MapCaps, cam: Camera, fixed_kf: Index,
                              mesh: ObsMesh, iters: int = 10, cg_iters: int = 24,
                              inv_level_sigma2: Optional[torch.Tensor] = None) -> MapState:
    """``global_bundle_adjust`` with the [K*N] observation table split over
    ``mesh`` (K*N must divide); the same Huber weights, CG on the Schur
    complement and cost-gated steps. Only the rounding of the cross-shard
    sums differs from the one-shard run."""
    return _global_ba(m, caps, cam, fixed_kf, iters, cg_iters, inv_level_sigma2, mesh)
