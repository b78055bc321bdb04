"""Observation-sharded solvers (port of ``vo_slam_test_tpu/parallel/sharded.py``).

The JAX package shards a solver's data axis (observations, or local BA's
points) over a ``jax.sharding.Mesh`` with ``shard_map`` and reduces the small
normal equations with ``psum``. The port keeps that single-controller design
in one process: an ``ObsMesh`` is an ordered list of shards placed round-robin
over an ordered list of devices. Each shard's tensors live on its device and
its work is ordinary torch ops (or, in the mesh solvers, the kernels) there;
``psum`` and ``pmax`` reduce the shards' partials in shard order on the first
shard's device, and ``replicate`` copies a reduced value back to each shard's
device (no copy where a shard shares the first device). Only reduced terms
move between devices, never observations.

The tests run 8 shards on the CPU, the counterpart of the JAX package's 8
virtual CPU devices; on one card 8 shards share it. NCCL cannot join two
ranks on one GPU, and the JAX code is one controller as well.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from .. import lie
from ..solvers.pose_only import PoseObs, _residuals_jac

Device = Union[str, torch.device]


class ObsMesh:
    """``n_shards`` shards of one mesh axis over ``devices`` (round-robin)."""

    def __init__(self, n_shards: int, devices: Sequence[Device]):
        if n_shards < 1 or not devices:
            raise ValueError(f"ObsMesh: need n_shards >= 1 and a device, got {n_shards}, "
                             f"{list(devices)}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.shard_devices = tuple(self.devices[s % len(self.devices)] for s in range(n_shards))

    @property
    def n_shards(self) -> int:
        return len(self.shard_devices)

    @property
    def n_devices(self) -> int:
        """Distinct devices that hold a shard."""
        return len(set(self.shard_devices))

    @property
    def root(self) -> torch.device:
        """The first shard's device, where reductions and replicated solves run."""
        return self.shard_devices[0]

    def split(self, x: torch.Tensor, dim: int = 0) -> List[torch.Tensor]:
        """Contiguous equal slices of ``x`` along ``dim``, one per shard, each
        contiguous on its shard's device (``P("obs")`` of the JAX package)."""
        n = x.shape[dim]
        if n % self.n_shards:
            raise ValueError(f"ObsMesh.split: axis of {n} not divisible by {self.n_shards} shards")
        return [part.contiguous().to(dev)
                for part, dev in zip(torch.chunk(x, self.n_shards, dim), self.shard_devices)]

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every shard's device (``P()``)."""
        return [x.to(dev) for dev in self.shard_devices]

    def replicate_fields(self, obj) -> list:
        """A dataclass of tensors (a ``Camera``) on every shard's device."""
        return [dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}) for dev in self.shard_devices]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """The shards' slices joined along ``dim`` on ``root`` (``split``'s inverse)."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.root) for p in parts], dim)

    def on(self, s: int):
        """A context in which shard ``s``'s device is the current CUDA device
        (the kernels launch on the current device)."""
        dev = self.shard_devices[s]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum of the shards' partials, added in shard order on ``root``."""
        out = parts[0].to(self.root)
        for p in parts[1:]:
            out = out + p.to(self.root)
        return out

    def pmax(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise maximum of the shards' partials on ``root``."""
        out = parts[0].to(self.root)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(self.root))
        return out


def make_obs_mesh(n_shards: int, devices: Optional[Sequence[Device]] = None) -> ObsMesh:
    """A mesh of ``n_shards`` shards over ``devices``; the default is every
    CUDA device (raises when there is none: the CPU only when asked for)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_obs_mesh: no CUDA device; pass devices=['cpu'] explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    return ObsMesh(n_shards, devices)


def one_device(mesh: ObsMesh, what: str) -> None:
    """Raise ``ValueError`` for a mesh whose shards span more than one
    device: a step program is a CUDA graph, which belongs to one device, so
    such a mesh runs the eager mesh solvers (the caller names them)."""
    if mesh.n_devices > 1:
        raise ValueError(
            f"{what}: the mesh spans {mesh.n_devices} devices "
            f"({', '.join(sorted({str(d) for d in mesh.shard_devices}))}) and a step program is "
            f"one device's CUDA graph; call the eager mesh solver for such a mesh")


def shard_observations(mesh: ObsMesh, obs: PoseObs) -> List[PoseObs]:
    """One ``PoseObs`` per shard: each field split along the observation axis."""
    fields = [mesh.split(f) for f in obs]
    return [PoseObs(*parts) for parts in zip(*fields)]


def sharded_pose_gn_step(mesh: ObsMesh):
    """-> fn(T, obs, fx, fy, cx, cy, bf) -> T': one observation-sharded
    Gauss-Newton step with psum-reduced normal equations. ``obs`` is a
    ``PoseObs`` (split here) or ``shard_observations``' list."""

    def gn_step(T, obs, fx, fy, cx, cy, bf):
        if isinstance(obs, PoseObs):
            obs = shard_observations(mesh, obs)
        Hs, gs = [], []
        for T_s, o in zip(mesh.replicate(T), obs):
            e, J, _ = _residuals_jac(T_s, o, fx, fy, cx, cy, bf)
            w = o.valid.to(e.dtype) * o.inv_sigma2
            Hs.append(torch.einsum("nri,nrj,n->ij", J, J, w))
            gs.append(torch.einsum("nri,nr,n->i", J, e, w))
        H, g = mesh.psum(Hs), mesh.psum(gs)
        eye = torch.eye(6, dtype=H.dtype, device=H.device)
        step = -torch.linalg.solve(H + 1e-6 * eye, g)
        return lie.orthonormalize(lie.se3_exp(step) @ T.to(H.device))

    return gn_step


def _ba_terms(poses, points, o_kf, o_pt, o_uv, o_w, fx, fy, cx, cy):
    """One shard's observations -> (kf, pt, w, e, Jp, Jl) of the monocular
    reprojection residual (the JAX package's in-shard body)."""
    kf = o_kf.clamp(min=0).long()
    pt = o_pt.clamp(min=0).long()
    T = poses[kf]
    X = points[pt]
    pc = torch.einsum("mij,mj->mi", T[:, :3, :3], X) + T[:, :3, 3]
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    invz = 1.0 / z
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    e = torch.stack([u - o_uv[:, 0], v - o_uv[:, 1]], -1)
    zero = torch.zeros_like(z)
    du = torch.stack([fx * invz, zero, -fx * pc[:, 0] * invz * invz], -1)
    dv = torch.stack([zero, fy * invz, -fy * pc[:, 1] * invz * invz], -1)
    dproj = torch.stack([du, dv], -2)                                  # [M,2,3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jp = dproj @ torch.cat([eye, -lie.hat(pc)], -1)                    # [M,2,6]
    Jl = dproj @ T[:, :3, :3]                                          # [M,2,3]
    w = o_w * (o_kf >= 0) * (o_pt >= 0)
    return kf, pt, w, e, Jp, Jl


def _segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def _sharded_normal_equations(mesh, n_window, n_points, poses, points, o_kf, o_pt, o_uv, o_w,
                              fx, fy, cx, cy, with_cross: bool):
    parts = []
    for P_s, X_s, kf_s, pt_s, uv_s, w_s in zip(
            mesh.replicate(poses), mesh.replicate(points),
            *[mesh.split(x) for x in (o_kf, o_pt, o_uv, o_w)]):
        kf, pt, w, e, Jp, Jl = _ba_terms(P_s, X_s, kf_s, pt_s, uv_s, w_s, fx, fy, cx, cy)
        terms = [
            _segment_sum(w[:, None, None] * torch.einsum("mri,mrj->mij", Jp, Jp), kf, n_window),
            _segment_sum(w[:, None] * torch.einsum("mri,mr->mi", Jp, e), kf, n_window),
            _segment_sum(w[:, None, None] * torch.einsum("mri,mrj->mij", Jl, Jl), pt, n_points),
            _segment_sum(w[:, None] * torch.einsum("mri,mr->mi", Jl, e), pt, n_points),
        ]
        if with_cross:
            cross = w[:, None, None] * torch.einsum("mri,mrj->mij", Jp, Jl)  # [M,6,3]
            terms.append(_segment_sum(cross, kf * n_points + pt, n_window * n_points)
                         .reshape(n_window, n_points, 6, 3))
        parts.append(terms)
    return [mesh.psum(list(t)) for t in zip(*parts)]


def sharded_ba_normal_equations(mesh: ObsMesh, n_window: int, n_points: int):
    """-> fn(poses [W,4,4], points [L,3], o_kf [M], o_pt [M], o_uv [M,2],
    o_w [M], fx, fy, cx, cy) -> (Hpp [W,6,6], bp [W,6], Hll [L,3,3], bl [L,3]),
    the observation-sharded accumulation of local BA's normal equations with
    every output psum-reduced. The observation arrays are split here."""

    def accumulate(poses, points, o_kf, o_pt, o_uv, o_w, fx, fy, cx, cy):
        return tuple(_sharded_normal_equations(mesh, n_window, n_points, poses, points, o_kf,
                                               o_pt, o_uv, o_w, fx, fy, cx, cy, False))

    return accumulate


def sharded_ba_schur_step(mesh: ObsMesh, n_window: int, n_points: int, lam: float = 1e-4):
    """One full distributed BA Gauss-Newton step: the observation-sharded
    accumulation of (Hpp, bp, Hll, bl, cross terms) psum-reduced, then the
    dense Schur solve (first pose pinned by a large diagonal) and the pose and
    point update, once on the mesh's first device.

    -> fn(poses [W,4,4], points [L,3], o_kf [M], o_pt [M], o_uv [M,2], o_w [M],
    fx, fy, cx, cy) -> (poses', points')."""

    def step(poses, points, o_kf, o_pt, o_uv, o_w, fx, fy, cx, cy):
        Hpp, bp, Hll, bl, Wc = _sharded_normal_equations(
            mesh, n_window, n_points, poses, points, o_kf, o_pt, o_uv, o_w, fx, fy, cx, cy, True)
        poses, points = poses.to(Hpp.device), points.to(Hpp.device)
        dt, dev = Hpp.dtype, Hpp.device
        eye3, eye6 = torch.eye(3, dtype=dt, device=dev), torch.eye(6, dtype=dt, device=dev)
        Hll_inv = torch.linalg.inv(Hll + lam * eye3)
        WHinv = torch.einsum("wpij,pjl->wpil", Wc, Hll_inv)
        S = -torch.einsum("wpil,vpml->wivm", WHinv, Wc)
        S = S + torch.einsum("wij,wv->wivj", Hpp + lam * eye6, torch.eye(n_window, dtype=dt,
                                                                         device=dev))
        rhs = bp - torch.einsum("wpil,pl->wi", WHinv, bl)
        # gauge: pin the first pose with a large diagonal boost before the solve
        S[0, :, 0, :] += 1e8 * eye6
        n6 = n_window * 6
        Sd = S.reshape(n6, n6) + 1e-8 * torch.eye(n6, dtype=dt, device=dev)
        dx_pose = -torch.linalg.solve(Sd, rhs.reshape(-1)).reshape(n_window, 6)
        dx_pose = torch.cat([torch.zeros_like(dx_pose[:1]), dx_pose[1:]])
        Wt_dx = torch.einsum("wpil,wi->pl", Wc, dx_pose)
        dx_pt = -torch.einsum("pij,pj->pi", Hll_inv, bl + Wt_dx)
        poses_new = lie.orthonormalize(lie.se3_exp(dx_pose) @ poses)
        return poses_new, points + dx_pt

    return step
