"""Windowed local bundle adjustment with Schur elimination (port of
``vo_slam_test_tpu/solvers/local_ba.py``, its dense [blk,O,L] layout).

The reference's Ceres local BA (optimizer_ceres.cpp:446-808) as the JAX
package redesigned it:

- window = the new keyframe + its covisible keyframes (top ``W_KF`` by
  weight, ties in index order), fixed keyframes = the other observers of the
  window's points (first ``F_KF``); with no fixed observer the lowest-id
  window keyframe is pinned (gauge);
- observations from each local point's observer list, valid first, at most
  ``O_BA`` per point, in an [O, L] layout with the point axis last;
- Levenberg-Marquardt where each iteration builds the normal equations and
  the Schur-reduced camera system in ``ops/ba_cuda.py::ba_accumulate``
  (kernel), solves the (wk*6)^2 system with a Cholesky factorization, back-
  substitutes the points (``ba_backsub``, kernel) and accepts the step when
  the robust cost (``ba_cost``, kernel) fell;
- pass 1 with Huber and 5 iterations, chi2 reclassification, pass 2 on the
  inliers without a robust loss and 10 iterations (optimizer_ceres.cpp:
  583-699); write-back of the window poses and the points, erasure of the
  outlier observations and the obs<=2 point invalidation (:757-804,
  mappoint.cpp:353).

The LM loop is a Python loop that reads its ``done`` flag back once per
iteration (one host sync per LM iteration), so the iteration counts, and the
kernels' launches, are the ones the JAX package's ``lax.while_loop`` runs:
``ba_accumulate``, ``ba_backsub`` and ``ba_cost`` once each per iteration.
JAX's Cholesky gives NaN on a matrix that is not positive definite and the
step is then rejected (NaN < c is false); ``cholesky_ex`` gives a partial
factor, which is replaced by NaN for the same outcome. On CPU tensors the
kernels' plain versions run (``ops/ba_pallas.py``), which compute
``_lm_pass_ol``'s quantities.

The problem carries ``o_povar`` (the JAX problem's ``oh_win`` summed over its
window axis) in place of the one-hot tensors ``oh_all``/``oh_win``, which
only the JAX package's einsum path needs. ``local_bundle_adjust_mesh`` runs
the same solver with the point axis split over the shards of a
``parallel.ObsMesh``; ``local_bundle_adjust`` is its one-shard case. The flat
``build_problem`` (one row per observation) is the JAX package's problem
layout off the solver's path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import lie
from ..camera import Camera
from ..ops import ba_cuda, ba_pallas
from ..parallel.sharded import ObsMesh
from ..slam_map.map_state import (MapCaps, MapState, compact_ids, scatter_add, scatter_or,
                                  scatter_set)
from .pose_only import CHI2_MONO, CHI2_STEREO

W_KF = 24       # optimized window keyframes
F_KF = 40       # fixed keyframes
L_PT = 8192     # local points
N_OBS = 24576   # observation slots of the flat problem
O_BA = 12       # observer slots per point entering BA (valid-first compaction)

_I32, _F32 = torch.int32, torch.float32


class BAProblem(NamedTuple):
    """The flat problem layout: one row per observation."""

    kf_ids: torch.Tensor        # [W+F] i32 (window first; -1 pad)
    kf_fixed: torch.Tensor      # [W+F] bool
    pt_ids: torch.Tensor        # [L] i32 (-1 pad)
    o_kf: torch.Tensor          # [M] i32 index into kf_ids (-1 pad)
    o_pt: torch.Tensor          # [M] i32 index into pt_ids
    o_uv: torch.Tensor          # [M,2]
    o_ur: torch.Tensor          # [M] (-1 mono)
    o_inv_sigma2: torch.Tensor  # [M]
    o_valid: torch.Tensor       # [M] bool


class BAProblemOL(NamedTuple):
    kf_ids: torch.Tensor        # [WF] i32 (window first; -1 pad)
    kf_fixed: torch.Tensor      # [WF] bool
    pt_ids: torch.Tensor        # [L] i32 (-1 pad, live points first)
    o_slot: torch.Tensor        # [O,L] i32 index into kf_ids (-1 invalid)
    o_kp: torch.Tensor          # [O,L] i32 keypoint in that keyframe
    o_col: torch.Tensor         # [O,L] i32 original pt_obs column (for erasure)
    o_uv: torch.Tensor          # [2,O,L]
    o_ur: torch.Tensor          # [O,L] (-1 mono)
    o_inv_sigma2: torch.Tensor  # [O,L]
    o_valid: torch.Tensor       # [O,L] bool
    o_povar: torch.Tensor       # [O,L] f32 1.0 where the observer pose varies


def _compact(mask: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [n] -> (ids [size] of set positions (-1 pad), count)."""
    return compact_ids(mask, size), torch.clamp(mask.sum(dtype=_I32), max=size)


class _Selection(NamedTuple):
    kf_ids: torch.Tensor     # [wk+fk] window first, then fixed (-1 pad)
    kf_fixed: torch.Tensor   # [wk+fk]
    pt_ids: torch.Tensor     # [l_pt] local points, live first (-1 pad)
    kf_slot: torch.Tensor    # [K] slot of each keyframe in kf_ids (-1 none)
    sees_local: torch.Tensor  # [K,N] the keypoint is bound to a local point
    wk: int


def _select(m: MapState, center_kf: int) -> _Selection:
    """The window (center + covisibles by weight), its local points and the
    fixed keyframes (other observers of those points)."""
    K = m.kf_valid.shape[0]
    P = m.pt_valid.shape[0]
    dev = m.kf_valid.device
    wk, fk, l_pt = min(W_KF, K), min(F_KF, K), min(L_PT, P)

    # window: center + covisibles by weight; JAX's argsort is stable
    w_row = m.covis[center_kf] * m.kf_valid.to(_I32)
    w_row = torch.where(torch.arange(K, device=dev) == center_kf, 1 << 20, w_row)
    order = torch.argsort(-w_row, stable=True)
    win_ids = torch.where(w_row[order][:wk] > 0, order[:wk], -1).to(_I32)
    in_window = scatter_or(K, win_ids.clamp(min=0), win_ids >= 0)

    # local points: observed by window keyframes
    rows_on = in_window[:, None] & (m.kf_mp >= 0) & m.kf_kp_valid
    pt_mask = scatter_or(P, torch.where(rows_on, m.kf_mp, P - 1), rows_on) & m.pt_valid
    pt_ids, _ = _compact(pt_mask, l_pt)
    in_local = scatter_or(P, pt_ids.clamp(min=0), pt_ids >= 0)

    # fixed keyframes: observers of local points outside the window
    sees_local = in_local[m.kf_mp.clamp(min=0).long()] & (m.kf_mp >= 0)
    fix_ids, _ = _compact(torch.any(sees_local, dim=1) & m.kf_valid & ~in_window, fk)
    kf_ids = torch.cat([win_ids, fix_ids])
    # gauge anchor: with no out-of-window observer, pin the lowest-id window KF
    has_fixed = torch.any(fix_ids >= 0)
    lowest = torch.argmin(torch.where(win_ids >= 0, win_ids, 1 << 30))
    kf_fixed = (torch.arange(wk + fk, device=dev) >= wk) | (
        (torch.arange(wk + fk, device=dev) == lowest) & ~has_fixed)
    return _Selection(kf_ids, kf_fixed, pt_ids, _slot_of(kf_ids, K), sees_local, wk)


def build_problem(m: MapState, center_kf: int, caps: MapCaps,
                  inv_level_sigma2: Optional[torch.Tensor] = None) -> BAProblem:
    """The flat problem: every (window or fixed keyframe, keypoint) bound to
    a local point, keyframe-major, compacted into ``N_OBS`` slots."""
    K, N = m.kf_mp.shape
    sel = _select(m, center_kf)
    pt_slot = _slot_of(sel.pt_ids, m.pt_valid.shape[0])
    obs_on = (sel.kf_slot[:, None] >= 0) & sel.sees_local
    o_lin = compact_ids(obs_on.reshape(-1), min(N_OBS, K * N))
    o_ok = o_lin >= 0
    o_k = torch.where(o_ok, torch.div(o_lin, N, rounding_mode="floor"), 0).long()
    o_n = torch.where(o_ok, o_lin % N, 0).long()
    octave = m.kf_octave[o_k, o_n]
    return BAProblem(
        kf_ids=sel.kf_ids, kf_fixed=sel.kf_fixed, pt_ids=sel.pt_ids,
        o_kf=torch.where(o_ok, sel.kf_slot[o_k], -1),
        o_pt=torch.where(o_ok, pt_slot[m.kf_mp[o_k, o_n].clamp(min=0).long()], -1),
        o_uv=m.kf_uv_und[o_k, o_n],
        o_ur=torch.where(o_ok, m.kf_u_right[o_k, o_n], -1.0),
        o_inv_sigma2=(1.0 / (1.2 ** (2.0 * octave.to(_F32))) if inv_level_sigma2 is None
                      else inv_level_sigma2[octave.long()]),
        o_valid=o_ok,
    )


def build_problem_ol(m: MapState, center_kf: int, caps: MapCaps,
                     inv_level_sigma2: Optional[torch.Tensor] = None) -> BAProblemOL:
    """Window/fixed/point selection; observations from the per-point
    observer lists (valid-first, capped at O_BA slots)."""
    dev = m.kf_valid.device
    sel = _select(m, center_kf)
    kf_ids, kf_fixed, pt_ids, kf_slot, wk = (sel.kf_ids, sel.kf_fixed, sel.pt_ids, sel.kf_slot,
                                             sel.wk)

    # observations from the observer lists, valid-first into O_BA slots
    pid = pt_ids.clamp(min=0).long()
    okf, okp = m.pt_obs_kf[pid], m.pt_obs_kp[pid]                # [L,O_map]
    okf_s, okp_s = okf.clamp(min=0).long(), okp.clamp(min=0).long()
    slot = torch.where(okf >= 0, kf_slot[okf_s], -1)
    valid_full = ((pt_ids >= 0)[:, None] & (okf >= 0) & (okp >= 0) & (slot >= 0)
                  & m.kf_kp_valid[okf_s, okp_s] & (m.kf_mp[okf_s, okp_s] == pid[:, None]))
    n_l, o_map = okf.shape
    o_ba = min(O_BA, o_map)
    # the r-th valid column of row p is the one whose running count is r:
    # scatter each column index into its rank slot (amax: order-free)
    rank = torch.cumsum(valid_full.to(_I32), dim=1) - 1
    rk = torch.where(valid_full & (rank < o_ba), rank, o_ba)
    flat = (torch.arange(n_l, device=dev)[:, None] * (o_ba + 1) + rk).reshape(-1)
    col = torch.zeros(n_l * (o_ba + 1), dtype=torch.long, device=dev)
    col.scatter_reduce_(0, flat, torch.arange(o_map, device=dev).expand(n_l, o_map).reshape(-1),
                        "amax", include_self=True)
    col = col.reshape(n_l, o_ba + 1)[:, :o_ba]
    valid_c = (rank.gather(1, col.clamp(max=o_map - 1))
               == torch.arange(o_ba, device=dev)[None]) & valid_full.gather(1, col)
    okf_c, okp_c, slot_c = okf_s.gather(1, col), okp_s.gather(1, col), slot.gather(1, col)

    octave = m.kf_octave[okf_c, okp_c]
    inv_sig2 = (1.0 / (1.2 ** (2.0 * octave.to(_F32))) if inv_level_sigma2 is None
                else inv_level_sigma2[octave.long()])
    uv = m.kf_uv_und[okf_c, okp_c]                               # [L,O,2]
    ur = torch.where(valid_c, m.kf_u_right[okf_c, okp_c], -1.0)
    slot_t = torch.where(valid_c, slot_c, -1).T.contiguous().to(_I32)
    valid_t = valid_c.T.contiguous()
    pose_var = (valid_t & (slot_t >= 0) & (slot_t < wk)
                & ~kf_fixed[slot_t.clamp(min=0).long()])
    return BAProblemOL(
        kf_ids=kf_ids, kf_fixed=kf_fixed, pt_ids=pt_ids, o_slot=slot_t,
        o_kp=okp_c.T.contiguous().to(_I32), o_col=col.T.contiguous().to(_I32),
        o_uv=uv.permute(2, 1, 0).contiguous(), o_ur=ur.T.contiguous(),
        o_inv_sigma2=inv_sig2.T.contiguous(), o_valid=valid_t, o_povar=pose_var.to(_F32),
    )


def _slot_of(ids: torch.Tensor, size: int) -> torch.Tensor:
    """ids [n] (distinct, -1 pad) -> [size] i32 position of each id in
    ``ids`` (-1 where absent); the pads land on a dump slot."""
    n = ids.shape[0]
    out = torch.full((size + 1,), -1, dtype=_I32, device=ids.device)
    out.index_put_((torch.where(ids >= 0, ids, size).long(),),
                   torch.arange(n, dtype=_I32, device=ids.device))
    return out[:size]


def _cam5(cam: Camera) -> torch.Tensor:
    return torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]).to(_F32)


def _lm_pass(poses0, points0, probs, cam5, active, use_huber: bool, iters: int, wk: int, n_pts,
             wcs, scratches, masks, mesh: ObsMesh):
    """One LM pass over the shards of the point axis -> (poses, points per
    shard, iterations run, Wc buffer per shard). ``probs``, ``points0``,
    ``active`` and the kernels' buffers are per shard: ``wcs``, ``scratches``
    and ``masks``, shared by the passes of one BA call; a shard's ``mask``
    also goes to every back-substitution (the rows of ``Wc`` it names follow
    ``slot`` and ``povar`` alone, so they are the same in every iteration).
    The pose-side sums and both costs are psum-reduced and the max of the
    point step pmax-reduced (``mesh``); the Cholesky solve runs once."""
    WF = probs[0].kf_ids.shape[0]
    dev = poses0.device
    obs = [(p.o_slot, p.o_uv[0], p.o_uv[1], p.o_ur, p.o_inv_sigma2, a.to(_F32))
           for p, a in zip(probs, active)]
    cam5s = mesh.replicate(cam5)
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    eye_w = torch.eye(wk, dtype=_F32, device=dev)
    eye_s = torch.eye(wk * 6, dtype=_F32, device=dev)
    nan = torch.full((), float("nan"), dtype=_F32, device=dev)
    lam = torch.full((), 1e-4, dtype=_F32, device=dev)
    poses, points, wcs, it = poses0, list(points0), list(wcs), 0
    shards = range(mesh.n_shards)
    while it < iters:
        lams, posesT = mesh.replicate(lam), mesh.replicate(poses.reshape(WF, 16).T.contiguous())
        acc = []
        for s in shards:
            with mesh.on(s):
                acc.append(ba_cuda.ba_accumulate(
                    lams[s], posesT[s], points[s].T.contiguous(), *obs[s], probs[s].o_povar,
                    cam5s[s], wk, use_huber, n_pts=n_pts[s], wc=wcs[s], scratch=scratches[s],
                    mask=masks[s]))
        Hpp36, bp, S_red, rhs_red, cost_old = (mesh.psum([a[i] for a in acc]) for i in range(5))
        wcs = [a[7] for a in acc]
        Hpp = Hpp36.reshape(wk, 6, 6) + lam * eye6
        S = torch.einsum("wij,wv->wivj", Hpp, eye_w) - S_red.reshape(wk, 6, wk, 6)
        rhs = bp - rhs_red.reshape(wk, 6)
        chol, info = torch.linalg.cholesky_ex(S.reshape(wk * 6, wk * 6) + 1e-7 * eye_s)
        chol = torch.where(info == 0, chol, nan)
        dx_pose = -torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(wk, 6)
        dx_poses = mesh.replicate(dx_pose.contiguous())
        dx_pt = []
        for s in shards:
            with mesh.on(s):
                dx_pt.append(ba_cuda.ba_backsub(wcs[s], acc[s][5], acc[s][6], dx_poses[s],
                                                n_pts=n_pts[s], mask=masks[s]))

        poses_new = torch.cat([lie.se3_exp(dx_pose) @ poses[:wk], poses[wk:]])
        points_new = [x + d.T for x, d in zip(points, dx_pt)]
        posesT_new = mesh.replicate(poses_new.reshape(WF, 16).T.contiguous())
        costs = []
        for s in shards:
            with mesh.on(s):
                costs.append(ba_cuda.ba_cost(posesT_new[s], points_new[s].T.contiguous(),
                                             *obs[s], cam5s[s], use_huber, n_pts=n_pts[s]))
        cost_new = mesh.psum(costs)
        c_old, c_new = cost_old[0, 0], cost_new[0, 0]
        improved = c_new < c_old
        poses = torch.where(improved, poses_new, poses)
        points = [torch.where(i, xn, x)
                  for i, xn, x in zip(mesh.replicate(improved), points_new, points)]
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e8))
        done = torch.maximum(dx_pose.abs().max(), mesh.pmax([d.abs().max() for d in dx_pt])) < 1e-7
        # Ceres-style function tolerance (1e-6 relative decrease)
        done = done | (improved & ((c_old - c_new) < 1e-6 * torch.clamp(c_old, min=1e-12)))
        it += 1
        if bool(done):  # host read: the loop's exit
            break
    return poses, points, it, wcs


def _classify_ol(poses, points, prob: BAProblemOL, cam5) -> torch.Tensor:
    """Inlier mask [O,L]: chi2 within the gate and positive depth."""
    WF = prob.kf_ids.shape[0]
    pc, _, e, stereo, _ = ba_pallas.observations(
        poses.reshape(WF, 16).T, points.T, prob.o_slot, prob.o_uv[0], prob.o_uv[1],
        prob.o_ur, cam5)
    e2 = e[0] ** 2 + e[1] ** 2
    chi2 = torch.where(stereo, e2 + e[2] ** 2, e2) * prob.o_inv_sigma2
    gate = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    return prob.o_valid & (chi2 <= gate) & (pc[2] > 0)


def _ba_iters(stop: Optional[bool]) -> Tuple[int, int]:
    return (0, 0) if stop else (5, 10)


def _shard_problem(prob: BAProblemOL, mesh: ObsMesh) -> List[BAProblemOL]:
    """The problem's point axis L split into the mesh's shards (the keyframe
    fields replicated), as the JAX package's ``P(None, ax)`` specs cut it."""
    fields = {}
    for name, x in prob._asdict().items():
        if name in ("kf_ids", "kf_fixed"):
            fields[name] = mesh.replicate(x)
        else:  # the point axis is last
            fields[name] = mesh.split(x, x.dim() - 1)
    return [BAProblemOL(**{k: v[s] for k, v in fields.items()}) for s in range(mesh.n_shards)]


def _ba_optimize(poses, points, prob: BAProblemOL, cam5, wk: int, it1: int, it2: int,
                 mesh: ObsMesh):
    """The two-pass LM optimization with the point axis split over ``mesh``
    -> (poses, points, final inliers, iterations of pass 1, of pass 2). The
    kernels take ``n_pts``, the live points at the front of their slice:
    live points come first in ``pt_ids``, so shard s holds
    clamp(n_pts - s L/n, 0, L/n) of them and the last shards may hold none."""
    n_pts = (prob.pt_ids >= 0).sum(dtype=_I32)
    L = prob.pt_ids.shape[0]
    if L % mesh.n_shards:
        raise ValueError(f"local BA: L={L} points not divisible by {mesh.n_shards} shards")
    Ls = L // mesh.n_shards
    probs = _shard_problem(prob, mesh)
    pts = mesh.split(points)
    if mesh.n_shards == 1:  # the one-device solver: no extra op
        n_pts_s = [n_pts]
    else:
        n_pts_s = [torch.clamp(n_pts - s * Ls, 0, Ls).to(dev)
                   for s, dev in enumerate(mesh.shard_devices)]
    scratches = [ba_cuda.ba_scratch(wk, Ls, dev) for dev in mesh.shard_devices]
    masks = [ba_cuda.ba_mask(Ls, dev) for dev in mesh.shard_devices]
    none = [None] * mesh.n_shards

    def classify(poses, pts):
        return [_classify_ol(P, X, p, c) for P, X, p, c in
                zip(mesh.replicate(poses), pts, probs, mesh.replicate(cam5))]

    poses, pts, n1, wcs = _lm_pass(poses, pts, probs, cam5, [p.o_valid for p in probs], True, it1,
                                   wk, n_pts_s, none, scratches, masks, mesh)
    inl = classify(poses, pts)
    poses, pts, n2, _ = _lm_pass(poses, pts, probs, cam5, inl, False, it2, wk, n_pts_s, wcs,
                                 scratches, masks, mesh)
    return (poses, mesh.gather(pts), mesh.gather(classify(poses, pts), 1), n1, n2)


def _local_ba_impl(m: MapState, center_kf: int, caps: MapCaps, cam: Camera,
                   inv_level_sigma2=None, stop: Optional[bool] = None,
                   mesh: Optional[ObsMesh] = None):
    # the reference's interruptBA: the stop flag is read at the solver's
    # ENTRY (optimizer_ceres.cpp:594 `if (stopFlag) return;`) and the whole
    # local BA (optimization, outlier erasure, write-back) is skipped
    if stop:
        return m, 0, 0
    return _local_ba_run(m, center_kf, caps, cam, inv_level_sigma2, mesh)


def _local_ba_run(m, center_kf, caps, cam, inv_level_sigma2, mesh: Optional[ObsMesh]):
    prob = build_problem_ol(m, center_kf, caps, inv_level_sigma2)
    poses = m.kf_pose[prob.kf_ids.clamp(min=0).long()]
    points = m.pt_pos[prob.pt_ids.clamp(min=0).long()]
    it1, it2 = _ba_iters(None)
    wk = min(W_KF, m.kf_valid.shape[0])
    if mesh is None:
        mesh = ObsMesh(1, [m.device])
    poses, points, final_inl, n1, n2 = _ba_optimize(poses, points, prob, _cam5(cam), wk, it1, it2,
                                                    mesh)
    return _ba_write_back(m, prob, poses, points, final_inl), n1, n2


def local_bundle_adjust(m: MapState, center_kf: int, caps: MapCaps, cam: Camera,
                        inv_level_sigma2=None, stop: Optional[bool] = None) -> MapState:
    """Run windowed local BA around ``center_kf`` and write the results into
    the map. ``stop`` (host bool): the reference's interruptBA, read at the
    solver's entry; raised, the map passes through untouched."""
    return _local_ba_impl(m, center_kf, caps, cam, inv_level_sigma2, stop)[0]


def local_bundle_adjust_iters(m: MapState, center_kf: int, caps: MapCaps, cam: Camera,
                              inv_level_sigma2=None, stop: Optional[bool] = None
                              ) -> Tuple[MapState, int, int]:
    """``local_bundle_adjust`` that also returns the LM iterations each pass
    ran, (0, 0) when ``stop`` is raised."""
    return _local_ba_impl(m, center_kf, caps, cam, inv_level_sigma2, stop)


def local_bundle_adjust_mesh(m: MapState, center_kf: int, caps: MapCaps, cam: Camera,
                             mesh: ObsMesh, inv_level_sigma2=None,
                             stop: Optional[bool] = None) -> MapState:
    """``local_bundle_adjust`` with the LM iterations sharded over ``mesh``:
    the point axis L of the [O, L] problem is split into ``mesh.n_shards``
    contiguous slices (L must divide), each shard runs the accumulate,
    back-substitution and cost kernels on its slice with its own buffers, and
    only the pose-side sums (Hpp, bp, the Schur reduction, its right side),
    the costs (psum) and the largest point step (pmax) cross shards. A point's
    observers all live in its own column, so every point-side term stays on
    its shard. The problem build, the entry check of ``stop`` and the
    write-back are ``local_bundle_adjust``'s. The result differs from it only
    in the rounding of the cross-shard sums."""
    return _local_ba_impl(m, center_kf, caps, cam, inv_level_sigma2, stop, mesh)[0]


def local_bundle_adjust_mesh_iters(m: MapState, center_kf: int, caps: MapCaps, cam: Camera,
                                   mesh: ObsMesh, inv_level_sigma2=None,
                                   stop: Optional[bool] = None) -> Tuple[MapState, int, int]:
    """``local_bundle_adjust_mesh`` that also returns the LM iterations each
    pass ran (each shard launches each kernel once per iteration)."""
    return _local_ba_impl(m, center_kf, caps, cam, inv_level_sigma2, stop, mesh)


def _ba_write_back(m: MapState, prob: BAProblemOL, poses, points, final_inl) -> MapState:
    """Window poses + point positions into the map; erase outlier edges.
    Masked lanes write to the scratch rows (keyframe K-1, point P-1, the last
    keypoint and observer column) carrying the value already there, as in
    the JAX package."""
    K, N = m.kf_mp.shape
    P, O = m.pt_obs_kf.shape
    win_ok = (prob.kf_ids >= 0) & ~prob.kf_fixed
    kf_rows = torch.where(win_ok, prob.kf_ids, K - 1).long()
    new_poses = torch.where(win_ok[:, None, None], lie.orthonormalize(poses), m.kf_pose[kf_rows])
    pt_ok = prob.pt_ids >= 0
    pt_rows = torch.where(pt_ok, prob.pt_ids, P - 1).long()
    new_pts = torch.where(pt_ok[:, None], points, m.pt_pos[pt_rows])

    # erase outlier observations (:757-789); o_col maps each BA slot back to
    # its pt_obs column
    bad = (prob.o_valid & ~final_inl).T                          # [L,O_BA]
    kf_global = prob.kf_ids[prob.o_slot.clamp(min=0).long()].T
    kf_w = torch.where(bad, kf_global, K - 1).long()
    kp_w = torch.where(bad, prob.o_kp.T, N - 1).long()
    pid = prob.pt_ids.clamp(min=0).long()
    prow = torch.where(bad, pid[:, None], P - 1)
    pcol = torch.where(bad, prob.o_col.T, O - 1).long()
    cnt = scatter_add(m.pt_obs_cnt, pid, -bad.sum(dim=1, dtype=_I32))
    # obs<=2 -> point erased, only for touched points (mappoint.cpp:353)
    low = scatter_or(P, pid, torch.any(bad, dim=1)) & (cnt <= 2)
    return m.replace(
        kf_pose=scatter_set(m.kf_pose, kf_rows, new_poses),
        pt_pos=scatter_set(m.pt_pos, pt_rows, new_pts),
        kf_mp=scatter_set(m.kf_mp, (kf_w, kp_w), torch.where(bad, -1, m.kf_mp[kf_w, kp_w])),
        pt_obs_kf=scatter_set(m.pt_obs_kf, (prow, pcol),
                              torch.where(bad, -1, m.pt_obs_kf[prow, pcol])),
        pt_obs_kp=scatter_set(m.pt_obs_kp, (prow, pcol),
                              torch.where(bad, -1, m.pt_obs_kp[prow, pcol])),
        pt_obs_cnt=cnt,
        pt_valid=m.pt_valid & ~low,
    )
