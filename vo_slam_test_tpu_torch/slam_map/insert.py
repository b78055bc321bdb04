"""Keyframe insertion, map-point spawning and point refresh (port of
``vo_slam_test_tpu/slam_map/insert.py``).

The reference's createNewKeyFrame point spawning (visualOdometry.cpp:463-517),
KeyFrame construction, observation attachment (localMapping.cpp:100-130),
updateNormalAndDepth / computeDescriptor (mappoint.cpp:86-179) and the
covisibility/spanning-tree update of updateConnections (keyframe.cpp:69-152),
as dense masked tensor updates.

The JAX package gates the insert with ``lax.cond`` on a device bool and
writes at a device slot index. Eager, ``insert_keyframe`` reads that bool and
the new slot id back in one host read and inserts with the slot as a Python
int; in ``select`` mode and in a captured graph (``utils.graphs``) it is the
JAX package's predicated insert, with the slot, the timestamp and the frame
id as device tensors and nothing read back.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .. import lie
from ..camera import Camera
from ..frontend.frame import FrameFeatures
from ..ops import hamming
from ..utils import graphs
from .map_state import (MapCaps, MapState, add_observations, covis_row_for, first_true, pick,
                        scatter_add, scatter_or, scatter_set)

Index = Union[int, torch.Tensor]  # a Python int, or a 0-d integer tensor on the map's device


def row_at(arr: torch.Tensor, i: Index) -> torch.Tensor:
    """``arr[i]`` for a Python int or a 0-d index tensor (``pick``: indexing
    with a 0-d tensor on the card reads it back)."""
    return pick(arr, i) if isinstance(i, torch.Tensor) else arr[i]


def with_row(arr: torch.Tensor, i: Index, val) -> torch.Tensor:
    """Copy of ``arr`` with ``arr[i] = val``; ``i`` a Python int or a 0-d
    index tensor, ``val`` a tensor or a Python scalar (filled on the device:
    writing a Python scalar through ``__setitem__`` copies it from the
    host)."""
    out = arr.clone()
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).long()
        if isinstance(val, torch.Tensor):
            out.index_copy_(0, idx, val.to(arr.dtype).expand(arr.shape[1:]).reshape(
                (1,) + arr.shape[1:]))
        else:
            out.index_fill_(0, idx, val)
    elif isinstance(val, torch.Tensor):
        out[i] = val
    else:
        out[i].fill_(val)
    return out


def with_cross(arr: torch.Tensor, i: Index, row_val) -> torch.Tensor:
    """Copy of a [K,K] table with row ``i`` and column ``i`` set to
    ``row_val`` (a [K] tensor, or a scalar)."""
    out = arr.clone()
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).long()
        if isinstance(row_val, torch.Tensor):
            r = row_val.to(arr.dtype)
            out.index_copy_(0, idx, r[None, :])
            out.index_copy_(1, idx, r[:, None])
        else:
            out.index_fill_(0, idx, row_val)
            out.index_fill_(1, idx, row_val)
    elif isinstance(row_val, torch.Tensor):
        out[i, :] = row_val
        out[:, i] = row_val
    else:
        out[i, :].fill_(row_val)
        out[:, i].fill_(row_val)
    return out


def norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, summed in order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])


def allocate_point_slots(m: MapState, want: torch.Tensor) -> torch.Tensor:
    """want [n] bool -> point slot ids [n] (-1 when the map is full). The
    r-th requested slot gets the r-th invalid row; row P-1 stays reserved as
    the scatter dump target."""
    P = m.pt_valid.shape[0]
    n = want.shape[0]
    dev = want.device
    free = torch.cat([~m.pt_valid[:-1], torch.zeros(1, dtype=torch.bool, device=dev)])
    fpos = torch.cumsum(free.to(torch.int32), 0) - 1
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    table.index_put_((torch.where(free & (fpos < n), fpos, n).long(),),
                     torch.arange(P, dtype=torch.int32, device=dev))
    rank = torch.cumsum(want.to(torch.int32), 0) - 1
    ids = table[:n][rank.clamp(0, n - 1).long()]
    return torch.where(want, ids, -1)


def spawn_mask_depth_sorted(feats: FrameFeatures, already_real: torch.Tensor, th_depth
                            ) -> torch.Tensor:
    """Which keypoints spawn new map points at KF creation
    (visualOdometry.cpp:479-515): by ascending depth, where the slot has no
    observed map point, stopping once depth > thDepth and 101 spawned."""
    d = feats.depth
    can = (d > 0) & feats.valid & ~already_real
    key = torch.where(can, d, torch.inf)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0], device=d.device))
    return can & ((d <= th_depth) | (rank <= 100))


def insert_keyframe(
    m: MapState,
    caps: MapCaps,
    feats: FrameFeatures,
    T_c_w: torch.Tensor,
    timestamp: float,
    frame_id: int,
    assign: torch.Tensor,
    create_mask: torch.Tensor,
    cam: Camera,
    scale_factors: torch.Tensor,
    words: torch.Tensor = None,
    bow_word: torch.Tensor = None,
    bow_weight: torch.Tensor = None,
    do=None,
) -> Tuple[MapState, int]:
    """Returns (new map, kf_id); kf_id = -1 (map untouched) when ``do`` is
    False or every slot is live. ``do``: None, a Python bool or a device
    bool. The insert runs under ``graphs.cond`` at the slot ``graphs.fetch``
    gives: eager, one host read (the insert flag and the slot id together)
    unless ``do`` is the Python bool False, and kf_id is a Python int; in
    ``select``/``capture`` mode the JAX package's predicated insert at a
    device slot, kf_id a 0-d int32 tensor, and ``timestamp`` and
    ``frame_id`` may be device tensors (a graph's static inputs)."""
    if do is False:
        return m, -1
    K = m.kf_valid.shape[0]
    can = (m.n_kf < K) | torch.any(~m.kf_valid)
    if isinstance(do, torch.Tensor):
        can = can & do
    kf_id_t = torch.where(m.n_kf < K, torch.clamp(m.n_kf, max=K - 1),
                          first_true(~m.kf_valid, 0)).to(torch.int32)
    go, kf_id = graphs.fetch(can, kf_id_t)
    m = graphs.cond(go, lambda m: _insert_keyframe(
        m, caps, feats, T_c_w, timestamp, frame_id, assign, create_mask, cam, scale_factors,
        words, bow_word, bow_weight, kf_id), lambda m: m, (m,), name="kf_insert")
    return m, graphs.where(go, kf_id, -1)


def _insert_keyframe(m, caps, feats, T_c_w, timestamp, frame_id, assign, create_mask, cam,
                     scale_factors, words, bow_word, bow_weight, kf_id: Index):
    N = caps.n_feat
    P = caps.max_pt
    K = m.kf_valid.shape[0]
    dev = m.device

    # ---- keyframe record ---------------------------------------------------
    m = m.replace(
        kf_pose=with_row(m.kf_pose, kf_id, T_c_w),
        kf_valid=with_row(m.kf_valid, kf_id, True),
        kf_gen=with_row(m.kf_gen, kf_id, row_at(m.kf_gen, kf_id) + 1),
        kf_seq=with_row(m.kf_seq, kf_id, m.n_kf_ever),
        n_kf_ever=m.n_kf_ever + 1,
        loop_edges=with_cross(m.loop_edges, kf_id, False),
        kf_timestamp=with_row(m.kf_timestamp, kf_id, _host_or_tensor(timestamp, float)),
        kf_frame_id=with_row(m.kf_frame_id, kf_id, _host_or_tensor(frame_id, int)),
        kf_uv_und=with_row(m.kf_uv_und, kf_id, feats.uv_und),
        kf_octave=with_row(m.kf_octave, kf_id, feats.octave),
        kf_angle=with_row(m.kf_angle, kf_id, feats.angle),
        kf_depth=with_row(m.kf_depth, kf_id, feats.depth),
        kf_u_right=with_row(m.kf_u_right, kf_id, feats.u_right),
        kf_desc=with_row(m.kf_desc, kf_id, feats.desc),
        kf_kp_valid=with_row(m.kf_kp_valid, kf_id, feats.valid),
    )
    if words is not None:
        m = m.replace(
            kf_word=with_row(m.kf_word, kf_id, words),
            kf_bow_word=with_row(m.kf_bow_word, kf_id, bow_word),
            kf_bow_weight=with_row(m.kf_bow_weight, kf_id, bow_weight),
        )

    # ---- spawn new points --------------------------------------------------
    create = create_mask & feats.valid & (assign < 0)
    new_ids = allocate_point_slots(m, create)
    in_cap = create & (new_ids >= 0)
    rows = torch.where(in_cap, new_ids, P - 1).long()

    ow = lie.se3_inverse(T_c_w)[:3, 3]
    depth_safe = torch.where(feats.depth > 0, feats.depth, 1.0)
    pw = cam.pixel2world(feats.uv_und, depth_safe, T_c_w)  # [N,3]
    line = pw - ow
    dist = norm3(line)
    normal = line / torch.clamp(dist, min=1e-9)[:, None]
    max_d = dist * scale_factors[feats.octave.long()]       # mappoint.cpp:112
    min_d = max_d / scale_factors[-1]

    def put(arr, vals):
        keep = in_cap[:, None] if vals.dim() > 1 else in_cap
        return scatter_set(arr, rows, torch.where(keep, vals, arr[rows]))

    m = m.replace(
        pt_pos=put(m.pt_pos, pw),
        pt_normal=put(m.pt_normal, normal),
        pt_desc=put(m.pt_desc, feats.desc),
        pt_min_dist=put(m.pt_min_dist, min_d),
        pt_max_dist=put(m.pt_max_dist, max_d),
        pt_ref_kf=put(m.pt_ref_kf, torch.zeros_like(m.pt_ref_kf[rows]) + kf_id),
        pt_valid=put(m.pt_valid, torch.ones_like(in_cap)),
        pt_gen=scatter_add(m.pt_gen, rows, in_cap.to(torch.int32)),
        pt_found=put(m.pt_found, torch.ones_like(m.pt_found[rows])),
        pt_visible=put(m.pt_visible, torch.ones_like(m.pt_visible[rows])),
        n_pt=torch.clamp(m.n_pt + in_cap.sum(dtype=torch.int32), max=P),
    )

    # ---- kf_mp row + observations -----------------------------------------
    row = torch.where(assign >= 0, assign, torch.where(in_cap, rows.to(torch.int32), -1))
    m = m.replace(kf_mp=with_row(m.kf_mp, kf_id, row))
    kp_ids = torch.arange(N, dtype=torch.int32, device=dev)
    m = add_observations(m, row.clamp(min=0), kf_id, kp_ids, row >= 0)

    # ---- covisibility + spanning tree -------------------------------------
    member = scatter_or(P, row.clamp(min=0), row >= 0)
    w = with_row(covis_row_for(m, member), kf_id, 0)
    m = m.replace(covis=with_cross(m.covis, kf_id, w))
    best = torch.argmax(w)
    parent = torch.where((w.max() > 0) & (kf_id > 0), best.to(torch.int32), -1)
    m = m.replace(parent=with_row(m.parent, kf_id, parent),
                  n_kf=torch.clamp(m.n_kf + 1, max=K))

    # ---- refresh normals/depth/descriptor of touched pre-existing points --
    touched = scatter_or(P, assign.clamp(min=0), assign >= 0)
    return refresh_points(m, touched, scale_factors)


def _host_or_tensor(v, cast):
    """A per-frame value: a device tensor passes through, a host value is
    cast (``float``/``int``)."""
    return v if isinstance(v, torch.Tensor) else cast(v)


MAX_REFRESH = 2048  # touched points per refresh call (a KF touches <= ~1k)


def refresh_points(m: MapState, mask: torch.Tensor, scale_factors: torch.Tensor) -> MapState:
    """updateNormalAndDepth + computeDescriptor for masked points, on a
    compacted subset of <= MAX_REFRESH points: the normal is the mean unit
    ray from the observing camera centres, the distance band comes from the
    ref-KF observation, and the representative descriptor minimizes the
    median Hamming distance to the other observations."""
    P, O = m.pt_obs_kf.shape
    S = MAX_REFRESH
    dev = m.device
    sel_mask = mask & m.pt_valid
    pos = torch.cumsum(sel_mask.to(torch.int32), 0) - 1
    slot = torch.where(sel_mask & (pos < S), pos, S).long()
    ids = torch.full((S + 1,), P - 1, dtype=torch.int32, device=dev)
    ids.index_put_((slot,), torch.arange(P, dtype=torch.int32, device=dev))
    ids = ids[:S].long()
    live = torch.zeros(S + 1, dtype=torch.bool, device=dev)
    live.index_put_((slot,), sel_mask)
    live = live[:S]

    obs_kf = m.pt_obs_kf[ids]       # [S,O]
    obs_kp = m.pt_obs_kp[ids]
    pt_pos = m.pt_pos[ids]
    pt_ref = m.pt_ref_kf[ids]
    obs_valid = obs_kf >= 0
    safe_kf = obs_kf.clamp(min=0).long()
    poses = m.kf_pose[safe_kf]      # [S,O,4,4]
    Rt = poses[..., :3, :3].transpose(-1, -2)
    centers = -torch.einsum("poij,poj->poi", Rt, poses[..., :3, 3])
    rays = pt_pos[:, None, :] - centers
    ray_norm = torch.clamp(norm3(rays), min=1e-9)
    unit = rays / ray_norm[..., None]
    cnt = torch.clamp(obs_valid.to(torch.float32).sum(dim=1), min=1.0)
    normal = torch.where(obs_valid[..., None], unit, 0.0).sum(dim=1) / cnt[:, None]

    # ref-KF distance + octave -> scale band
    is_ref = obs_kf == pt_ref[:, None]
    ref_slot = first_true(is_ref, 1)
    has_ref = torch.any(is_ref, dim=1)
    ref_dist = torch.gather(ray_norm, 1, ref_slot[:, None])[:, 0]
    ref_kp = torch.gather(obs_kp, 1, ref_slot[:, None])[:, 0]
    ref_oct = m.kf_octave[pt_ref.clamp(min=0).long(), ref_kp.clamp(min=0).long()]
    max_d = ref_dist * scale_factors[ref_oct.long()]
    min_d = max_d / scale_factors[-1]

    # representative descriptor: min median pairwise distance
    descs = m.kf_desc[safe_kf, obs_kp.clamp(min=0).long()]  # [S,O,8]
    D = hamming.distance_matrix(descs, descs)               # [S,O,O]
    pair_ok = obs_valid[:, :, None] & obs_valid[:, None, :]
    D = torch.where(pair_ok, D, 1 << 14)
    Ds = torch.sort(D, dim=-1).values
    n_obs = obs_valid.sum(dim=1, dtype=torch.int32)
    mid_idx = torch.clamp((0.5 * (n_obs[:, None] - 1)).to(torch.int32), 0, O - 1)
    med = torch.gather(Ds, 2, mid_idx[:, :, None].expand(S, O, 1).long())[:, :, 0]
    med = torch.where(obs_valid, med, 1 << 14)
    best_row = torch.argmin(med, dim=1)
    best_desc = torch.gather(descs, 1, best_row[:, None, None].expand(S, 1, 8))[:, 0, :]

    upd = live & (n_obs > 0)
    rows = torch.where(upd, ids, P - 1)

    def keep(new, old, cond):
        return torch.where(cond[:, None] if new.dim() > 1 else cond, new, old)

    return m.replace(
        pt_normal=scatter_set(m.pt_normal, rows, keep(normal, m.pt_normal[rows], upd)),
        pt_max_dist=scatter_set(m.pt_max_dist, rows, keep(max_d, m.pt_max_dist[rows], upd & has_ref)),
        pt_min_dist=scatter_set(m.pt_min_dist, rows, keep(min_d, m.pt_min_dist[rows], upd & has_ref)),
        pt_desc=scatter_set(m.pt_desc, rows, keep(best_desc, m.pt_desc[rows], upd)),
    )
