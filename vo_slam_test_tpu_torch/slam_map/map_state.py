"""Device-resident SLAM map as padded struct-of-tensors (port of
``vo_slam_test_tpu/slam_map/map_state.py``).

Fixed capacities (``MapCaps``), the same fields, dtypes and layouts as the JAX
package's ``MapState`` (descriptors as int32 bit patterns, see
``frontend/frame.py``). Updates are out of place, like the JAX package's: each
function returns a new ``MapState`` and never writes into its argument.

Scatter conventions, kept from the JAX package: masked-out lanes of a
``.at[].set`` write to a scratch slot (point ``P-1``, which
``insert.allocate_point_slots`` never hands out, or keyframe row ``K-1``) and
carry the value already there, so duplicate writes agree. ``.at[].max`` on a
bool mask and ``.at[].add`` become ``index_add_`` on int32, which gives the
same result in any order on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..frontend.frame import MAX_FEATURES


@dataclasses.dataclass(frozen=True)
class MapCaps:
    """Static capacities."""

    max_kf: int = 256
    max_pt: int = 24576
    max_obs: int = 24           # per-point observer slots
    n_feat: int = MAX_FEATURES  # keypoints per keyframe


@dataclasses.dataclass
class MapState:
    # -- keyframes ----------------------------------------------------------
    kf_pose: torch.Tensor       # [K,4,4] T_c_w
    kf_valid: torch.Tensor      # [K] bool
    kf_timestamp: torch.Tensor  # [K] f32
    kf_frame_id: torch.Tensor   # [K] i32
    kf_uv_und: torch.Tensor     # [K,N,2]
    kf_octave: torch.Tensor     # [K,N] i32
    kf_angle: torch.Tensor      # [K,N] f32
    kf_depth: torch.Tensor      # [K,N] f32 (-1 none)
    kf_u_right: torch.Tensor    # [K,N] f32 (-1 none)
    kf_desc: torch.Tensor       # [K,N,8] i32 bit patterns
    kf_kp_valid: torch.Tensor   # [K,N] bool
    kf_mp: torch.Tensor         # [K,N] i32 map-point id per keypoint (-1 none)
    # -- bag of words -------------------------------------------------------
    kf_word: torch.Tensor       # [K,N] i32 (-1)
    kf_bow_word: torch.Tensor   # [K,N] i32 (PAD_WORD pad)
    kf_bow_weight: torch.Tensor  # [K,N] f32
    # -- covisibility / spanning tree --------------------------------------
    covis: torch.Tensor         # [K,K] i32 shared-point counts
    parent: torch.Tensor        # [K] i32 (-1 root)
    kf_tcp: torch.Tensor        # [K,4,4] pose relative to parent at cull time
    cull_parent: torch.Tensor   # [K] i32
    kf_gen: torch.Tensor        # [K] i32 slot generation
    kf_seq: torch.Tensor        # [K] i32 insertion sequence number
    cull_parent_gen: torch.Tensor  # [K] i32
    cull_gen: torch.Tensor      # [K] i32
    loop_edges: torch.Tensor    # [K,K] bool
    # -- map points ---------------------------------------------------------
    pt_pos: torch.Tensor        # [P,3] f32
    pt_normal: torch.Tensor     # [P,3] f32
    pt_desc: torch.Tensor       # [P,8] i32 bit patterns
    pt_min_dist: torch.Tensor   # [P] f32
    pt_max_dist: torch.Tensor   # [P] f32
    pt_ref_kf: torch.Tensor     # [P] i32
    pt_obs_kf: torch.Tensor     # [P,O] i32 (-1 empty)
    pt_obs_kp: torch.Tensor     # [P,O] i32
    pt_obs_cnt: torch.Tensor    # [P] i32
    pt_found: torch.Tensor      # [P] i32
    pt_visible: torch.Tensor    # [P] i32
    pt_valid: torch.Tensor      # [P] bool
    pt_gen: torch.Tensor        # [P] i32
    # -- allocators (0-d i32) ------------------------------------------------
    n_kf: torch.Tensor
    n_pt: torch.Tensor
    n_kf_ever: torch.Tensor

    def replace(self, **kw) -> "MapState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.kf_valid.device


def empty_map(caps: MapCaps, device) -> MapState:
    K, P, O, N = caps.max_kf, caps.max_pt, caps.max_obs, caps.n_feat
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dtype=f32):
        return torch.full(shape, v, dtype=dtype, device=device)

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    eye = torch.eye(4, dtype=f32, device=device)
    return MapState(
        kf_pose=eye.repeat(K, 1, 1), kf_valid=zeros((K,), torch.bool), kf_timestamp=zeros((K,)),
        kf_frame_id=full((K,), -1, i32), kf_uv_und=zeros((K, N, 2)), kf_octave=zeros((K, N), i32),
        kf_angle=zeros((K, N)), kf_depth=full((K, N), -1.0), kf_u_right=full((K, N), -1.0),
        kf_desc=zeros((K, N, 8), i32), kf_kp_valid=zeros((K, N), torch.bool),
        kf_mp=full((K, N), -1, i32), kf_word=full((K, N), -1, i32),
        kf_bow_word=full((K, N), 1 << 30, i32), kf_bow_weight=zeros((K, N)),
        covis=zeros((K, K), i32), parent=full((K,), -1, i32), kf_tcp=eye.repeat(K, 1, 1),
        cull_parent=full((K,), -1, i32), kf_gen=zeros((K,), i32), kf_seq=full((K,), -1, i32),
        cull_parent_gen=full((K,), -1, i32), cull_gen=full((K,), -1, i32),
        loop_edges=zeros((K, K), torch.bool),
        pt_pos=zeros((P, 3)), pt_normal=zeros((P, 3)), pt_desc=zeros((P, 8), i32),
        pt_min_dist=zeros((P,)), pt_max_dist=zeros((P,)), pt_ref_kf=full((P,), -1, i32),
        pt_obs_kf=full((P, O), -1, i32), pt_obs_kp=full((P, O), -1, i32),
        pt_obs_cnt=zeros((P,), i32), pt_found=zeros((P,), i32), pt_visible=zeros((P,), i32),
        pt_valid=zeros((P,), torch.bool), pt_gen=zeros((P,), i32),
        n_kf=zeros((), i32), n_pt=zeros((), i32), n_kf_ever=zeros((), i32),
    )


# ---------------------------------------------------------------------------
# scatter helpers (the JAX package's .at[] idioms)
# ---------------------------------------------------------------------------


def scatter_or(size: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``zeros(size, bool).at[idx].max(mask)``: True where any masked lane
    lands (order-free on the card)."""
    hits = torch.zeros(size, dtype=torch.int32, device=idx.device)
    hits.index_add_(0, idx.reshape(-1).long(), mask.reshape(-1).to(torch.int32))
    return hits > 0


def winner_per_target(idx: torch.Tensor, n_tgt: int) -> torch.Tensor:
    """Source matches ``idx`` [N_src] (-1 none) -> [n_tgt] int32 source per
    target (-1 none), the highest source index among several (the
    reference's last overwrite; ``.at[].max`` in the JAX package)."""
    matched = idx >= 0
    src_ids = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    winner = torch.full((n_tgt + 1,), -1, dtype=torch.int32, device=idx.device)
    winner.scatter_reduce_(0, torch.where(matched, idx, n_tgt).long(),
                           torch.where(matched, src_ids, -1), "amax", include_self=True)
    return winner[:n_tgt]


def scatter_add(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].add(vals)`` along the first axis."""
    return arr.index_add(0, idx.reshape(-1).long(), vals.reshape((-1,) + arr.shape[1:]).to(arr.dtype))


def scatter_set(arr: torch.Tensor, idx, vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(vals)``; ``idx`` is one index tensor or a tuple
    (one per leading axis). Where several lanes hit one position the last
    lane wins, as in the JAX package's serial CPU scatter; the losing lanes
    are sent to a scratch row, so the result is the same on the card, where
    ``index_put_`` picks an arbitrary writer among duplicates."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = torch.broadcast_tensors(*[i.long() for i in idx])
    lead, rest = arr.shape[:len(idx)], arr.shape[len(idx):]
    n_lead = 1
    flat = torch.zeros_like(idx[0])
    for i, dim in zip(idx, lead):
        flat = flat * dim + i
        n_lead *= dim
    flat = flat.reshape(-1)
    lane = torch.arange(flat.shape[0], device=arr.device)
    last = torch.full((n_lead,), -1, dtype=torch.long, device=arr.device)
    last.scatter_reduce_(0, flat, lane, "amax", include_self=True)
    pos = torch.where(last[flat] == lane, flat, n_lead)
    ext = torch.cat([arr.reshape((n_lead,) + rest), arr.new_zeros((1,) + rest)])
    ext.index_put_((pos,), torch.broadcast_to(vals, idx[0].shape + rest)
                   .reshape((-1,) + rest).to(arr.dtype))
    return ext[:n_lead].reshape(arr.shape)


def compact_ids(mask: torch.Tensor, size: int) -> torch.Tensor:
    """[n] bool -> [size] i32: the indices of the first ``size`` True
    entries in order, -1 padded (the dump slot ``size`` is sliced away)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=mask.device)
    out.index_put_((slot.long(),), torch.arange(n, dtype=torch.int32, device=mask.device))
    return out[:size]


def pick(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` for a 0-d index tensor, without reading the index back to
    the host (indexing with a 0-d CUDA tensor synchronizes)."""
    return arr.index_select(0, idx.reshape(1).long())[0]


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """``argmax`` of a bool tensor along ``dim`` (first True; 0 when none).
    torch's argmax takes no bool input."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


# ---------------------------------------------------------------------------
# primitive update helpers
# ---------------------------------------------------------------------------


def add_observations(m: MapState, pt_ids: torch.Tensor, kf_id, kp_ids: torch.Tensor,
                     mask: torch.Tensor) -> MapState:
    """Append (kf_id, kp) to each point's observer list in its first free
    slot; at most one new observation per point per call. Observations
    beyond the slot cap are dropped; the count still increments."""
    P, O = m.pt_obs_kf.shape
    safe_pt = torch.where(mask, pt_ids, P - 1).long()
    free = m.pt_obs_kf[safe_pt] < 0  # [n, O]
    slot = first_true(free, 1)
    in_cap = mask & torch.any(free, dim=1)
    row = torch.where(in_cap, safe_pt, P - 1)
    col = torch.where(in_cap, slot, O - 1)
    obs_kf = scatter_set(m.pt_obs_kf, (row, col),
                         torch.where(in_cap, kf_id, m.pt_obs_kf[row, col]))
    obs_kp = scatter_set(m.pt_obs_kp, (row, col),
                         torch.where(in_cap, kp_ids.to(torch.int32), m.pt_obs_kp[row, col]))
    cnt = scatter_add(m.pt_obs_cnt, safe_pt, mask.to(torch.int32))
    return m.replace(pt_obs_kf=obs_kf, pt_obs_kp=obs_kp, pt_obs_cnt=cnt)


def covis_row_for(m: MapState, pt_member: torch.Tensor) -> torch.Tensor:
    """[P] bool membership -> [K] shared-point counts against every KF."""
    safe = m.kf_mp.clamp(min=0).long()
    shared = pt_member[safe] & (m.kf_mp >= 0)  # [K,N]
    return shared.sum(dim=1, dtype=torch.int32) * m.kf_valid.to(torch.int32)
