"""BoW-bucketed keyframe-to-frame descriptor matching (port of
``vo_slam_test_tpu/matching/bow_match.py``).

Matcher::searchByBoW (matcher.cpp:449-559): candidates share a vocabulary
node (the featVec bucket), the keyframe side carries a live map point and the
frame side is free; best <= TH_LOW, best < ratio * second best, then the
rotation-consistency filter. One dense masked Hamming matrix, the bucket
restriction a group-id equality mask; the JAX package computes it in XLA
outside any Pallas kernel, and so does this port (``ops/hamming.py``'s matmul
form, exact with TF32 off).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import hamming
from ..slam_map.map_state import winner_per_target
from . import rotation

TH_LOW = 50
BIG = 1 << 20


class BowMatchResult(NamedTuple):
    assign: torch.Tensor  # [N_frame] i32 map-point id (-1 none)
    count: torch.Tensor   # i32
    src_kp: torch.Tensor  # [N_frame] i32 matched keyframe keypoint (-1 none)


def search_by_bow_kf_frame(
    kf_desc: torch.Tensor,      # [N,8] keyframe descriptors
    kf_groups: torch.Tensor,    # [N] i32 featVec node id (-1 invalid)
    kf_mp: torch.Tensor,        # [N] i32 map point per keyframe kp (-1 none)
    kf_angle: torch.Tensor,
    kf_pt_valid: torch.Tensor,  # [N] bool: the bound map point is alive
    f_desc: torch.Tensor,       # [M,8] frame descriptors
    f_groups: torch.Tensor,     # [M] i32
    f_angle: torch.Tensor,
    f_valid: torch.Tensor,      # [M]
    ratio: float,
    check_rot: bool = True,
) -> BowMatchResult:
    src_ok = (kf_mp >= 0) & kf_pt_valid & (kf_groups >= 0)
    tgt_ok = f_valid & (f_groups >= 0)
    allowed = (kf_groups[:, None] == f_groups[None, :]) & src_ok[:, None] & tgt_ok[None, :]

    D = torch.where(allowed, hamming.distance_matrix(kf_desc, f_desc), BIG)
    best = torch.argmin(D, dim=1)  # the first minimum, as jnp.argmin
    best_d = torch.gather(D, 1, best[:, None])[:, 0]
    second_d = D.scatter(1, best[:, None], BIG).min(dim=1).values
    matched = (best_d <= TH_LOW) & (best_d.to(torch.float32) < ratio * second_d.to(torch.float32))
    if check_rot:
        bins = rotation.rotation_bins(kf_angle, f_angle[best])
        matched = rotation.rotation_consistency_mask(bins, matched)

    # one source per frame keypoint: the last (highest) writer wins
    winner = winner_per_target(torch.where(matched, best, -1), f_desc.shape[0])
    assign = torch.where(winner >= 0, kf_mp[winner.clamp(min=0).long()], -1)
    return BowMatchResult(assign=assign, count=matched.sum(dtype=torch.int32), src_kp=winner)
