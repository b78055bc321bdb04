"""BoW scoring and relocalization candidates over the dense keyframe set
(port of ``vo_slam_test_tpu/bow/retrieval.py``).

The query scores against every keyframe at once (one searchsorted and masked
reductions) in place of the reference's inverted-index walk; the L1 score is
Map::score's (map.cpp:335-376), and ``reloc_candidates`` is the cascade of
map.cpp:101-208 (shared-word counts, the 0.8 * max cut, covisible-group
scores, the 0.75 * best-group cut); ``loop_candidates`` is its loop form
(map.cpp:210-333).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..slam_map.map_state import pick, scatter_or
from ..utils import graphs

PAD_WORD = 1 << 30  # sort-to-the-end sentinel for word arrays


def bow_vector(words: torch.Tensor, idf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint word ids [N] (-1 invalid) -> (sorted unique words [N]
    padded with PAD_WORD, L1-normalized tf-idf weights [N]).

    A word's weight is its idf summed once per keypoint that holds it. Every
    addend of one word's sum is the same value, so ``index_add_`` gives the
    same bits whatever order its atomic adds take on the card (and the JAX
    package's sequential ``segment_sum``'s bits)."""
    N = words.shape[0]
    w = torch.where(words >= 0, words, PAD_WORD)
    sw = torch.sort(w).values
    valid = sw < PAD_WORD
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=w.device), sw[1:] != sw[:-1]])
    first = first & valid
    gid = torch.cumsum(first.to(torch.int64), 0) - 1
    seg = torch.where(valid, gid, N)
    contrib = torch.where(valid, idf[sw.clamp(0, idf.shape[0] - 1).long()], 0.0)
    sums = torch.zeros((N + 1,), dtype=torch.float32, device=w.device).index_add_(0, seg, contrib)
    uniq = torch.full((N + 1,), PAD_WORD, dtype=torch.int32, device=w.device)
    uniq = uniq.scatter(0, torch.where(first, gid, N), sw)[:N]
    total = torch.clamp(contrib.sum(), min=1e-12)
    return uniq, sums[:N] / total


def scores_vs_keyframes(uniq_q: torch.Tensor, wgt_q: torch.Tensor, kf_bow_word: torch.Tensor,
                        kf_bow_weight: torch.Tensor, kf_valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (L1 scores [K], shared-word counts [K]) of the query against every
    keyframe; ``kf_valid`` [K] f32 (0 or 1)."""
    N = uniq_q.shape[0]
    pos = torch.searchsorted(uniq_q, kf_bow_word).clamp(0, N - 1)
    hit = (uniq_q[pos] == kf_bow_word) & (kf_bow_word < PAD_WORD)
    vq = torch.where(hit, wgt_q[pos], 0.0)
    vk = torch.where(hit, kf_bow_weight, 0.0)
    term = 0.5 * (torch.abs(vq) + torch.abs(vk) - torch.abs(vq - vk))
    score = term.sum(1) * kf_valid
    shared = hit.sum(1, dtype=torch.int32) * kf_valid.to(torch.int32)
    return score, shared


def _top10_covisibles(covis: torch.Tensor, kf_valid: torch.Tensor) -> torch.Tensor:
    """[K,10] neighbour indices (self-padded when fewer)."""
    w = torch.where(kf_valid[None, :], covis, 0)
    order = torch.argsort(-w, dim=1, stable=True)[:, :10]
    has = torch.gather(w, 1, order) > 0
    self_ids = torch.arange(covis.shape[0], device=covis.device)[:, None].expand(order.shape)
    return torch.where(has, order, self_ids)


def reloc_candidates(scores: torch.Tensor, shared: torch.Tensor, covis: torch.Tensor,
                     kf_valid: torch.Tensor) -> torch.Tensor:
    """Relocalization candidate mask [K] (map.cpp:101-208)."""
    K = scores.shape[0]
    sharing = (shared > 0) & kf_valid
    max_common = torch.where(sharing, shared, 0).max()
    min_common = 0.8 * max_common.to(torch.float32)
    selected = sharing & (shared.to(torch.float32) > min_common)

    nb = _top10_covisibles(covis, kf_valid)           # [K,10]
    nb_score = torch.where(sharing[nb], scores[nb], 0.0)
    group_score = scores + nb_score.sum(1)
    # best member of each group (self vs sharing neighbours)
    cand_scores = torch.cat([scores[:, None], nb_score], 1)  # [K,11]
    cand_ids = torch.cat([torch.arange(K, device=scores.device)[:, None], nb], 1)
    best_member = torch.gather(cand_ids, 1, torch.argmax(cand_scores, 1, keepdim=True))[:, 0]

    best_group = torch.where(selected, group_score, 0.0).max()
    passing = selected & (group_score > 0.75 * best_group)
    return scatter_or(K, best_member, passing) & kf_valid


def loop_candidates(scores: torch.Tensor, shared: torch.Tensor, covis: torch.Tensor,
                    kf_valid: torch.Tensor, query_kf, min_score: torch.Tensor) -> torch.Tensor:
    """Loop candidate mask [K] (map.cpp:210-333): the relocalization cascade
    with the query's connected keyframes excluded and candidates scoring at
    least ``min_score`` (the query's worst covisible score)."""
    K = scores.shape[0]
    ids = torch.arange(K, device=scores.device)
    query_kf = graphs.on_device(query_kf, torch.int64, covis.device)
    connected = pick(covis, query_kf) > 0
    eligible = kf_valid & ~connected & (ids != query_kf)
    sharing = (shared > 0) & eligible
    max_common = torch.where(sharing, shared, 0).max()
    min_common = 0.8 * max_common.to(torch.float32)
    selected = sharing & (shared.to(torch.float32) > min_common) & (scores >= min_score)

    nb = _top10_covisibles(covis, kf_valid)
    nb_score = torch.where(sharing[nb], scores[nb], 0.0)
    group_score = scores + nb_score.sum(1)
    cand_scores = torch.cat([scores[:, None], nb_score], 1)
    cand_ids = torch.cat([ids[:, None], nb], 1)
    best_member = torch.gather(cand_ids, 1, torch.argmax(cand_scores, 1, keepdim=True))[:, 0]

    best_group = torch.where(selected, group_score, 0.0).max()
    passing = selected & (group_score > 0.75 * best_group)
    return scatter_or(K, best_member, passing) & eligible
