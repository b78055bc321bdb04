"""Binary bag-of-words vocabulary as dense per-level arrays (port of
``vo_slam_test_tpu/bow/vocabulary.py``, the DBoW3 role: frame.cpp:249-254,
map.cpp:60-376).

A k-branch, L-level tree is one centroid array per level ([k^(l+1), 8], int32
bit patterns on the device); the children of node n are n*k .. n*k+k-1, and
words are the leaves. ``transform`` descends all descriptors at once: per
level one gather of the k child centroids and a popcount argmin.

``build_vocabulary`` (hierarchical binary k-means), ``synth_vocabulary`` (the
ORBvoc shape with random centroids) and the DBoW2/3 text reader and writer
are the JAX package's numpy code, copied: the same seed gives the same tree.
``save``/``load`` use the JAX package's ``.npz`` layout (centroids as uint32),
so a file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops import hamming


@dataclasses.dataclass(eq=False)
class Vocabulary:
    k: int                          # branching factor
    levels: int                     # depth (words live at this level)
    centroids: List[torch.Tensor]   # level l: [k^(l+1), 8] int32 (level 0 = first split)
    idf: torch.Tensor               # [k^levels] f32 word weights
    node_valid: List[torch.Tensor]  # level l: [k^(l+1)] bool

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    @property
    def device(self) -> torch.device:
        return self.idf.device

    def to(self, device) -> "Vocabulary":
        """This vocabulary's arrays on ``device`` (itself when already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return Vocabulary(k=self.k, levels=self.levels,
                          centroids=[c.to(device) for c in self.centroids],
                          idf=self.idf.to(device), node_valid=[v.to(device) for v in self.node_valid])

    @classmethod
    def from_numpy(cls, k: int, levels: int, centroids, idf, node_valid,
                   device: Optional[Union[str, torch.device]] = None) -> "Vocabulary":
        """Arrays with the JAX layout (centroids uint32) -> a Vocabulary on
        ``device`` (None: the card)."""
        dev = resolve_device(device)
        cents = [torch.as_tensor(np.array(c, dtype=np.uint32).view(np.int32)).to(dev)
                 for c in centroids]
        return cls(k=int(k), levels=int(levels), centroids=cents,
                   idf=torch.as_tensor(np.array(idf, dtype=np.float32)).to(dev),
                   node_valid=[torch.as_tensor(np.array(v, dtype=bool)).to(dev)
                               for v in node_valid])

    def to_numpy(self) -> dict:
        """The JAX layout: centroids uint32 per level, idf, node_valid."""
        return dict(k=self.k, levels=self.levels,
                    centroids=[c.cpu().numpy().view(np.uint32) for c in self.centroids],
                    idf=self.idf.cpu().numpy(),
                    node_valid=[v.cpu().numpy() for v in self.node_valid])

    def save(self, path: str) -> None:
        a = self.to_numpy()
        data = {"k": self.k, "levels": self.levels, "idf": a["idf"]}
        for i, (c, v) in enumerate(zip(a["centroids"], a["node_valid"])):
            data[f"c{i}"] = c
            data[f"v{i}"] = v
        np.savez_compressed(path, **data)

    @classmethod
    def load(cls, path: str, device: Optional[Union[str, torch.device]] = None) -> "Vocabulary":
        z = np.load(path)
        k = int(z["k"])
        levels = int(z["levels"])
        return cls.from_numpy(k, levels, [z[f"c{i}"] for i in range(levels)], z["idf"],
                              [z[f"v{i}"] for i in range(levels)], device)


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[N,8] int32 descriptors -> [N] int32 word ids (-1 for invalid slots);
    DBoW3 Vocabulary::transform as frame.cpp:249-254 uses it."""
    N = desc.shape[0]
    node = torch.zeros((N,), dtype=torch.int64, device=desc.device)
    kids = torch.arange(voc.k, dtype=torch.int64, device=desc.device)
    for lvl in range(voc.levels):
        child_ids = node[:, None] * voc.k + kids[None, :]                  # [N,k]
        d = hamming.hamming(voc.centroids[lvl][child_ids], desc[:, None, :])  # [N,k]
        d = torch.where(voc.node_valid[lvl][child_ids], d, 1 << 20)
        node = torch.gather(child_ids, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return torch.where(valid, node.to(torch.int32), -1)


def feature_groups(voc: Vocabulary, words: torch.Tensor, levels_up: int = 3) -> torch.Tensor:
    """Word ids -> featVec bucket ids ``levels_up`` levels above the leaves
    (frame.cpp:253 passes 3); a vocabulary of at most ``levels_up`` levels
    collapses to the root, as DBoW does."""
    shift = min(levels_up, voc.levels)
    return torch.where(words >= 0, torch.div(words, voc.k ** shift, rounding_mode="floor"), -1)


# ---------------------------------------------------------------------------
# DBoW2/3 text interchange (ORBvoc.txt)
# ---------------------------------------------------------------------------


def _open_text(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)


def load_dbow_text(path: str, device: Optional[Union[str, torch.device]] = None) -> Vocabulary:
    """Load a DBoW2/DBoW3 text vocabulary (ORBvoc.txt[.gz]).

    Header ``k L scoring_type weighting_type``, then one line per node (the
    root, node 0, is implicit): ``parent_id is_leaf byte0 .. byte31 weight``.
    Node i is line i+1 and parents precede children. A leaf above the final
    level is carried down a chain of child 0 so that every word lives at the
    final level; word ids are dense-tree positions."""
    with _open_text(path) as f:
        header = f.readline().split()
        k, levels, scoring, weighting = (int(header[0]), int(header[1]),
                                         int(header[2]), int(header[3]))
        if scoring != 0 or weighting != 0:
            raise ValueError(
                f"only L1 scoring / TF-IDF weighting supported (got {scoring},{weighting})")
        table = np.loadtxt(f, dtype=np.float64, ndmin=2)
    n_nodes = table.shape[0]
    parent = table[:, 0].astype(np.int64)
    is_leaf = table[:, 1] != 0
    desc = table[:, 2:34].astype(np.uint8).copy().view("<u4").reshape(n_nodes, 8)
    weight = table[:, 34].astype(np.float32)

    # node ids are 1-based in file order (root = 0, implicit)
    node_parent = np.concatenate([[0], parent]).astype(np.int64)
    depth = np.full(n_nodes + 1, -1, np.int64)
    depth[0] = 0
    for _ in range(levels):
        upd = (depth == -1) & (depth[node_parent] >= 0)
        depth[upd] = depth[node_parent[upd]] + 1
    if (depth[1:] == -1).any():
        raise ValueError("vocabulary deeper than its declared level count")

    # sibling rank: order of appearance among same-parent nodes
    order = np.argsort(node_parent[1:], kind="stable")
    ranks = np.empty(n_nodes, np.int64)
    sorted_par = node_parent[1:][order]
    new_grp = np.concatenate([[True], sorted_par[1:] != sorted_par[:-1]])
    grp_start = np.maximum.accumulate(np.where(new_grp, np.arange(n_nodes), 0))
    ranks[order] = np.arange(n_nodes) - grp_start
    if (ranks >= k).any():
        raise ValueError("node with more than k children")

    # dense position per node, level by level (parents precede children)
    dense = np.zeros(n_nodes + 1, np.int64)
    for d in range(1, levels + 1):
        sel = depth[1:] == d
        dense[1:][sel] = dense[node_parent[1:][sel]] * k + ranks[sel]

    centroids = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(levels)]
    valid = [np.zeros((k ** (l + 1),), bool) for l in range(levels)]
    idf = np.zeros(k ** levels, np.float32)
    for d in range(1, levels + 1):
        sel = depth[1:] == d
        centroids[d - 1][dense[1:][sel]] = desc[sel]
        valid[d - 1][dense[1:][sel]] = True

    # leaves: words at the final level; shallow leaves chain down child 0
    leaf_dense = dense[1:][is_leaf]
    leaf_depth = depth[1:][is_leaf]
    leaf_desc = desc[is_leaf]
    leaf_w = weight[is_leaf]
    for i in range(leaf_dense.shape[0]):
        dpos, ddep = int(leaf_dense[i]), int(leaf_depth[i])
        while ddep < levels:
            dpos *= k
            centroids[ddep][dpos] = leaf_desc[i]
            valid[ddep][dpos] = True
            ddep += 1
        idf[dpos] = leaf_w[i]
    return Vocabulary.from_numpy(k, levels, centroids, idf, valid, device)


def save_dbow_text(voc: Vocabulary, path: str) -> None:
    """Write the DBoW2/3 text format (``load_dbow_text``'s inverse; L1/TF-IDF)."""
    k, levels = voc.k, voc.levels
    a = voc.to_numpy()
    cents, valid, idf = a["centroids"], a["node_valid"], a["idf"]
    # file node ids: BFS over valid dense nodes
    file_id = [np.full(v.shape[0], -1, np.int64) for v in valid]
    next_id = 1
    for l in range(levels):
        ids = np.nonzero(valid[l])[0]
        file_id[l][ids] = np.arange(next_id, next_id + ids.size)
        next_id += ids.size
    with _open_text(path, "wt") as f:
        f.write(f"{k} {levels} 0 0\n")
        for l in range(levels):
            for dpos in np.nonzero(valid[l])[0]:
                par = 0 if l == 0 else int(file_id[l - 1][dpos // k])
                # leaf = a final-level node, or one with no valid children
                if l == levels - 1:
                    leaf, w = True, float(idf[dpos])
                else:
                    kids = valid[l + 1][dpos * k: dpos * k + k]
                    leaf, w = not kids.any(), 0.0
                by = np.ascontiguousarray(cents[l][dpos]).view(np.uint8)
                f.write(f"{par} {1 if leaf else 0} " + " ".join(str(int(b)) for b in by)
                        + f" {w}\n")


# ---------------------------------------------------------------------------
# creation: hierarchical binary k-means (map.cpp:60-99 capability)
# ---------------------------------------------------------------------------


def _majority_centroids(desc_bits: np.ndarray, assign: np.ndarray, n_clusters: int) -> np.ndarray:
    """Majority vote per bit. desc_bits [M,256] u8, assign [M] -> [C,256]."""
    sums = np.zeros((n_clusters, 256), np.int64)
    np.add.at(sums, assign, desc_bits.astype(np.int64))
    counts = np.bincount(assign, minlength=n_clusters)[:, None]
    return (sums * 2 > counts).astype(np.uint8)


def _pack(bits: np.ndarray) -> np.ndarray:
    """[..., 256] {0,1} -> [..., 8] u32 in the descriptors' bit order."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)


def _unpack(words: np.ndarray) -> np.ndarray:
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[:-1] + (256,)).astype(np.uint8)


def synth_vocabulary(k: int = 10, levels: int = 6, seed: int = 0,
                     idf_range: Tuple[float, float] = (2.0, 8.0),
                     device: Optional[Union[str, torch.device]] = None) -> Vocabulary:
    """ORBvoc-shaped vocabulary with random centroids (k=10, L=6: 10^6 words,
    vo_run.cpp:86-90): the full per-frame transform and retrieval workload
    without a trained file; it has no place-recognition power."""
    rng = np.random.default_rng(seed)
    cents = [rng.integers(0, 2**32, (k ** (l + 1), 8), dtype=np.uint32) for l in range(levels)]
    valids = [np.ones((k ** (l + 1),), bool) for l in range(levels)]
    idf = rng.uniform(idf_range[0], idf_range[1], k ** levels).astype(np.float32)
    return Vocabulary.from_numpy(k, levels, cents, idf, valids, device)


def build_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 4, iters: int = 8,
                     seed: int = 0, device: Optional[Union[str, torch.device]] = None
                     ) -> Vocabulary:
    """Hierarchical binary k-means over [M,8] descriptors (uint32, or int32
    bit patterns). Deterministic for a seed: candidate retrieval depends on
    the vocabulary, and runs must be reproducible."""
    descriptors = np.ascontiguousarray(descriptors).view(np.uint32)
    rng = np.random.default_rng(seed)
    M = descriptors.shape[0]
    bits = _unpack(descriptors)  # [M,256]

    assign = np.zeros(M, np.int64)  # node id at current level
    centroids: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    for lvl in range(levels):
        n_parent = k ** lvl
        n_child = k ** (lvl + 1)
        child_assign = np.zeros(M, np.int64)
        cents = np.zeros((n_child, 8), np.uint32)
        valid = np.zeros(n_child, bool)
        # each parent's descriptors in ascending index order (a stable sort
        # by parent): one sort per level, not one scan of all M per parent
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_parent + 1))
        for p in np.nonzero(bounds[1:] > bounds[:-1])[0]:
            sel = order[bounds[p]: bounds[p + 1]]
            sub = descriptors[sel]
            kk = min(k, sel.size)
            # k-means++ style seeding: first random, rest farthest
            seeds = [sub[rng.integers(sel.size)]]
            dmin = None
            for _ in range(1, kk):
                D = np.unpackbits((sub ^ seeds[-1][None]).view(np.uint8), axis=1).sum(1)
                dmin = D if dmin is None else np.minimum(dmin, D)
                seeds.append(sub[int(np.argmax(dmin))])
            cent = np.stack(seeds)
            sub_bits = bits[sel]
            a = np.zeros(sel.size, np.int64)
            for _ in range(iters):
                Dm = np.stack(
                    [np.unpackbits((sub ^ c[None]).view(np.uint8), axis=1).sum(1) for c in cent],
                    axis=1)
                a_new = Dm.argmin(1)
                if (a_new == a).all():
                    a = a_new
                    break
                a = a_new
                cent = _pack(_majority_centroids(sub_bits, a, kk).astype(np.uint8))
            cents[p * k: p * k + kk] = cent
            valid[p * k: p * k + kk] = True
            child_assign[sel] = p * k + a
        assign = child_assign
        centroids.append(cents)
        valids.append(valid)

    # idf weights (DBoW3 TF_IDF default): log(M / n_i)
    counts = np.bincount(assign, minlength=k ** levels).astype(np.float64)
    idf = np.where(counts > 0, np.log(max(M, 1) / np.maximum(counts, 1)), 0.0)
    return Vocabulary.from_numpy(k, levels, centroids, idf.astype(np.float32), valids, device)
