"""Quad-tree spatial keypoint distribution on the host (port of
``vo_slam_test_tpu/frontend/distribute.py``, numpy on both sides).

A replica of ORB-SLAM2's DistributeOctTree (ORBextractor.cpp:545-769):
integer node corners (cvRound of the root splits, ceil halving), child
assignment by strict ``<``, pass-snapshot splitting with largest-first
finishing rounds that stop as soon as the node count reaches the target (so
up to target + 2 nodes), and the no-progress stop. Equal-count nodes are
ordered by insertion (a stable sort), where the reference orders them by heap
pointer. It runs on the ~2-3k compact candidates of a frame per level.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class _Node:
    # integer corners, coordinates relative to the (min_x, min_y) origin
    x0: int
    x1: int
    y0: int
    y1: int
    idx: np.ndarray  # candidate indices inside this node
    no_more: bool = False


def _split(node: _Node, xs: np.ndarray, ys: np.ndarray) -> List[_Node]:
    """DivideNode (ORBextractor.cpp:495-540): ceil halving, strict <."""
    half_x = -((node.x0 - node.x1) // 2)  # ceil((x1-x0)/2) on ints
    half_y = -((node.y0 - node.y1) // 2)
    mx = node.x0 + half_x
    my = node.y0 + half_y
    x = xs[node.idx]
    y = ys[node.idx]
    left = x < mx
    top = y < my
    quads = [
        _Node(node.x0, mx, node.y0, my, node.idx[left & top]),
        _Node(mx, node.x1, node.y0, my, node.idx[~left & top]),
        _Node(node.x0, mx, my, node.y1, node.idx[left & ~top]),
        _Node(mx, node.x1, my, node.y1, node.idx[~left & ~top]),
    ]
    out = []
    for q in quads:
        if q.idx.size == 0:
            continue
        q.no_more = q.idx.size == 1
        out.append(q)
    return out


def distribute_octtree(
    xs: np.ndarray,
    ys: np.ndarray,
    responses: np.ndarray,
    min_x: float,
    max_x: float,
    min_y: float,
    max_y: float,
    target: int,
) -> np.ndarray:
    """Returns indices of the retained candidates (<= target + 2)."""
    n = xs.size
    if n == 0:
        return np.empty(0, dtype=np.int64)

    rx = xs - min_x
    ry = ys - min_y
    w = max_x - min_x
    h = max_y - min_y
    n_ini = max(int(round(w / max(h, 1e-9))), 1)
    hx = w / n_ini
    all_idx = np.arange(n, dtype=np.int64)
    # vpIniNodes[kp.pt.x/hX]: float division truncated by the array index
    bucket = np.clip((rx / hx).astype(np.int64), 0, n_ini - 1)
    h_int = int(round(h))

    leaves: List[_Node] = []        # bNoMore nodes (never split again)
    expand: List[_Node] = []        # current splittable nodes
    for i in range(n_ini):
        idx = all_idx[bucket == i]
        if idx.size == 0:
            continue
        nd = _Node(
            int(round(hx * i)), int(round(hx * (i + 1))), 0, h_int,
            idx, no_more=idx.size == 1,
        )
        (leaves if nd.no_more else expand).append(nd)

    def total() -> int:
        return len(leaves) + len(expand)

    finished = total() >= target
    while not finished and expand:
        prev_size = total()
        # one full pass: split every splittable node (snapshot semantics)
        next_expand: List[_Node] = []
        for nd in expand:
            for ch in _split(nd, rx, ry):
                (leaves if ch.no_more else next_expand).append(ch)
        expand = next_expand
        if total() >= target or total() == prev_size:
            break
        if total() + 3 * len(expand) > target:
            # finishing rounds: sort the previous pass's expandable
            # children by size (stable; reference tie-break is pointer
            # order, see module docstring), split largest-first, stop as
            # soon as the count reaches the target
            while True:
                prev_size = total()
                current = sorted(expand, key=lambda nd: nd.idx.size)
                expand = []
                remaining = len(current)  # unsplit nodes still in lNodes
                stop = False
                for nd in reversed(current):
                    if stop:
                        expand.append(nd)  # unsplit remainder stays
                        continue
                    remaining -= 1  # nd is erased on split
                    for ch in _split(nd, rx, ry):
                        (leaves if ch.no_more else expand).append(ch)
                    if total() + remaining >= target:
                        stop = True
                if total() >= target or total() == prev_size:
                    finished = True
                    break

    nodes = leaves + expand
    out = np.empty(len(nodes), dtype=np.int64)
    for i, nd in enumerate(nodes):
        r = responses[nd.idx]
        out[i] = nd.idx[int(np.argmax(r))]
    return out
