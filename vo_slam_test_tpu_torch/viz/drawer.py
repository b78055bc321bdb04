"""Headless visualization and per-frame metrics (port of
``vo_slam_test_tpu/viz/drawer.py``, the reference Drawer's equivalent).

The reference Drawer (drawer.cpp) renders a live Pangolin window: map points,
keyframe frusta, covisibility (green) / spanning-tree (red) / loop (blue)
edges, and an OpenCV HUD. Here the same content renders to PNGs (matplotlib
for the map and trajectories, PIL for the HUD, both imported only when a
render is asked for), and per-frame tracking metrics go to a CSV.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MapSnapshot:
    """Host-side copy of the drawable map content."""

    kf_poses: np.ndarray        # [K,4,4] T_c_w of valid keyframes
    points: np.ndarray          # [P,3] valid map point positions
    covis_edges: np.ndarray     # [E,2] keyframe index pairs (weight>=15)
    tree_edges: np.ndarray      # [E,2] spanning-tree pairs
    loop_edges: np.ndarray      # [E,2]


def snapshot_map(map_state) -> MapSnapshot:
    """A drawable snapshot of a MapState, read to the host."""
    host = {k: getattr(map_state, k).cpu().numpy()
            for k in ("kf_valid", "kf_pose", "pt_pos", "pt_valid", "covis", "parent", "loop_edges")}
    kf_valid = host["kf_valid"]
    kf_ids = np.nonzero(kf_valid)[0]
    remap = {int(k): i for i, k in enumerate(kf_ids)}
    poses = host["kf_pose"][kf_ids]
    pts = host["pt_pos"][host["pt_valid"]]

    covis = host["covis"]
    ce = []
    for a in kf_ids:
        for b in kf_ids:
            if b > a and covis[a, b] >= 15:  # drawer edge threshold (keyframe covisibles)
                ce.append((remap[int(a)], remap[int(b)]))
    parent = host["parent"]
    te = [
        (remap[int(k)], remap[int(parent[k])])
        for k in kf_ids
        if parent[k] >= 0 and kf_valid[parent[k]]
    ]
    loops = host["loop_edges"]
    le = [
        (remap[int(a)], remap[int(b)])
        for a in kf_ids for b in kf_ids
        if b > a and loops[a, b]
    ]
    as2 = lambda e: np.asarray(e, np.int64).reshape(-1, 2)
    return MapSnapshot(
        kf_poses=poses, points=pts,
        covis_edges=as2(ce), tree_edges=as2(te), loop_edges=as2(le),
    )


def _centers(poses: np.ndarray) -> np.ndarray:
    """Camera centers from T_c_w poses."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("kji,kj->ki", R, t)


def plot_map(snap: MapSnapshot, path: str, title: str = "map") -> None:
    """Top-down (x-z) map render with the reference's edge color coding."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    if snap.points.size:
        ax.scatter(snap.points[:, 0], snap.points[:, 2], s=0.5, c="black", alpha=0.3, label="map points")
    c = _centers(snap.kf_poses)
    for (a, b) in snap.covis_edges:
        ax.plot([c[a, 0], c[b, 0]], [c[a, 2], c[b, 2]], c="green", lw=0.5, alpha=0.5)
    for (a, b) in snap.tree_edges:
        ax.plot([c[a, 0], c[b, 0]], [c[a, 2], c[b, 2]], c="red", lw=0.8)
    for (a, b) in snap.loop_edges:
        ax.plot([c[a, 0], c[b, 0]], [c[a, 2], c[b, 2]], c="blue", lw=1.5)
    ax.scatter(c[:, 0], c[:, 2], s=15, c="red", marker="s", label="keyframes")
    ax.set_xlabel("x [m]"); ax.set_ylabel("z [m]")
    ax.set_title(title); ax.axis("equal"); ax.legend(loc="best", fontsize=8)
    fig.tight_layout(); fig.savefig(path, dpi=120); plt.close(fig)


def plot_trajectories(
    path: str,
    est_T_w_c: np.ndarray,
    gt_T_w_c: Optional[np.ndarray] = None,
    title: str = "trajectory",
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    e = est_T_w_c[:, :3, 3]
    ax.plot(e[:, 0], e[:, 2], c="tab:blue", label="estimate")
    if gt_T_w_c is not None:
        g = gt_T_w_c[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], c="tab:gray", ls="--", label="ground truth")
    ax.set_xlabel("x [m]"); ax.set_ylabel("z [m]")
    ax.set_title(title); ax.axis("equal"); ax.legend()
    fig.tight_layout(); fig.savefig(path, dpi=120); plt.close(fig)


def save_metrics_csv(path: str, timestamps: Sequence[float], stats: Sequence) -> None:
    """Per-frame tracking metrics (features/matches/inliers/state)."""
    with open(path, "w") as f:
        f.write("timestamp,ok,n_features,n_matches,n_inliers\n")
        for t, s in zip(timestamps, stats):
            f.write(f"{t:.6f},{int(s.ok)},{s.n_features},{s.n_matches},{s.n_inliers}\n")


# ---------------------------------------------------------------------------
# Per-frame HUD (the reference Drawer::drawCurrFrameImg, drawer.cpp:368-459):
# green box+dot per map-tracked keypoint, blue box+dot per VO-tracked
# keypoint, and a status line with the tracked counts.
# ---------------------------------------------------------------------------

_HUD_STATES = {0: "NOT READY", 1: "INITIALIZING", 2: "OK", 3: "LOST"}


def draw_hud_frame(
    gray: np.ndarray,
    kp_uv: np.ndarray,
    kp_state: np.ndarray,
    ok: bool,
    frame_id: int = -1,
    r: int = 5,
) -> np.ndarray:
    """Render the tracking HUD onto a gray frame; returns [H,W,3] u8.

    kp_state: 0 untracked, 1 map-tracked (green), 2 VO-tracked (blue) —
    the inMapFlag/inVOFlag split of drawer.cpp:430-459."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.asarray(gray, np.uint8), "L").convert("RGB")
    d = ImageDraw.Draw(img)
    colors = {1: (0, 255, 0), 2: (65, 105, 225)}
    n_map = n_vo = 0
    H, W = gray.shape[:2]
    for (u, v), s in zip(np.asarray(kp_uv), np.asarray(kp_state)):
        if s not in colors or not (0 <= u < W and 0 <= v < H):
            continue
        c = colors[int(s)]
        d.rectangle([u - r, v - r, u + r, v + r], outline=c)
        d.ellipse([u - 2, v - 2, u + 2, v + 2], fill=c)
        if s == 1:
            n_map += 1
        else:
            n_vo += 1
    state = "OK" if ok else "LOST"
    text = (f"frame {frame_id}  {state}  map tracked: {n_map}  "
            f"vo tracked: {n_vo}")
    # status bar appended below the image (drawTextOnImg composes a text
    # strip under the frame)
    bar = Image.new("RGB", (img.width, 22), (20, 20, 20))
    ImageDraw.Draw(bar).text((6, 4), text, fill=(240, 240, 240))
    out = Image.new("RGB", (img.width, img.height + bar.height))
    out.paste(img, (0, 0))
    out.paste(bar, (0, img.height))
    return np.asarray(out)


def save_hud_frames(
    out_dir: str,
    grays,
    outs,
    every: int = 1,
) -> int:
    """Write hud_%05d.png for every `every`-th frame; returns count. ``outs``
    holds per-frame host outputs with ``kp_uv``, ``kp_state`` and ``ok``."""
    import os

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for i, (g, o) in enumerate(zip(grays, outs)):
        if i % every:
            continue
        img = draw_hud_frame(
            g, np.asarray(o.kp_uv), np.asarray(o.kp_state),
            bool(np.asarray(o.ok)), frame_id=i,
        )
        Image.fromarray(img).save(os.path.join(out_dir, f"hud_{i:05d}.png"))
        n += 1
    return n
