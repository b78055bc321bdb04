"""Drift injection: the instrument of the loop-closure scenarios (port of
``vo_slam_test_tpu/utils/drift.py``).

Revisiting a place after a long excursion presents the loop closer with two
mutually inconsistent map islands: the old one, and a new one displaced by
accumulated drift, every cross-island association long since culled.
Synthetic sequences track too well to accumulate that drift, so the
scenarios inject it: one rigid transform applied to everything created after
a cut keyframe, with the cross-island links severed as culling would sever
them. Projections are invariant under the transform (T' X' = T D^-1 D X =
T X), so tracking continues in the drifted island, and the loop closer must
detect the revisit by BoW and recover D as the closure's Sim3.

The edit is device ops only, with the cut as a slot number, so it reads
nothing back to the host. Its semantics are those of the JAX package's
``inject_drift`` and of ``tests/test_loop_e2e.py::drift_island``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..slam_map.map_state import MapState


def inject_drift(m: MapState, assign_real: torch.Tensor, kf_cut: int, D: torch.Tensor
                 ) -> Tuple[MapState, torch.Tensor]:
    """Rigidly move every keyframe created at or after the keyframe in slot
    ``kf_cut``, and every point whose reference keyframe is one of them, by
    the world-side drift D (p' = D p, T' = T D^-1), and sever every link
    between the islands.

    Island membership follows creation order, not slots: keyframes by
    kf_seq >= kf_seq[kf_cut] (culling recycles slots), points by pt_ref_kf.
    Severed: island keyframes' bindings to old points (kf_mp), island
    observers of old points (pt_obs_*), island <-> old covisibility (so old
    keyframes qualify as loop candidates, the reference's connected-keyframe
    exclusion, loopClosing.cpp:78-85) and the tracker's last-frame bindings
    to old points (``assign_real``). Spanning-tree parents stay: drift
    accumulates along the tree in the reference too, and the essential graph
    relies on the seam edge's pre-drift measurement.

    D: [4,4] rigid world-side drift on the map's device -> (map, the
    tracker's new ``assign_real``)."""
    K = m.kf_valid.shape[0]
    P = m.pt_valid.shape[0]
    D = D.to(torch.float32)
    D_inv = torch.linalg.inv_ex(D)[0]
    cut_seq = m.kf_seq[min(max(int(kf_cut), 0), K - 1)]
    kf_sel = (m.kf_seq >= cut_seq) & m.kf_valid
    ref = m.pt_ref_kf
    pt_sel = (ref >= 0) & kf_sel[ref.clamp(0, K - 1).long()] & m.pt_valid

    new_poses = torch.where(kf_sel[:, None, None], m.kf_pose @ D_inv, m.kf_pose)
    new_pts = torch.where(pt_sel[:, None], m.pt_pos @ D[:3, :3].T + D[:3, 3], m.pt_pos)

    bound_old = (m.kf_mp >= 0) & ~pt_sel[m.kf_mp.clamp(0, P - 1).long()]
    kf_mp = torch.where(kf_sel[:, None] & bound_old, -1, m.kf_mp)
    obs_kf = m.pt_obs_kf
    obs_cross = ((obs_kf >= 0) & kf_sel[obs_kf.clamp(0, K - 1).long()] & ~pt_sel[:, None])

    new_cnt = torch.clamp(m.pt_obs_cnt - obs_cross.sum(1, dtype=torch.int32), min=0)
    covis = torch.where(kf_sel[:, None] ^ kf_sel[None, :], 0, m.covis)
    new_m = m.replace(
        kf_pose=new_poses, pt_pos=new_pts, kf_mp=kf_mp,
        pt_obs_kf=torch.where(obs_cross, -1, obs_kf),
        pt_obs_kp=torch.where(obs_cross, -1, m.pt_obs_kp), pt_obs_cnt=new_cnt, covis=covis)
    stale = (assign_real >= 0) & ~pt_sel[assign_real.clamp(0, P - 1).long()]
    return new_m, torch.where(stale, -1, assign_real)
