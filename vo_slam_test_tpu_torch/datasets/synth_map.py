"""Synthetic filled MapState (port of ``tools/synth_map.py``).

Builds a consistent map without a SlamSystem run: V valid keyframes on a
smooth trajectory, Q valid points, each observed by a run of consecutive
keyframes, kf_mp bindings and pt_obs_* lists mutually consistent,
covisibility from shared counts. The numpy code and its random draws are the
JAX package's tool's, so the same caps and seed give the same map field for
field; the arrays then go to the port's ``MapState`` on ``device``.

``span_max=24`` with ``n_kf=40`` gives a window whose covisibles, local
points and observer lists exceed every cap of ``solvers/local_ba.py`` (the
saturation regime).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..camera import Camera
from ..config import SlamConfig
from ..slam_map.map_state import MapCaps, MapState, empty_map


def build(caps: MapCaps = MapCaps(), n_kf: int = 40, n_pt: int = 8000, seed: int = 0,
          span_max: int = 7,
          device: Optional[Union[str, torch.device]] = None) -> Tuple[MapState, Camera]:
    """-> (MapState, Camera) on ``device`` (the card unless asked)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    K, P, O, N = caps.max_kf, caps.max_pt, caps.max_obs, caps.n_feat
    n_kf = min(n_kf, K)
    n_pt = min(n_pt, P - 1)

    cfg = SlamConfig(camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0)
    cam = Camera.from_config(cfg, dev)
    fx, fy, cx, cy, bf = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                          float(cam.bf))

    # smooth forward trajectory
    kf_pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(n_kf):
        kf_pose[k, 0, 3] = -0.08 * k        # t_c_w translation
        th = 0.01 * k
        c, s = np.cos(th), np.sin(th)
        kf_pose[k, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    pt_pos = np.zeros((P, 3), np.float32)
    pt_pos[:n_pt] = rng.uniform([-3, -2, 1.5], [6, 2, 7], (n_pt, 3))
    pt_desc = np.zeros((P, 8), np.uint32)
    pt_desc[:n_pt] = rng.integers(0, 2**32, (n_pt, 8), dtype=np.uint32)

    # each point observed by a run of consecutive KFs
    first = rng.integers(0, n_kf, n_pt)
    span = rng.integers(2, min(span_max, O), n_pt)

    pt_obs_kf = np.full((P, O), -1, np.int32)
    pt_obs_kp = np.full((P, O), -1, np.int32)
    kf_mp = np.full((K, N), -1, np.int32)
    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_oct = np.zeros((K, N), np.int32)
    kf_depth = np.full((K, N), -1.0, np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_desc = np.zeros((K, N, 8), np.uint32)
    kf_kp_valid = np.zeros((K, N), bool)
    next_kp = np.zeros(K, np.int32)

    for p in range(n_pt):
        oi = 0
        for k in range(first[p], min(first[p] + span[p], n_kf)):
            kp = next_kp[k]
            if kp >= N:
                continue
            pc = kf_pose[k, :3, :3] @ pt_pos[p] + kf_pose[k, :3, 3]
            if pc[2] <= 0.1:
                continue
            u = fx * pc[0] / pc[2] + cx
            v = fy * pc[1] / pc[2] + cy
            if not (0 <= u < cam.width and 0 <= v < cam.height):
                continue
            kf_uv[k, kp] = (u, v)
            kf_oct[k, kp] = rng.integers(0, 8)
            kf_depth[k, kp] = pc[2]
            kf_ur[k, kp] = u - bf / pc[2]
            kf_desc[k, kp] = pt_desc[p] ^ rng.integers(0, 2, 8).astype(np.uint32)
            kf_kp_valid[k, kp] = True
            kf_mp[k, kp] = p
            pt_obs_kf[p, oi] = k
            pt_obs_kp[p, oi] = kp
            next_kp[k] += 1
            oi += 1
            if oi >= O:
                break

    obs_cnt = (pt_obs_kf[:, :] >= 0).sum(1).astype(np.int32)
    # covisibility
    covis = np.zeros((K, K), np.int32)
    for p in range(n_pt):
        ks = pt_obs_kf[p][pt_obs_kf[p] >= 0]
        for a in ks:
            for b in ks:
                if a != b:
                    covis[a, b] += 1

    ow = np.stack([-kf_pose[k, :3, :3].T @ kf_pose[k, :3, 3] for k in range(K)])
    ref = np.where(obs_cnt > 0, pt_obs_kf[:, 0], -1)
    d = np.linalg.norm(pt_pos - ow[np.maximum(ref, 0)], axis=1)

    kf_on = np.arange(K) < n_kf
    fields = dict(
        kf_pose=kf_pose,
        kf_valid=kf_on,
        kf_seq=np.where(kf_on, np.arange(K), -1).astype(np.int32),
        kf_gen=kf_on.astype(np.int32),
        kf_uv_und=kf_uv,
        kf_octave=kf_oct,
        kf_depth=kf_depth,
        kf_u_right=kf_ur,
        kf_desc=kf_desc.view(np.int32),
        kf_kp_valid=kf_kp_valid,
        kf_mp=kf_mp,
        covis=covis,
        parent=np.concatenate([[-1], np.arange(n_kf - 1), np.full(K - n_kf, -1)]).astype(np.int32),
        pt_pos=pt_pos,
        pt_normal=np.tile(np.array([0, 0, -1.0], np.float32), (P, 1)),
        pt_desc=pt_desc.view(np.int32),
        pt_min_dist=(0.5 * d).astype(np.float32),
        pt_max_dist=(2.5 * d).astype(np.float32),
        pt_ref_kf=ref.astype(np.int32),
        pt_obs_kf=pt_obs_kf,
        pt_obs_kp=pt_obs_kp,
        pt_obs_cnt=obs_cnt,
        pt_found=(obs_cnt + 1).astype(np.int32),
        pt_visible=(obs_cnt + 2).astype(np.int32),
        pt_valid=obs_cnt > 0,
        pt_gen=(obs_cnt > 0).astype(np.int32),
        n_kf=np.asarray(n_kf, np.int32),
        n_pt=np.asarray(n_pt, np.int32),
        n_kf_ever=np.asarray(n_kf, np.int32),
    )
    m = empty_map(caps, dev).replace(
        **{k: torch.as_tensor(v).to(dev) for k, v in fields.items()})
    return m, cam
