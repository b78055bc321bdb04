"""Benchmark staging: pre-rendered frame caches and scene vocabularies (port
of ``vo_slam_test_tpu/datasets/staging.py``).

The reference's benchmark protocol reads frames from disk into RAM before the
timed loop (vo_run.cpp:109-110, untimed cv::imread) and loads a prebuilt
vocabulary (vo_run.cpp:86-90). These helpers give the synthetic scenarios the
same untimed setup: the host ray-caster costs hundreds of ms a frame and
vocabulary training minutes, so both are cached on disk in ``VO_STAGE_CACHE``
(default: the temporary directory, ``TMPDIR``), keyed by a fingerprint of
what generated them.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time
from typing import Optional, Union

import numpy as np
import torch

CACHE_DIR = os.environ.get("VO_STAGE_CACHE", tempfile.gettempdir())


def _scene_fingerprint(seq) -> str:
    """Short hash of the sequence's generating parameters, so changing the
    scenario (seed, trajectory, texture, ...) under an unchanged tag cannot
    reuse stale cached frames. Covers every non-private scalar, string,
    tuple and array attribute of the sequence object (arrays by content)."""
    items = []
    for k in sorted(vars(seq)) if hasattr(seq, "__dict__") else []:
        if k.startswith("_"):
            continue
        v = getattr(seq, k)
        if isinstance(v, (int, float, str, bool, tuple)):
            items.append(f"{k}={v!r}")
        elif isinstance(v, np.ndarray):
            items.append(f"{k}={hashlib.sha1(np.ascontiguousarray(v)).hexdigest()[:12]}")
    return hashlib.sha1(";".join(items).encode()).hexdigest()[:10]


def render_all(seq, n_frames: int, tag: str):
    """Pre-render (or load the disk cache of) every frame.

    Returns (grays [list of u8 HxW], depths [list of f32 HxW], times)."""
    fp = _scene_fingerprint(seq)
    path = f"{CACHE_DIR}/pilot_frames_{tag}_{n_frames}_{fp}.npz"
    if os.path.exists(path):
        z = np.load(path)
        return list(z["gray"]), list(z["depth"]), z["times"].tolist()
    t0 = time.time()
    grays, depths, times = [], [], []
    for i in range(n_frames):
        g, d, ts = seq[i]
        grays.append(g)
        depths.append(d)
        times.append(ts)
        if i % 40 == 39:
            print(f"[stage] rendered {i+1}/{n_frames} "
                  f"({(time.time()-t0)/(i+1)*1000:.0f} ms/f)", flush=True)
    np.savez(path, gray=np.stack(grays), depth=np.stack(depths), times=np.asarray(times))
    return grays, depths, times


def scene_vocabulary(cfg, grays, depths, tag: str, k: int = 10,
                     levels: int = 6, cap: int = 150_000,
                     repo_fallback: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None):
    """An ORBvoc-shaped (k=10, L=6) vocabulary trained on the scene's own
    descriptors (the reference's scene-vocabulary workflow, map.cpp:60-99),
    from the host-path ``OrbExtractor`` on every 4th frame, on ``device``
    (None: the card).

    Resolution order: the cache -> ``repo_fallback`` (a checked-in npz) ->
    train (and cache)."""
    from ..bow.vocabulary import Vocabulary, build_vocabulary

    # the key hashes sampled training frames, so a changed scenario under an
    # unchanged tag retrains
    h = hashlib.sha1()
    h.update(str(len(grays)).encode())
    for g in (grays[0], grays[len(grays) // 2], grays[-1]):
        h.update(np.ascontiguousarray(g).tobytes())
    path = f"{CACHE_DIR}/pilot_voc_{tag}_{k}_{levels}_{h.hexdigest()[:10]}.npz"
    if os.path.exists(path):
        return Vocabulary.load(path, device)
    if repo_fallback and os.path.exists(repo_fallback):
        return Vocabulary.load(repo_fallback, device)
    from ..camera import Camera
    from ..frontend.extractor import OrbExtractor

    t0 = time.time()
    ext = OrbExtractor(Camera.from_config(cfg, device), n_features=1000)
    descs = []
    for i in range(0, len(grays), 4):
        f = ext(grays[i], depths[i])
        descs.append(f.desc.cpu().numpy().view(np.uint32)[f.valid.cpu().numpy()])
    D = np.concatenate(descs)
    if D.shape[0] > cap:
        sel = np.random.default_rng(0).choice(D.shape[0], cap, replace=False)
        D = D[sel]
    print(f"[stage] training vocab on {D.shape[0]} descriptors "
          f"(extract {time.time()-t0:.0f}s)...", flush=True)
    voc = build_vocabulary(D, k=k, levels=levels, iters=6, seed=0, device=device)
    voc.save(path)
    print(f"[stage] vocab built in {time.time()-t0:.0f}s", flush=True)
    return voc
