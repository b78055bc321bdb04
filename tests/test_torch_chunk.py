"""The chunked scheduler (``SlamSystem(..., chunk=K)``) against the JAX
package: ``chunk_ba_stops`` on the five cases of tests/test_scheduler.py,
and 16 frames of the 320x240 room orbit (tests/torch_slam_helpers.py) at
chunk=8, no vocabulary, local BA on, against JAX's ``SlamSystem(chunk=8)``.

Held: keyframe frames and final keyframe and point counts equal, per-frame
counts equal, ATE within 0.05 cm of JAX's (the bound of the per-frame BA
test, tests/test_torch_local_ba.py; observed 0.0001 cm here), and the
port's LM iteration counts zero exactly on the events that JAX's
``chunk_ba_stops`` stops for JAX's own keyframe flags (JAX records no
``ba_iters`` without a vocabulary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import system as jsystem
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import ate_rmse
from vo_slam_test_tpu_torch.pipeline import system
from torch_slam_helpers import J_CAPS, P_CAPS, room_kw, room_sequence

CHUNK = 8
N_CHUNK_FRAMES = 16


@pytest.mark.parametrize("did", [
    [0, 0, 1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 1, 0, 0], [1, 0, 1, 0, 0, 0, 1, 0],
    [0] * 8, [1]])
def test_chunk_ba_stops_matches_jax(did):
    want = np.asarray(jsystem.chunk_ba_stops(jnp.asarray(did, bool))).tolist()
    assert system.chunk_ba_stops([bool(d) for d in did]).tolist() == want


@pytest.fixture(scope="module")
def runs():
    seq = room_sequence()
    frames = [seq[i] for i in range(N_CHUNK_FRAMES)]
    ps = system.SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu", chunk=CHUNK)
    for f in frames:
        ps.track(*f)
    p_traj, p_stats, _ = ps.results()
    js = jsystem.SlamSystem(JConfig(**room_kw(seq)), caps=J_CAPS, chunk=CHUNK)
    for f in frames:
        js.track(*f)
    j_traj, j_stats, _ = js.results()
    j_made = [bool(o.made_kf) for o in js._per_frame(jax.device_get(js._outs))]
    gt = np.stack([seq.poses[i] for i in range(N_CHUNK_FRAMES)])
    return dict(ps=ps, js=js, p_traj=p_traj, p_stats=p_stats, j_traj=j_traj, j_stats=j_stats,
                j_made=j_made, gt=gt)


def test_chunk8_run_matches_jax(runs):
    ps, js = runs["ps"], runs["js"]
    p_made = [o.made_kf for o in ps._outs]
    assert p_made == runs["j_made"] and sum(p_made) >= 3
    assert (ps.n_keyframes, ps.n_points) == (js.n_keyframes, js.n_points)
    for i, (p, j) in enumerate(zip(runs["p_stats"], runs["j_stats"])):
        assert (p.n_features, p.n_matches, p.n_inliers, p.ok) == \
            (j.n_features, j.n_matches, j.n_inliers, j.ok), i
    ts = ps.timestamps
    ate_p = ate_rmse(ts, runs["gt"], ts, runs["p_traj"])
    ate_j = ate_rmse(ts, runs["gt"], ts, runs["j_traj"])
    assert abs(ate_p - ate_j) < 5e-4 and ate_p < 0.03


def test_chunk8_ba_skipped_exactly_where_jax_stops(runs):
    made = runs["j_made"]
    stops = []
    for c0 in range(0, N_CHUNK_FRAMES, CHUNK):
        chunk = np.asarray(made[c0:c0 + CHUNK])
        stops += np.asarray(jsystem.chunk_ba_stops(jnp.asarray(chunk))).tolist()
    ba = {f: (n1, n2) for f, n1, n2 in runs["ps"].ba_iters}
    assert sorted(ba) == [i for i, m in enumerate(made) if m]
    assert any(stops[f] for f in ba) and not all(stops[f] for f in ba)
    for f, (n1, n2) in ba.items():
        assert ((n1, n2) == (0, 0)) == stops[f], f
        assert stops[f] or (n1 > 0 and n2 > 0), f


def test_partial_chunk_flushed_per_frame():
    """A partial chunk is tracked frame by frame at results(): 2 frames at
    chunk=8 are buffered until then, and each keyframe event then runs its
    local BA (no later keyframe of a chunk stops it)."""
    seq = room_sequence()
    a = system.SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu", chunk=CHUNK)
    for i in range(2):
        a.track(*seq[i])
    assert len(a._outs) == 0 and len(a._chunk_buf) == 2
    _, stats, _ = a.results()
    assert len(stats) == 2 and all(s.ok for s in stats) and not a._chunk_buf
    assert [f for f, _, _ in a.ba_iters] == [0, 1]
    assert all(n1 > 0 and n2 > 0 for _, n1, n2 in a.ba_iters)
