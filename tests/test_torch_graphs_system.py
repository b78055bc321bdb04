"""SlamSystem(vocabulary=None) through its step programs on the CPU: with
``graphs=True`` every frame runs ``utils.graphs.StepGraph``'s select form
under ``no_host_reads`` (the stand-in for a replayed CUDA graph with
conditional nodes: the motion retry, the predicated insert, the mapping
chain's cond, each triangulation slot's cond, local BA's interruptBA cond and
its LM passes as ``while_capped``), and it must equal the eager run bit for
bit over the 24-frame 320x240 room orbit (tests/torch_slam_helpers.py),
local BA on: every MapState tensor, every frame's outputs, the keyframes and
the LM counts. This file runs it per frame; test_torch_graphs_chunk.py with
``chunk=4``.
"""

import dataclasses

import numpy as np
import torch

from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline.system import SlamSystem

from torch_slam_helpers import N_FRAMES, P_CAPS, room_kw, room_sequence

OUT_KEYS = ("T_c_w", "T_cr", "ref_kf", "ref_gen", "ok", "n_features", "n_matches", "n_inliers",
            "relocalized", "kp_uv", "kp_state")


def graph_vs_eager_room(chunk: int) -> None:
    seq = room_sequence()
    frames = [seq[i] for i in range(N_FRAMES)]
    runs = {}
    for on in (False, True):
        s = SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu", chunk=chunk,
                       graphs=on)
        assert s.graphs is on
        for g, d, ts in frames:
            s.track(g, d, ts)
        runs[on] = (s, s.results())
    (a, ra), (b, rb) = runs[False], runs[True]
    assert np.array_equal(ra[0], rb[0]) and ra[1] == rb[1]
    assert [t for t, _ in ra[2]] == [t for t, _ in rb[2]]
    made = [o.made_kf for o in a._outs]
    assert made == [o.made_kf for o in b._outs] and sum(made) >= 5
    assert a.ba_iters == b.ba_iters and all(n1 > 0 for _, n1, _ in a.ba_iters if chunk == 1)
    assert a.n_ba_interrupts == b.n_ba_interrupts
    for i, (x, y) in enumerate(zip(a._outs, b._outs)):
        for k in OUT_KEYS:
            assert torch.equal(getattr(x, k), getattr(y, k)), (i, k)
    for f in dataclasses.fields(a.map):
        assert torch.equal(getattr(a.map, f.name), getattr(b.map, f.name)), f.name
    sa, sb = a.state, b.state
    for k in ("assign_real", "assign_gen", "T_cr", "ref_kf", "T_cl", "motion_valid", "lost",
              "frame_id", "last_kf_frame", "last_was_kf"):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    assert int(sb.frame_id) == N_FRAMES
    if chunk == 1:
        # a system resumed from another's state and map, its frame counter
        # carried (run_slam's save/load/resume): one more frame each way
        g, d, ts = seq[N_FRAMES]
        resumed = []
        for on, (s, _) in ((False, runs[False]), (True, runs[True])):
            r = SlamSystem(SlamConfig(**room_kw(seq)), caps=P_CAPS, device="cpu", graphs=on)
            r.map, r.state, r._frame_id = s.map, s.state, s._frame_id
            r.track(g, d, ts)
            resumed.append((r, r.results()))
        (ra2, xa), (rb2, xb) = resumed
        assert np.array_equal(xa[0], xb[0]) and xa[1] == xb[1]
        assert [o.made_kf for o in ra2._outs] == [o.made_kf for o in rb2._outs]
        assert ra2.ba_iters == rb2.ba_iters and all(f == N_FRAMES for f, _, _ in rb2.ba_iters)


def test_slam_system_select_bit_equal_to_eager_per_frame():
    graph_vs_eager_room(chunk=1)
