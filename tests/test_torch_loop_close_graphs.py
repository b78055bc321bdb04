"""The loop close as a step program on the CPU: ``_close_multi`` (the
candidate scan, each slot's Sim3 verification under a cond, one correction
under a cond on the accept) in select mode under ``no_host_reads`` (the
stand-in for a replay with conditional nodes) against its eager form and
against the JAX package's ``close_step_multi``, on
tests/test_torch_loop_close.py's multi-candidate scene (a dead slot, a bogus
candidate, a stale generation, then the accepted one); the essential graph
with a device ``fixed_kf`` against the int form (``SlamSystem``'s graph path
with the close inside: test_torch_loop_system_graphs.py). One JAX run
(``close_step_multi``, ~30 s of compile, on each candidate list of
``JAX_CANDS``) is shared by the session (tests/test_torch_graphs_loops.py
reads it too)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.camera import Camera as JCamera
from vo_slam_test_tpu.config import SlamConfig as JConfig
from vo_slam_test_tpu.pipeline import loop_closing as JLC
from vo_slam_test_tpu_torch import convert, lie
from vo_slam_test_tpu_torch.camera import Camera
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import loop_closing as LC
from vo_slam_test_tpu_torch.slam_map.map_state import pick
from vo_slam_test_tpu_torch.solvers import pose_graph
from vo_slam_test_tpu_torch.utils import graphs
from test_loop_close import CAPS, build_drifted_loop_map
from test_torch_loop_background import GROUP_DIV
from test_torch_loop_close import (KW, MULTI_CANDS, MULTI_GENS, P_CAPS, SCALES, _assert_map,
                                   _multi_map)
from torch_slam_helpers import _shared_run, port_map

torch.set_num_threads(1)


# the candidate lists JAX's close_step_multi runs on the multi-candidate scene:
# the tests' (a dead slot, a bogus candidate, a stale generation, then the
# accepted one), one with dead slots between live ones, and one accepted at once
JAX_CANDS = {"multi": (MULTI_CANDS, MULTI_GENS),
             "gapped": ([4, -1, 0, -1, 0, -1, -1, -1], [0, -1, 99, -1, 0, -1, -1, -1]),
             "first": ([0, 4, 0, -1, -1, -1, -1, -1], [0, 0, 0, -1, -1, -1, -1, -1])}


def _jax_close_multi(_):
    jcam = JCamera.from_config(JConfig(**KW))
    m, gt, _ = build_drifted_loop_map(jcam)
    host = jax.device_get(_multi_map(jax.tree.map(jnp.asarray, jax.device_get(m))))
    want = {}
    for name, (cands, gens) in JAX_CANDS.items():
        jm, jls, jdone, jwhich = JLC.close_step_multi(
            jax.tree.map(jnp.asarray, host), JLC.empty_loop_state(CAPS),
            jnp.asarray(9, jnp.int32), jnp.asarray(0, jnp.int32), jnp.asarray(cands, jnp.int32),
            jnp.asarray(gens, jnp.int32), jnp.asarray(GROUP_DIV, jnp.int32), CAPS, jcam,
            jnp.asarray(SCALES))
        want[name] = (convert.dataclass_to_numpy(jax.device_get(jm)), int(jls.last_loop_seq),
                      bool(jdone), int(jwhich))
    return dict(host=host, gt=gt, want=want)


def jax_close_multi(tmp_path_factory):
    """JAX's close_step_multi on the multi-candidate scene for each of
    ``JAX_CANDS``, once per test session (``_shared_run``): (the start map,
    the ground truth, {name: (map, last_loop_seq, accepted, winner)})."""
    return _shared_run(tmp_path_factory, "jax_close_multi", _jax_close_multi)


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    run = jax_close_multi(tmp_path_factory)
    return dict(host=run["host"], gt=run["gt"], cam=Camera.from_config(SlamConfig(**KW), "cpu"),
                want=run["want"]["multi"])


def _leaves_equal(a, b, label):
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    assert sa == sb, label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), (label, i)


def test_close_multi_select_equals_eager_and_jax(multi):
    sf = torch.as_tensor(SCALES)
    cands = torch.tensor(MULTI_CANDS, dtype=torch.int32)
    gens = torch.tensor(MULTI_GENS, dtype=torch.int32)

    def run(kf, m):
        kf_ok = pick(m.kf_valid, torch.as_tensor(kf)) & (pick(m.kf_gen, torch.as_tensor(kf)) == 0)
        return LC._close_multi(m, LC.empty_loop_state(P_CAPS, "cpu"), kf, kf_ok, cands, gens,
                               GROUP_DIV, P_CAPS, multi["cam"], sf)

    m_e, ls_e, out_e = run(9, port_map(multi["host"]))
    with graphs.use("select"), graphs.no_host_reads():
        m_g, ls_g, out_g = run(torch.tensor(9, dtype=torch.int32), port_map(multi["host"]))
    _leaves_equal((m_e, ls_e, out_e), (m_g, ls_g, out_g), "select against eager")

    closed, which, tried, accepted, gates = graphs.fetch(*out_g.leaves())
    assert (closed, which) == (True, 0)
    assert tried == [False, True, True, True, False, False, False, False]
    assert accepted == [False, False, False, True, False, False, False, False]
    attempts = LC.fold_attempts(MULTI_CANDS, tried, accepted, gates)
    assert [(c, a) for c, a, _ in attempts] == [(4, False), (0, False), (0, True)]
    assert attempts[1][2]["gen_ok"] == 0 and attempts[2][2]["gen_ok"] == 1
    want_map, want_seq, want_done, want_which = multi["want"]
    assert (want_done, want_which) == (True, 0)
    assert int(ls_g.last_loop_seq) == want_seq == 19
    _assert_map(m_g, want_map, "_close_multi in select mode")
    err = np.linalg.norm(m_g.kf_pose.numpy()[9][:3, 3] - multi["gt"][9][:3, 3])
    assert err < 0.05, err


def test_close_multi_nothing_accepted_leaves_the_map(multi):
    """Only the bogus and the stale candidates: every slot that runs is
    rejected, and the map and loop state come back unchanged in both modes."""
    sf = torch.as_tensor(SCALES)
    cands = torch.tensor([4, 0, -1, -1, -1, -1, -1, -1], dtype=torch.int32)
    gens = torch.tensor([0, 99, -1, -1, -1, -1, -1, -1], dtype=torch.int32)
    start = port_map(multi["host"])
    ls0 = LC.empty_loop_state(P_CAPS, "cpu")
    kf = torch.tensor(9, dtype=torch.int32)
    with graphs.use("select"), graphs.no_host_reads():
        m_g, ls_g, out_g = LC._close_multi(start, ls0, kf, pick(start.kf_valid, kf), cands, gens,
                                           GROUP_DIV, P_CAPS, multi["cam"], sf)
    m_e, ls_e, out_e = LC._close_multi(start, ls0, 9, start.kf_valid[9], cands, gens, GROUP_DIV,
                                       P_CAPS, multi["cam"], sf)
    assert m_e is start
    _leaves_equal((start, ls0), (m_g, ls_g), "select, nothing accepted")
    _leaves_equal(out_e, out_g, "outcome")
    assert graphs.fetch(out_g.closed, out_g.which) == (False, -1)
    assert graphs.fetch(out_g.tried) == [True, True] + [False] * 6


def test_pose_graph_device_fixed_kf_equals_int():
    """solve_pose_graph with the fixed keyframe as a 0-d device tensor (as a
    step program passes the candidate) equals the int form bit for bit."""
    g = torch.Generator().manual_seed(3)
    K, n = 16, 10
    xi = torch.randn(K, 6, generator=g) * 0.05
    xi[:, 2] += torch.arange(K) * 0.1
    T = lie.se3_exp(xi)
    valid = torch.arange(K) < n
    ids = torch.arange(K)
    edges = ((ids[:, None] - ids[None, :]).abs() == 1) & valid[:, None] & valid[None, :]
    edges[0, n - 1] = edges[n - 1, 0] = True
    meas = torch.einsum("iab,jbc->ijac", T, lie.se3_inverse(T))
    Tn = lie.se3_exp(torch.randn(K, 6, generator=g) * 0.01) @ T
    args = (torch.ones(K), Tn[:, :3, :3], Tn[:, :3, 3], valid, edges, torch.ones(K, K),
            meas[:, :, :3, :3], meas[:, :, :3, 3])
    want = pose_graph.solve_pose_graph(*args, 3, iters=20)
    with graphs.use("select"), graphs.no_host_reads():
        got = pose_graph.solve_pose_graph(*args, torch.tensor(3, dtype=torch.int32), iters=20)
    for w, x in zip(want, got):
        assert torch.equal(w, x)
    assert not torch.equal(want[2][5], Tn[5, :3, 3])  # the graph moved the others
