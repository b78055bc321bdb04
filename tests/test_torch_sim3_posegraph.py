"""The port's Sim3 RANSAC / refinement (solvers/sim3.py) and essential-graph
pose graph (solvers/pose_graph.py) against the JAX package's, on the scenes
of tests/test_sim3_posegraph.py.

- The three cases of tests/test_sim3_posegraph.py, with their own bounds.
- ransac_sim3 over seeds 0-15: the port draws JAX's hypotheses (utils/
  prng.py), so the winning sample, the inlier mask and count are equal and
  the transform within 1e-5 (Horn's SVD runs in another LAPACK).
- refine_sim3 and solve_pose_graph within 1e-4 of JAX (forward-mode
  Jacobians on both sides; f32 sums in another order), the inlier counts
  equal. The pose graph's gauge (+1e8 on the fixed and invalid vertices)
  makes its system badly conditioned, so poses are compared within a
  tolerance, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import lie as jlie
from vo_slam_test_tpu.solvers import pose_graph as jpose_graph
from vo_slam_test_tpu.solvers import sim3 as jsim3
from vo_slam_test_tpu_torch.solvers import pose_graph, sim3
from test_sim3_posegraph import CX, CY, FX, FY, make_sim3_scene

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(*arrs):
    return [torch.as_tensor(np.array(a)) for a in arrs]


def _ransac_both(scene, seed, valid=None):
    T12, pc1, pc2, uv1, uv2, out = scene
    n = pc1.shape[0]
    gates = np.full(n, 9.21, np.float32)
    valid = np.ones(n, bool) if valid is None else valid
    j = jsim3.ransac_sim3(*(jnp.asarray(a) for a in (pc1, pc2, uv1, uv2, gates, gates, valid)),
                          FX, FY, CX, CY, jnp.asarray(seed), fix_scale=True)
    p = sim3.ransac_sim3(*_t(pc1, pc2, uv1, uv2, gates, gates, valid), FX, FY, CX, CY, seed)
    return j, p


def test_ransac_recovers_relative_pose():
    """tests/test_sim3_posegraph.py::TestSim3::test_ransac_recovers_relative_pose."""
    scene = make_sim3_scene()
    T12, out = scene[0], scene[5]
    _, (s, T, inl, cnt) = _ransac_both(scene, 7)
    assert float(s) == 1.0
    assert int(cnt) > 0.7 * (~out).sum()
    err = np.abs(T.numpy() - T12).max()
    assert err < 0.02, err


@pytest.mark.parametrize("seed", range(16))
def test_ransac_same_picks_as_jax(seed):
    """Every seed draws JAX's samples: the inlier mask and count equal."""
    scene = make_sim3_scene(n=60, outlier_frac=0.4, seed=seed)
    valid = np.random.default_rng(seed).uniform(size=60) < 0.8
    (js, jT, jinl, jc), (ps, pT, pinl, pc) = _ransac_both(scene, seed, valid)
    assert int(pc) == int(jc)
    np.testing.assert_array_equal(pinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), rtol=1e-5, atol=1e-5)


def _refine_both(seed, outlier_frac, xi0):
    T12, pc1, pc2, uv1, uv2, out = make_sim3_scene(outlier_frac=outlier_frac, seed=seed)
    n = pc1.shape[0]
    T_init = (np.asarray(jlie.se3_exp(jnp.asarray(xi0))) @ T12).astype(np.float32)
    ones = np.ones(n, np.float32)
    j = jsim3.refine_sim3(jnp.asarray(T_init), jnp.asarray(1.0), *(jnp.asarray(a) for a in (
        pc1, pc2, uv1, uv2, ones, ones, np.ones(n, bool))), FX, FY, CX, CY)
    p = sim3.refine_sim3(*_t(T_init, np.float32(1.0), pc1, pc2, uv1, uv2, ones, ones,
                             np.ones(n, bool)), FX, FY, CX, CY)
    return T12, out, j, p


def test_refine_improves():
    """tests/test_sim3_posegraph.py::TestSim3::test_refine_improves."""
    xi0 = np.array([0.02, -0.01, 0.015, 0.01, -0.005, 0.008], np.float32)
    T12, out, _, (s, T, inl, cnt) = _refine_both(3, 0.1, xi0)
    err = np.abs(T.numpy() - T12).max()
    assert err < 5e-3, err
    assert int(cnt) >= 0.8 * (~out).sum()
    assert inl.numpy()[out].mean() < 0.2


@pytest.mark.parametrize("seed, xi_scale", [(3, 1.0), (4, 3.0), (5, 0.0)])
def test_refine_matches_jax(seed, xi_scale):
    xi0 = xi_scale * np.array([0.02, -0.01, 0.015, 0.01, -0.005, 0.008], np.float32)
    _, _, (js, jT, jinl, jc), (ps, pT, pinl, pc) = _refine_both(seed, 0.2, xi0)
    assert int(pc) == int(jc)
    np.testing.assert_array_equal(pinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(pT.numpy(), np.asarray(jT), **TOL)
    assert float(ps) == float(js) == 1.0


def _drifted_chain(K=16, seed=1, n_loops=1):
    """tests/test_sim3_posegraph.py's chain: drifted odometry edges measured
    from the estimates, a loop edge 0 <-> K-1 from ground truth."""
    rng = np.random.default_rng(seed)
    step_xi = np.array([0.2, 0.0, 0.05, 0.0, 0.12, 0.0], np.float32)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, K):
        gt.append(np.asarray(jlie.se3_exp(jnp.asarray(step_xi))) @ gt[-1])
    gt = np.stack(gt)
    est = [gt[0]]
    for _ in range(1, K):
        noise = np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.004, 3)]).astype(np.float32)
        est.append(np.asarray(jlie.se3_exp(jnp.asarray(step_xi + noise))) @ est[-1])
    est = np.stack(est)
    edge_mask = np.zeros((K, K), bool)
    meas_R = np.tile(np.eye(3, dtype=np.float32), (K, K, 1, 1))
    meas_t = np.zeros((K, K, 3), np.float32)

    def set_edge(i, j, S_i, S_j):
        edge_mask[i, j] = edge_mask[j, i] = True
        T_ij = S_i @ np.linalg.inv(S_j)
        meas_R[i, j], meas_t[i, j] = T_ij[:3, :3], T_ij[:3, 3]
        T_ji = np.linalg.inv(T_ij)
        meas_R[j, i], meas_t[j, i] = T_ji[:3, :3], T_ji[:3, 3]

    for k in range(1, K):
        set_edge(k - 1, k, est[k - 1], est[k])
    for L in range(n_loops):
        set_edge(L, K - 1 - L, gt[L], gt[K - 1 - L])
    return gt, est, edge_mask, np.ones((K, K), np.float32), meas_R, meas_t


def _solve_both(est, valid, edge_mask, meas_s, meas_R, meas_t, fixed, max_edges):
    K = est.shape[0]
    j = jpose_graph.solve_pose_graph(
        jnp.ones((K,)), jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
        jnp.asarray(valid), jnp.asarray(edge_mask), jnp.asarray(meas_s), jnp.asarray(meas_R),
        jnp.asarray(meas_t), jnp.asarray(fixed, jnp.int32), fix_scale=True, iters=20,
        max_edges=max_edges)
    p = pose_graph.solve_pose_graph(torch.ones(K), *_t(est[:, :3, :3], est[:, :3, 3], valid,
                                                       edge_mask, meas_s, meas_R, meas_t),
                                    fixed, iters=20, max_edges=max_edges)
    return j, p


def test_loop_drift_distributed():
    """tests/test_sim3_posegraph.py::TestPoseGraph::test_loop_drift_distributed."""
    gt, est, edge_mask, meas_s, meas_R, meas_t = _drifted_chain()
    K = est.shape[0]
    _, (s, R, t) = _solve_both(est, np.ones(K, bool), edge_mask, meas_s, meas_R, meas_t, 0, 64)
    drift_before = np.linalg.norm(est[K - 1][:3, 3] - gt[K - 1][:3, 3])
    err_after = np.linalg.norm(t.numpy()[K - 1] - gt[K - 1][:3, 3])
    assert err_after < 0.5 * drift_before, (drift_before, err_after)


@pytest.mark.parametrize("case", ["chain", "two_loops_fixed_5", "invalid_vertex", "few_edges"])
def test_pose_graph_matches_jax(case):
    """Within 1e-4 of JAX: the chain, another fixed vertex with two loop
    edges, an invalid vertex (its +1e8 gauge) and an edge list shorter than
    the graph (the first max_edges in row-major order)."""
    gt, est, edge_mask, meas_s, meas_R, meas_t = _drifted_chain(
        n_loops=2 if case == "two_loops_fixed_5" else 1)
    K = est.shape[0]
    valid = np.ones(K, bool)
    if case == "invalid_vertex":
        valid[6] = False
    fixed = 5 if case == "two_loops_fixed_5" else 0
    max_edges = 10 if case == "few_edges" else 64
    (js, jR, jt), (ps, pR, pt) = _solve_both(est, valid, edge_mask, meas_s, meas_R, meas_t,
                                             fixed, max_edges)
    assert np.isfinite(pR.numpy()).all() and np.isfinite(pt.numpy()).all()
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(pR.numpy(), np.asarray(jR), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), **TOL)
