"""The port's device-side control flow (``vo_slam_test_tpu_torch/utils/graphs.py``)
on the CPU: ``cond`` and ``while_capped`` in eager and select modes, the
``no_host_reads`` guard, ``FusedTracker`` and local BA in select mode (the
stand-in for a replayed CUDA graph) against their eager runs bit for bit, and
the triangulation's sync-free null vector against the JAX package's SVD.

The SlamSystem cases (per frame and ``chunk=4``) are in
``test_torch_graphs_system.py``; the card's capture and replay in
``test_torch_graphs_gpu.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu.datasets import SyntheticRGBD
from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.datasets import synth_map
from vo_slam_test_tpu_torch.pipeline.tracking import FusedTracker
from vo_slam_test_tpu_torch.slam_map import triangulate
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps
from vo_slam_test_tpu_torch.solvers import local_ba, pose_only
from vo_slam_test_tpu_torch.utils import graphs

from torch_slam_helpers import FLOAT_TOL


def _tensors(tree):
    return graphs.flatten(tree)[0]


def assert_bit_equal(a, b, what):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))), (what, i)


# ---------------------------------------------------------------------------
# cond / while_capped
# ---------------------------------------------------------------------------


def _branches(x):
    def t(a):
        return {"y": a * 2.0, "n": (a > 0).sum(dtype=torch.int32)}

    def f(a):
        # a NaN and an infinity the select must drop
        return {"y": a / torch.zeros_like(a) * 0.0 + torch.log(-a.abs() - 1.0),
                "n": torch.full((), -1, dtype=torch.int32)}

    return t, f


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_select_equals_eager(sign):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=64).astype(np.float32)) * sign
    pred = x.sum() > 0
    t, f = _branches(x)
    want = graphs.cond(pred, t, f, (x,))
    with graphs.use("select"), graphs.no_host_reads():
        got = graphs.cond(pred, t, f, (x,))
    assert_bit_equal(got, want, "cond")
    # the discarded side's NaN never reaches the result
    assert torch.isfinite(got["y"]).all() == bool(pred)
    # a host bool branches on the host in every mode, no read
    with graphs.use("select"), graphs.no_host_reads():
        out = graphs.cond(False, t, f, (x,))
    assert int(out["n"]) == -1


def test_cond_branch_mismatch_raises():
    x = torch.ones(3)
    with graphs.use("select"), pytest.raises(TypeError):
        graphs.cond(x.sum() > 0, lambda: x, lambda: x.to(torch.float64))
    with graphs.use("select"), pytest.raises(TypeError):
        graphs.cond(x.sum() > 0, lambda: (x,), lambda: x)


@pytest.mark.parametrize("limit,cap", [(100.0, 12), (100.0, 3), (0.5, 6)])
def test_while_capped_select_equals_eager(limit, cap):
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(rng.uniform(0.5, 1.5, 16).astype(np.float32))

    def body(c):
        x, n, _ = c
        x = x * 1.7
        # NaN once past the limit: the select must keep the last live state
        x = torch.where(x.sum() > 4 * limit, torch.full_like(x, float("nan")), x)
        return x, n + 1, x.sum() >= limit

    def cond_fn(c):
        return ~c[2]

    state = (x0, torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.bool))
    want = graphs.while_capped(cond_fn, body, state, cap, active=True)
    with graphs.use("select"), graphs.no_host_reads():
        got = graphs.while_capped(cond_fn, body, state, cap, active=True)
    assert_bit_equal(got, want, "while_capped")
    n = int(want[1])
    assert n <= cap and (n == cap or bool(want[2]))


def test_pose_only_lm_select_equals_eager():
    """solve_pose_only(fast=False): the LM loop as while_capped."""
    rng = np.random.default_rng(11)
    n = 120
    p = rng.uniform([-2, -2, 2], [2, 2, 6], (n, 3)).astype(np.float32)
    uv = (p[:, :2] / p[:, 2:] * 500 + 320 + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    obs = pose_only.PoseObs(
        p_world=torch.as_tensor(p), uv=torch.as_tensor(uv),
        u_right=torch.as_tensor(np.where(rng.random(n) < 0.5, uv[:, 0] - 40.0 / p[:, 2], -1.0)
                                .astype(np.float32)),
        inv_sigma2=torch.ones(n), valid=torch.as_tensor(rng.random(n) < 0.9))
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.03, -0.02, 0.05])
    args = (T0, obs, 500.0, 500.0, 320.0, 320.0, 40.0)
    want = pose_only.solve_pose_only(*args)
    with graphs.use("select"), graphs.no_host_reads():
        got = pose_only.solve_pose_only(*args)
    assert_bit_equal(got, want, "solve_pose_only")


# ---------------------------------------------------------------------------
# no_host_reads
# ---------------------------------------------------------------------------

READS = {
    "item": lambda t: t.sum().item(),
    "tolist": lambda t: t.tolist(),
    "bool (if t:)": lambda t: 1 if t.sum() > 0 else 0,
    "int": lambda t: int(t[0]),
    "float": lambda t: float(t[0]),
    "index": lambda t: [1, 2, 3][t[0].long()],
    "numpy": lambda t: t.numpy(),
    "cpu": lambda t: t.cpu(),
    "format": lambda t: f"{t[0]:.3f}",
    "nonzero": lambda t: torch.nonzero(t),
    "where(cond)": lambda t: torch.where(t > 0),
    "masked_select": lambda t: torch.masked_select(t, t > 0),
    "bool-mask index": lambda t: t[t > 0],
    "0-d tensor index": lambda t: t[torch.zeros((), dtype=torch.long)],
    "0-d tensor setitem": lambda t: t.clone().__setitem__(torch.zeros((), dtype=torch.long), 1.0),
    "unique": lambda t: torch.unique(t),
    "svd": lambda t: torch.linalg.svd(t.reshape(2, 2)),
    "solve": lambda t: torch.linalg.solve(torch.eye(2), t[:2]),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_no_host_reads_catches(name):
    t = torch.tensor([1.0, -2.0, 3.0, 4.0])
    READS[name](t)  # fine outside the guard
    with graphs.no_host_reads(), pytest.raises(graphs.HostReadError):
        READS[name](t)


def test_no_host_reads_allows_device_work():
    t = torch.tensor([1.0, -2.0, 3.0, 4.0])
    with graphs.no_host_reads():
        idx = torch.tensor([0, 2])
        out = torch.where(t > 0, t, 0.0)[idx] + torch.linalg.solve_ex(torch.eye(2), t[:2])[0]
        out = out.index_select(0, torch.zeros(1, dtype=torch.long))
    assert out.shape == (1,)


# ---------------------------------------------------------------------------
# host or device values: the helpers that keep the mode inside graphs.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eager", "select"])
def test_fetch_by_mode(mode):
    """Eager: Python values from one read (a scalar per 0-d tensor, a list
    per 1-d one, bools kept bools); select: the tensors, under the guard."""
    flag, slot = torch.tensor(True), torch.tensor(3, dtype=torch.int32)
    gates = torch.tensor([True, False, True])
    with graphs.use(mode):
        if mode == "eager":
            assert graphs.fetch(flag, slot, gates) == (True, 3, [True, False, True])
            assert graphs.fetch(slot) == 3
            with pytest.raises(TypeError):
                graphs.fetch(torch.tensor(0.5))
        else:
            with graphs.no_host_reads():
                got = graphs.fetch(flag, slot, gates)
                assert graphs.fetch(slot) is slot
            assert all(a is b for a, b in zip(got, (flag, slot, gates)))


def test_where_scalar_on_device():
    a, b = torch.tensor([1, 2]), torch.tensor([3, 4])
    assert graphs.where(True, a, b) is a and graphs.where(False, 5, -1) == -1
    assert torch.equal(graphs.where(torch.tensor(False), a, b), b)
    with graphs.use("eager"):
        assert graphs.scalar(0, torch.int32, "cpu") == 0
    with graphs.use("select"):
        z = graphs.scalar(0, torch.int32, "cpu")
        assert isinstance(z, torch.Tensor) and z.dtype == torch.int32 and z.dim() == 0
    d = graphs.on_device(7, torch.int32, "cpu")
    assert d.dtype == torch.int32 and int(d) == 7
    assert graphs.on_device(torch.tensor(2), torch.int32, "cpu").dtype == torch.int32


# ---------------------------------------------------------------------------
# FusedTracker
# ---------------------------------------------------------------------------


def test_fused_tracker_select_bit_equal_to_eager():
    """tests/test_torch_tracking.py's sequence (the JAX renderer, 320x240, 4
    levels, 500 features): graphs=True on the CPU runs every frame after the
    first through StepGraph's select form under no_host_reads."""
    W, H = 320, 240
    seq = SyntheticRGBD(width=W, height=H, fx=517.3 * 0.5, fy=516.5 * 0.5, cx=318.6 * 0.5,
                        cy=255.3 * 0.5, n_frames=8, seed=11, motion_scale=0.5)
    cfg = SlamConfig(camera_fx=seq.fx, camera_fy=seq.fy, camera_cx=seq.cx, camera_cy=seq.cy,
                     camera_k1=0, camera_k2=0, camera_p1=0, camera_p2=0, camera_k3=0,
                     camera_width=W, camera_height=H, level_pyramid=4, num_of_features=500)
    frames = [seq[i] for i in range(len(seq))]
    runs = {}
    for on in (False, True):
        tr = FusedTracker(cfg, device="cpu", graphs=on)
        assert tr.graphs is on
        for g, d, ts in frames:
            tr.track(g, d, ts)
        runs[on] = tr
    a, b = runs[False], runs[True]
    for i, (x, y) in enumerate(zip(a._outs, b._outs)):
        assert_bit_equal(dataclasses.astuple(x), dataclasses.astuple(y), f"frame {i}")
    assert_bit_equal(a.state, b.state, "state")
    (ta, sa), (tb, sb) = a.results(), b.results()
    assert np.array_equal(ta, tb) and sa == sb
    assert all(s.ok for s in sa) and sum(s.n_matches >= 20 for s in sa) == len(sa) - 1


# ---------------------------------------------------------------------------
# local BA's while_capped
# ---------------------------------------------------------------------------

SAT_CAPS = MapCaps(max_kf=64, max_pt=4096, max_obs=24, n_feat=256)


def test_local_ba_select_equals_eager_saturated():
    """datasets/synth_map.build's saturation map (tests/test_local_ba_saturation.py's:
    24 window slots, the observer lists full) with its points moved by
    N(0, 2 cm): the eager LM loop against the select form, every map tensor
    and both LM counts; a raised stop flag leaves the map untouched."""
    m, cam = synth_map.build(SAT_CAPS, n_kf=40, n_pt=3500, seed=3, span_max=24, device="cpu")
    live = m.pt_valid.clone()
    live[-1] = False
    noise = torch.as_tensor(np.random.default_rng(0).normal(0, 0.02, m.pt_pos.shape)
                            .astype(np.float32))
    m = m.replace(pt_pos=torch.where(live[:, None], m.pt_pos + noise, m.pt_pos))
    center = 20
    inv = torch.ones(8)
    m_e, n1, n2 = local_ba.local_bundle_adjust_iters(m, center, SAT_CAPS, cam, inv)
    kf = torch.tensor(center, dtype=torch.int32)
    with graphs.use("select"), graphs.no_host_reads():
        m_s, s1, s2 = local_ba.local_bundle_adjust_iters(m, kf, SAT_CAPS, cam, inv,
                                                         stop=torch.tensor(False))
        m_x, x1, x2 = local_ba.local_bundle_adjust_iters(m, kf, SAT_CAPS, cam, inv,
                                                         stop=torch.tensor(True))
    assert (int(s1), int(s2)) == (n1, n2) and n1 > 0 and n2 > 0
    assert (int(x1), int(x2)) == (0, 0)
    assert_bit_equal(m_s, m_e, "local BA map")
    assert_bit_equal(m_x, m, "stopped local BA map")


# ---------------------------------------------------------------------------
# the triangulation's null vector
# ---------------------------------------------------------------------------


def _dlt_systems(n, seed):
    """Homogeneous DLT rows (localMapping.cpp:236-252) of two views of points
    at 0.5-20 m with baselines of a few cm and 1e-3 normalized-pixel noise."""
    rng = np.random.default_rng(seed)
    P = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(0.5, 20, n)]
    A = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        T2 = np.eye(4)
        T2[:3, 3] = rng.normal(0, 0.05, 3)
        p1 = P[i, :2] / P[i, 2] + rng.normal(0, 1e-3, 2)
        x2 = P[i] + T2[:3, 3]
        p2 = x2[:2] / x2[2] + rng.normal(0, 1e-3, 2)
        P1, P2 = np.eye(4)[:3], T2[:3]
        A[i] = [p1[0] * P1[2] - P1[0], p1[1] * P1[2] - P1[1],
                p2[0] * P2[2] - P2[0], p2[1] * P2[2] - P2[1]]
    return A


@pytest.mark.parametrize("seed", [0, 1])
def test_null_vector_matches_jax_svd(seed):
    """null_vector_4x4 against the JAX package's ``jnp.linalg.svd(A)[2][:, 3]``
    (triangulate.py:213-216): the triangulated point xh[:3] / xh[3] within
    FLOAT_TOL on the systems where JAX's f32 SVD is itself that accurate (its
    first-order error eps * s1 / (s3 - s4) / |w| under 1e-4), w_ok equal on
    all; and within 1e-5 of the exact (f64 SVD) point on every system."""
    A = _dlt_systems(600, seed)
    _, s, vt = np.linalg.svd(A.astype(np.float64))
    xh_j = np.asarray(jnp.linalg.svd(jnp.asarray(A))[2][:, 3, :])
    with graphs.no_host_reads():
        xh_p = triangulate.null_vector_4x4(torch.as_tensor(A))
    xh_p = xh_p.numpy()
    assert xh_p.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(xh_p, axis=1), 1.0, atol=1e-6)
    assert np.array_equal(np.abs(xh_p[:, 3]) > 1e-8, np.abs(xh_j[:, 3]) > 1e-8)
    jax_err = 1.2e-7 * s[:, 0] / (s[:, 2] - s[:, 3]) / np.abs(vt[:, 3, 3])
    sel = jax_err < 1e-4
    assert sel.mean() > 0.7
    np.testing.assert_allclose(xh_p[sel, :3] / xh_p[sel, 3:], xh_j[sel, :3] / xh_j[sel, 3:],
                               **FLOAT_TOL)
    p_x = vt[:, 3, :3] / vt[:, 3, 3:]
    rel = np.abs(xh_p[:, :3] / xh_p[:, 3:] - p_x).max(1) / np.abs(p_x).max(1)
    assert rel.max() < 1e-5
