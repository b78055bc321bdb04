"""The Sim3 half of the port's lie.py against the JAX package's
(vo_slam_test_tpu/lie.py:271-356), and inv3x3 (utils/linalg.py).

The TestSim3 cases of tests/test_lie.py run on the port with their own
tolerances. Against JAX on the same numpy-seeded inputs: sim3_apply /
inverse / compose within 1e-6 (the same f32 formulas), sim3_exp / sim3_log
within 1e-5 (sim3_log solves a 3x3 system, in another LAPACK). Forward-mode
Jacobians at a zero tangent (the pose graph's and refine_sim3's
linearization points) within 1e-4 of jax.jacfwd, at angles 0, 1e-4 and 0.5
and at scales 1 and e^0.3: the small-angle branches must give finite, equal
derivatives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_slam_test_tpu import lie as jlie
from vo_slam_test_tpu.utils import linalg as jlinalg
from vo_slam_test_tpu_torch import lie
from vo_slam_test_tpu_torch.solvers.sim3 import jac_at_zero
from vo_slam_test_tpu_torch.utils import linalg

TOL = dict(rtol=1e-6, atol=1e-6)


def _sim3(seed, n=8):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    phi = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return s, R, t


def _t(*arrs):
    return [torch.as_tensor(np.asarray(a)) for a in arrs]


def test_apply_compose_inverse():
    """tests/test_lie.py::TestSim3::test_apply_compose_inverse on the port."""
    s, R, t = _t(*_sim3(0))
    si, Ri, ti = lie.sim3_inverse(s, R, t)
    sc, Rc, tc = lie.sim3_compose(s, R, t, si, Ri, ti)
    np.testing.assert_allclose(sc.numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(Rc.numpy(), np.eye(3)[None].repeat(8, 0), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-4)


def test_exp_log_roundtrip():
    """tests/test_lie.py::TestSim3::test_exp_log_roundtrip on the port."""
    rng = np.random.default_rng(2)
    xi = torch.as_tensor(rng.uniform(-0.8, 0.8, size=(32, 7)).astype(np.float32))
    xi2 = lie.sim3_log(*lie.sim3_exp(xi))
    np.testing.assert_allclose(xi2.numpy(), xi.numpy(), atol=2e-3)


def test_apply_inverse_compose_match_jax():
    s, R, t = _sim3(1)
    pts = np.random.default_rng(3).normal(size=(8, 5, 3)).astype(np.float32)
    s2, R2, t2 = _sim3(4)
    np.testing.assert_allclose(lie.sim3_apply(*_t(s, R, t, pts)).numpy(),
                               np.asarray(jlie.sim3_apply(s, R, t, pts)), **TOL)
    for got, want in zip(lie.sim3_inverse(*_t(s, R, t)), jlie.sim3_inverse(s, R, t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(lie.sim3_compose(*_t(s, R, t, s2, R2, t2)),
                         jlie.sim3_compose(s, R, t, s2, R2, t2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("angle, sigma", [(0.0, 0.0), (1e-4, 0.0), (0.5, 0.0), (0.0, 0.3),
                                          (0.5, 0.3), (1e-4, 1e-6)])
def test_exp_log_match_jax(angle, sigma):
    """Both branches of the Taylor blends: zero and tiny angle and scale."""
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(6, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi = np.concatenate([rng.normal(size=(6, 3)), axis * angle, np.full((6, 1), sigma)], 1)
    xi = xi.astype(np.float32)
    for got, want in zip(lie.sim3_exp(torch.as_tensor(xi)), jlie.sim3_exp(jnp.asarray(xi))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    s, R, t = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(lie.sim3_log(*_t(s, R, t)).numpy(),
                               np.asarray(jlie.sim3_log(s, R, t)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("angle, sigma", [(0.0, 0.0), (1e-4, 0.0), (0.5, 0.0), (0.5, 0.3)])
def test_jacobian_at_zero_matches_jax(angle, sigma):
    """d/dxi log(Exp(xi) S) at xi = 0 (the pose graph's vertex update) and
    d/dxi of a point through se3_exp(xi) T (refine_sim3's), forward mode on
    both sides, finite everywhere."""
    rng = np.random.default_rng(7)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    xi_s = np.concatenate([rng.normal(size=3) * 0.3, axis * angle, [sigma]]).astype(np.float32)
    S = jlie.sim3_exp(jnp.asarray(xi_s))

    def jf(x):
        return jlie.sim3_log(*jlie.sim3_compose(*jlie.sim3_exp(x), *S))

    want = np.asarray(jax.jacfwd(jf)(jnp.zeros(7)))
    St = _t(*S)
    got_r, got = jac_at_zero(lambda x: lie.sim3_log(*lie.sim3_compose(*lie.sim3_exp(x), *St)),
                             (7,), "cpu")
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got_r.numpy(), np.asarray(jf(jnp.zeros(7))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    T = np.asarray(jlie.se3_exp(jnp.asarray(xi_s[:6])))
    p = rng.normal(size=(5, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)

    def jp(x):
        Tx = jlie.se3_exp(x) @ T
        return p @ Tx[:3, :3].T + Tx[:3, 3]

    Tt, pt = _t(T, p)
    _, got_p = jac_at_zero(lambda x: pt @ (lie.se3_exp(x) @ Tt)[..., :3, :3].transpose(-1, -2)
                           + (lie.se3_exp(x) @ Tt)[..., None, :3, 3], (6,), "cpu")
    np.testing.assert_allclose(got_p.numpy(), np.asarray(jax.jacfwd(jp)(jnp.zeros(6))),
                               rtol=1e-4, atol=1e-4)


def test_inv3x3_matches_jax_and_inverts():
    rng = np.random.default_rng(9)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    got = linalg.inv3x3(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlinalg.inv3x3(jnp.asarray(A))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(A @ got, np.eye(3)[None].repeat(64, 0), atol=1e-4)
    # eps guards the all-zero padding block: finite (zero), as in JAX
    Z = np.zeros((2, 3, 3), np.float32)
    np.testing.assert_array_equal(linalg.inv3x3(torch.as_tensor(Z), eps=1e-12).numpy(),
                                  np.asarray(jlinalg.inv3x3(jnp.asarray(Z), eps=1e-12)))
