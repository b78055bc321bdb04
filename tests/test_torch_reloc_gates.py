"""The port's relocalization top-up gates (pipeline/system.py::
reloc_topup_cascade) against a literal transcription of the reference's
branches (visualOdometry.cpp:352-384) and against the JAX package's cascade,
over the randomized (n0, add1, n1, add2, n2) grid of tests/test_reloc_gates.py
with stubbed top-ups. The port reads each gate back to the host and runs the
second top-up only when its gate passes; the final count, the adopted stage
and whether the second top-up ran must agree with the reference."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vo_slam_test_tpu.pipeline.system import reloc_topup_cascade as j_cascade
from vo_slam_test_tpu_torch.pipeline.system import reloc_topup_cascade


def reference(n0, add1, n1, add2, n2):
    """visualOdometry.cpp:352-384 verbatim (n0 < 50: the caller's gate)."""
    inliers = n0
    if n0 + add1 >= 50:
        inliers = n1
        if 30 < inliers < 50:
            if inliers + add2 >= 50:
                inliers = n2
    return inliers


@jax.jit
def _jax_cascade(n0, add1, n1, add2, n2):
    T0, T1, T2 = (jnp.eye(4) * (i + 1.0) for i in range(3))
    kp0, kp1, kp2 = (jnp.full((4,), i, jnp.int32) for i in range(3))
    return j_cascade(lambda T, kp: (T1, kp1, n1, add1), lambda T, kp: (T2, kp2, n2, add2),
                     T0, kp0, n0)


def test_randomized_grid():
    grid = [0, 9, 10, 29, 30, 31, 49, 50, 51, 80]
    rng = np.random.default_rng(3)
    cases = list(itertools.product(grid, [0, 15, 40], grid, [0, 15, 40], grid))
    rng.shuffle(cases)
    T0, T1, T2 = (torch.eye(4) * (i + 1.0) for i in range(3))
    kp0, kp1, kp2 = (torch.full((4,), i, dtype=torch.int32) for i in range(3))
    checked = 0
    for n0, add1, n1, add2, n2 in cases[:300]:
        if n0 >= 50:
            continue  # the caller's gate
        calls = []

        def top1(T, kp):
            calls.append(1)
            assert torch.equal(T, T0) and torch.equal(kp, kp0)
            return T1, kp1, torch.tensor(n1), torch.tensor(add1)

        def top2(T, kp):
            calls.append(2)
            assert torch.equal(T, T1) and torch.equal(kp, kp1)  # from the first top-up's state
            return T2, kp2, torch.tensor(n2), torch.tensor(add2)

        T, kp, n = reloc_topup_cascade(top1, top2, T0, kp0, torch.tensor(n0))
        want = reference(n0, add1, n1, add2, n2)
        assert int(n) == want, (n0, add1, n1, add2, n2, int(n), want)
        stage = int(kp[0])
        assert torch.equal(T, (T0, T1, T2)[stage])
        vals = [n0, n1, n2]
        if vals.count(want) == 1:
            assert stage == {n0: 0, n1: 1, n2: 2}[want]
        # the second top-up runs exactly when its gate is reached
        assert calls == ([1, 2] if (n0 + add1 >= 50 and 30 < n1 < 50) else [1])
        Tj, kpj, nj = _jax_cascade(*(jnp.asarray(v, jnp.int32) for v in (n0, add1, n1, add2, n2)))
        assert (int(nj), int(np.asarray(kpj)[0])) == (int(n), stage)
        np.testing.assert_array_equal(np.asarray(Tj), T.numpy())
        checked += 1
    assert checked > 200
