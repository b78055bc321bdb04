"""SO3 / SE3 / Sim3 operations on torch tensors (port of
``vo_slam_test_tpu/lie.py``).

Conventions as in the JAX package: rotations are 3x3, poses 4x4 homogeneous;
twists are (rho, phi) = (translation, rotation); quaternions (qx, qy, qz, qw).
Every op is batched over leading dimensions and branch-free (``torch.where``),
so nothing reads a value back to the host. Where a branch divides by a small
angle, its input is masked first (``torch.where`` on the argument, then on
the result), so forward-mode derivatives (``torch.func.jacfwd``) at a zero
tangent stay finite, as the JAX package's do.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. W: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch_shape, 3, 3)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), f32-stable
    (Taylor below t=0.5, half-angle form for B)."""
    small = theta2 < 0.25
    t2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(t2_safe)
    t4 = theta2 * theta2
    a = torch.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0, torch.sin(theta) / theta)
    tiny = theta2 < _EPS
    t2_safe2 = torch.where(tiny, 1.0, theta2)
    half_sin = torch.sin(0.5 * torch.sqrt(t2_safe2))
    b = torch.where(tiny, 0.5 - theta2 / 24.0, 2.0 * half_sin * half_sin / t2_safe2)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
        (theta - torch.sin(theta)) / (t2_safe * theta),
    )
    return a, b, c


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. phi: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(phi)
    W2 = W @ W
    return _eye3(phi, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3). R: (..., 3, 3) -> (..., 3). Safe up to ~pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    skew = 0.5 * (R - R.transpose(-1, -2))
    v = vee(skew)  # sin(theta) * axis
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    sin_safe = torch.where(torch.abs(sin_t) < 1e-7, 1.0, sin_t)
    scale = torch.where(small, 1.0 + theta**2 / 6.0, theta / sin_safe)
    phi_generic = v * scale[..., None]
    S = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    denom = torch.where(torch.abs(1.0 - cos_t) < _EPS, 1.0, 1.0 - cos_t)
    axis2 = torch.clamp((diag - cos_t[..., None]) / denom[..., None], 0.0, 1.0)
    axis = torch.sqrt(axis2)
    sign_src = torch.where(torch.abs(v) > 1e-12, torch.sign(v), 1.0)
    phi_pi = axis * sign_src * theta[..., None]
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(phi)
    W2 = W @ W
    return _eye3(phi, W.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 0.25
    t2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(t2_safe)
    half = 0.5 * theta
    t4 = theta2 * theta2
    safe_sin = torch.where(torch.abs(torch.sin(half)) < 1e-7, 1.0, torch.sin(half))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0,
        (1.0 - half * torch.cos(half) / safe_sin) / t2_safe,
    )
    W = hat(phi)
    W2 = W @ W
    return _eye3(phi, W.shape[:-2]) - 0.5 * W + cot_term[..., None, None] * W2


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    # [0, 0, 0, 1] built on the device (writing a Python scalar into a CUDA
    # tensor would be a host sync)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(R.shape[:-2] + (1, 4))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi: (..., 6) twist (rho, phi) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(phi), rho)
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T: (..., 4, 4) -> (..., 6) twist (rho, phi)."""
    phi = so3_log(T[..., :3, :3])
    rho = torch.einsum("...ij,...j->...i", _left_jacobian_inv(phi), T[..., :3, 3])
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to a single point (..., 3)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) by a quaternion round trip
    (keeps f32 pose chains from drifting off the manifold)."""
    R = quat_to_mat(mat_to_quat(T[..., :3, :3]))
    return rt_to_mat(R, T[..., :3, 3])


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) as (qx, qy, qz, qw);
    Shepperd's method, branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    d0 = 4.0 * torch.clamp(qw0, min=_EPS)
    c0 = torch.stack([(m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0, qw0], -1)

    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    d1 = 4.0 * torch.clamp(qx1, min=_EPS)
    c1 = torch.stack([qx1, (m01 + m10) / d1, (m02 + m20) / d1, (m21 - m12) / d1], -1)

    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    d2 = 4.0 * torch.clamp(qy2, min=_EPS)
    c2 = torch.stack([(m01 + m10) / d2, qy2, (m12 + m21) / d2, (m02 - m20) / d2], -1)

    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5
    d3 = 4.0 * torch.clamp(qz3, min=_EPS)
    c3 = torch.stack([(m02 + m20) / d3, (m12 + m21) / d3, qz3, (m10 - m01) / d3], -1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, c0, torch.where(use1, c1, torch.where(use2, c2, c3)))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(qx, qy, qz, qw) (..., 4) -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# Sim(3): the loop-closing Sim3 solvers and the essential graph
# (reference: sim3Solver.cpp, optimizer_ceres.h:211-311)
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, pts):
    """Apply similarity (s, R, t) to points (..., N, 3)."""
    return s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def sim3_inverse(s, R, t):
    s_inv = 1.0 / s
    R_inv = R.transpose(-1, -2)
    t_inv = -s_inv[..., None] * torch.einsum("...ij,...j->...i", R_inv, t)
    return s_inv, R_inv, t_inv


def sim3_compose(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1) o (s2,R2,t2): first apply 2, then 1."""
    s = s1 * s2
    R = R1 @ R2
    t = s1[..., None] * torch.einsum("...ij,...j->...i", R1, t2) + t1
    return s, R, t


def _sim3_w(s, sigma, phi):
    """The Sim3 translation matrix W(sigma, phi) (Strasdat's thesis) with
    the JAX package's Taylor/AD-safe blends."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small_th = theta2 < 1e-10
    theta = torch.sqrt(torch.where(small_th, 1.0, theta2))
    theta = torch.where(small_th, 1e-5, theta)
    W = hat(phi)
    W2 = W @ W
    small_sig = torch.abs(sigma) < 1e-5
    A_ = torch.where(small_sig, 1.0 + sigma / 2.0,
                     (s - 1.0) / torch.where(small_sig, 1.0, sigma))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = sigma * sigma + theta2
    denom = torch.where(denom < _EPS, 1.0, denom)
    t2_safe = torch.where(small_th, 1.0, theta2)
    a = s * sin_t
    b = s * cos_t
    c_coef = torch.where(small_th, 0.5, (a * sigma + (1.0 - b) * theta) / (denom * theta))
    d_coef = torch.where(small_th, 1.0 / 6.0,
                         (A_ - (b - 1.0) * sigma / denom - a * theta / denom) / t2_safe)
    return (A_[..., None, None] * _eye3(phi, W.shape[:-2]) + c_coef[..., None, None] * W
            + d_coef[..., None, None] * W2)


def sim3_exp(xi7: torch.Tensor):
    """7-vector (rho, phi, sigma) -> (s, R, t)."""
    rho, phi, sigma = xi7[..., :3], xi7[..., 3:6], xi7[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", _sim3_w(s, sigma, phi), rho)
    return s, R, t


def sim3_log(s, R, t) -> torch.Tensor:
    """(s, R, t) -> 7-vector (rho, phi, sigma). Inverse of sim3_exp."""
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = torch.linalg.solve_ex(_sim3_w(s, sigma, phi), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
