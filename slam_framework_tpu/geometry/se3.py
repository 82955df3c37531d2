"""SO3/SE3 Lie-group operations as pure, batchable JAX functions.

Replacement for the reference's g2o SE3Quat / Eigen types
(reference: third_party/g2o/g2o/types/types_six_dof_expmap.h, src/util/converter.cpp).
Everything is fp32, closed-form, and safe at small angles (Taylor fallbacks), so it can
sit inside jit/scan/vmap without data-dependent branches.

Conventions:
  - Rotations are 3x3 matrices; poses are 4x4 homogeneous matrices T = [[R, t], [0, 1]].
  - Twists are 6-vectors xi = (omega, upsilon): rotation first, translation second.
  - `exp` uses the SE3 exponential with the V matrix (left Jacobian of SO3), matching
    g2o's SE3Quat::exp semantics used by the reference optimizer (optimizer.cpp).
  - Retraction during optimization is LEFT-multiplicative: T <- exp(xi) @ T, matching
    g2o's VertexSE3Expmap::oplusImpl (third_party/g2o/g2o/types/types_six_dof_expmap.h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Numerically safe A = sin(t)/t, B = (1-cos t)/t^2, C = (1 - A)/t^2."""
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS * _EPS))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / jnp.maximum(theta2, _EPS * _EPS))
    return A, B, C


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """SO3 exponential map: (..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """SO3 logarithm: (..., 3, 3) -> (..., 3) axis-angle. Safe near 0 and pi.

    Written for differentiability (pose-graph Jacobians run jacfwd through this):
    every branch is finite for ALL inputs — jnp.where does not block NaN/inf
    gradients from the untaken branch, so arccos/sqrt are fed clamped arguments
    via the double-where pattern.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = axis * sin(theta)
    sin2 = jnp.sum(w_skew * w_skew, axis=-1)
    near_one = cos_theta > 1.0 - 1e-6   # theta < ~1.4e-3: series in sin^2
    near_pi = cos_theta < -1.0 + 1e-5
    mid = jnp.logical_not(near_one | near_pi)
    # --- mid branch: theta = atan2(sin, cos), scale = theta / sin ---
    sin_theta = jnp.sqrt(jnp.where(mid, jnp.maximum(sin2, 1e-12), 1.0))
    theta_mid = jnp.arctan2(sin_theta, jnp.where(mid, cos_theta, 0.0))
    scale_mid = theta_mid / sin_theta
    # --- near-identity branch: sin ~= theta, scale ~= 1 + theta^2/6 ---
    scale_small = 1.0 + sin2 / 6.0
    scale = jnp.where(near_one, scale_small, scale_mid)
    w_generic = w_skew * scale[..., None]
    # theta for the near-pi axis reconstruction (arccos fed a clamped argument)
    theta = jnp.arccos(jnp.clip(jnp.where(near_pi, cos_theta, 0.0), -1.0 + 1e-7, 1.0))
    # Near pi: axis from diagonal of (R + I)/2 = aa^T scaled
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    axis = jnp.sqrt(jnp.where(near_pi[..., None], jnp.maximum(axis2, 1e-12), 1.0))
    axis = jnp.where(near_pi[..., None], axis, 0.0)
    # Fix signs using off-diagonal sums (R + R^T has entries 2*a_i*a_j*(1-cos))
    s12 = R[..., 0, 1] + R[..., 1, 0]
    s13 = R[..., 0, 2] + R[..., 2, 0]
    s23 = R[..., 1, 2] + R[..., 2, 1]
    # Choose the largest axis component as positive, sign others consistently.
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    use_x = (ax >= ay) & (ax >= az)
    use_y = (~use_x) & (ay >= az)
    sy = jnp.where(use_x, jnp.sign(s12), jnp.where(use_y, 1.0, jnp.sign(s23)))
    sx = jnp.where(use_x, 1.0, jnp.where(use_y, jnp.sign(s12), jnp.sign(s13)))
    sz = jnp.where(use_x, jnp.sign(s13), jnp.where(use_y, jnp.sign(s23), 1.0))
    sx = jnp.where(sx == 0, 1.0, sx)
    sy = jnp.where(sy == 0, 1.0, sy)
    sz = jnp.where(sz == 0, 1.0, sz)
    w_pi = jnp.stack([sx * ax, sy * ay, sz * az], axis=-1) * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian V of SO3 such that exp_se3((w, u)) has translation V @ u."""
    theta2 = jnp.sum(w * w, axis=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * W2


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE3 exponential: (..., 6) twist (omega, upsilon) -> (..., 4, 4)."""
    w, u = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = _einsum("...ij,...j->...i", V, u)
    return rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE3 logarithm: (..., 4, 4) -> (..., 6) twist (omega, upsilon)."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    V = so3_left_jacobian(w)
    u = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([w, u], axis=-1)


def rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def mat_to_rt(T: jnp.ndarray):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    R, t = mat_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -_einsum("...ij,...j->...i", Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) @ (..., 4, 4) at pinned HIGHEST precision.

    NEVER compose SE3 matrices with a bare `@` inside jitted code: the default
    accelerator matmul precision rounds f32 operands (TF32 on the H100, bf16
    passes on some other accelerators), and
    Tcw translation components grow with distance from the world origin — at
    100 m out, one bf16 compose injects ~0.4 m of translation noise and
    ~1e-2 of rotation orthonormality drift (measured: pose_opt returned an R
    with singular values {1.0, 1.0, 0.996} on the r3 bench; the map inherits
    the distortion and tracking collapses within ~60 frames)."""
    return _mm(A, B)


def reorthonormalize(T: jnp.ndarray) -> jnp.ndarray:
    """Project the rotation block of (..., 4, 4) back onto SO(3).

    Two Newton iterations of the polar decomposition, R <- R (3I - R^T R) / 2:
    each squares the orthonormality error, so 1e-2 drift -> ~1e-8 (f32 floor).
    Cheap (3x3 ops) — run after optimizer retraction chains and long
    velocity-composition chains rather than trusting f32 closure."""
    R, t = mat_to_rt(T)
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    for _ in range(2):
        R = _mm(R, (3.0 * eye3 - _mm(jnp.swapaxes(R, -1, -2), R))) * 0.5
    return rt_to_mat(R, t)


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to (..., N, 3) (or (..., 3)) points."""
    R, t = mat_to_rt(T)
    return _einsum("...ij,...nj->...ni", R, jnp.atleast_2d(pts)) + t[..., None, :]


def rotation_to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), KITTI/TUM export convention."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Branch-free Shepperd method: compute all four candidates, pick the best-conditioned.
    qw2 = jnp.maximum(0.0, 1.0 + tr) * 0.25
    qx2 = jnp.maximum(0.0, 1.0 + m00 - m11 - m22) * 0.25
    qy2 = jnp.maximum(0.0, 1.0 - m00 + m11 - m22) * 0.25
    qz2 = jnp.maximum(0.0, 1.0 - m00 - m11 + m22) * 0.25
    qw = jnp.sqrt(qw2)
    qx = jnp.sqrt(qx2)
    qy = jnp.sqrt(qy2)
    qz = jnp.sqrt(qz2)
    # Sign fix against the dominant component.
    case = jnp.argmax(jnp.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)
    sgn = jnp.sign
    qw_c0, qx_c0, qy_c0, qz_c0 = qw, qx * sgn(m21 - m12), qy * sgn(m02 - m20), qz * sgn(m10 - m01)
    qw_c1, qx_c1, qy_c1, qz_c1 = qw * sgn(m21 - m12), qx, qy * sgn(m01 + m10), qz * sgn(m02 + m20)
    qw_c2, qx_c2, qy_c2, qz_c2 = qw * sgn(m02 - m20), qx * sgn(m01 + m10), qy, qz * sgn(m12 + m21)
    qw_c3, qx_c3, qy_c3, qz_c3 = qw * sgn(m10 - m01), qx * sgn(m02 + m20), qy * sgn(m12 + m21), qz
    quats = jnp.stack(
        [
            jnp.stack([qx_c0, qy_c0, qz_c0, qw_c0], axis=-1),
            jnp.stack([qx_c1, qy_c1, qz_c1, qw_c1], axis=-1),
            jnp.stack([qx_c2, qy_c2, qz_c2, qw_c2], axis=-1),
            jnp.stack([qx_c3, qy_c3, qz_c3, qw_c3], axis=-1),
        ],
        axis=-2,
    )
    q = jnp.take_along_axis(quats, case[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    norm = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(norm, _EPS)
