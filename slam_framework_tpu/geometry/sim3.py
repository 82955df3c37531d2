"""Sim3 (similarity transform) operations for loop closing and pose-graph optimization.

Replacement for g2o::Sim3 (reference:
third_party/g2o/g2o/types/sim3/sim3.h, used by src/optimizer/optimizer.cpp:718-1152 and
src/solvers/sim3solver.cpp). A Sim3 element is stored as (R, t, s): a rotation, a
translation and a positive scale; action on a point is  x -> s * R @ x + t.

The exp/log maps follow the standard Sim3 parameterization with 7-vector
(omega, upsilon, sigma): rotation, translation, log-scale.
"""

from __future__ import annotations

import jax.numpy as jnp

from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm

from slam_framework_tpu.geometry import se3

_EPS = 1e-8


def make(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> dict:
    """Pack a Sim3 as a pytree dict {'R': (...,3,3), 't': (...,3), 's': (...,)}."""
    return {"R": R, "t": t, "s": jnp.asarray(s)}


def identity(batch_shape=(), dtype=jnp.float32) -> dict:
    return {
        "R": jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3)),
        "t": jnp.zeros(batch_shape + (3,), dtype),
        "s": jnp.ones(batch_shape, dtype),
    }


def apply(S: dict, pts: jnp.ndarray) -> jnp.ndarray:
    """Action on (..., N, 3) points: s*R@x + t."""
    return (
        S["s"][..., None, None] * _einsum("...ij,...nj->...ni", S["R"], pts)
        + S["t"][..., None, :]
    )


def compose(A: dict, B: dict) -> dict:
    """A after B: (A*B)(x) = A(B(x))."""
    return {
        "R": _mm(A["R"], B["R"]),
        "t": A["s"][..., None] * _einsum("...ij,...j->...i", A["R"], B["t"]) + A["t"],
        "s": A["s"] * B["s"],
    }


def inverse(S: dict) -> dict:
    Rt = jnp.swapaxes(S["R"], -1, -2)
    inv_s = 1.0 / jnp.maximum(S["s"], _EPS)
    return {
        "R": Rt,
        "t": -inv_s[..., None] * _einsum("...ij,...j->...i", Rt, S["t"]),
        "s": inv_s,
    }


def from_se3(T: jnp.ndarray) -> dict:
    R, t = se3.mat_to_rt(T)
    return {"R": R, "t": t, "s": jnp.ones(T.shape[:-2], T.dtype)}


def to_se3(S: dict) -> jnp.ndarray:
    """Project to SE3 by folding the scale into the translation: [R | t/s].

    This is the correction applied to keyframe poses after essential-graph optimization
    (reference: optimizer.cpp:925-940 — Tiw = [R, t/s]).
    """
    return se3.rt_to_mat(S["R"], S["t"] / jnp.maximum(S["s"][..., None], _EPS))


def exp(v: jnp.ndarray) -> dict:
    """Sim3 exponential: (..., 7) = (omega, upsilon, sigma) -> Sim3."""
    w, u, sigma = v[..., :3], v[..., 3:6], v[..., 6]
    s = jnp.exp(sigma)
    R = se3.so3_exp(w)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = se3.hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), W.shape)

    # W-matrix of Sim3 exp (generalization of SO3 left Jacobian with scale).
    # Coefficients per Strasdat's thesis; Taylor fallbacks for small sigma/theta.
    small_sigma = jnp.abs(sigma) < 1e-5
    small_theta = theta < 1e-5

    A_ss = jnp.where(small_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / jnp.where(small_sigma, 1.0, sigma))

    sig2t2 = sigma * sigma + theta2
    sig2t2 = jnp.maximum(sig2t2, _EPS)
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    # coefficients for the general case
    A_gen = (a * sigma + (1.0 - b) * theta) / jnp.maximum(theta * sig2t2, _EPS)
    B_gen = (A_ss - ((b - 1.0) * sigma + a * theta) / sig2t2) / jnp.maximum(theta2, _EPS)
    # small-theta fallbacks (any sigma)
    A_st = jnp.where(
        small_sigma,
        0.5 + sigma / 6.0,
        ((sigma - 1.0) * s + 1.0) / jnp.where(small_sigma, 1.0, jnp.maximum(sigma * sigma, _EPS)),
    )
    B_st = jnp.where(
        small_sigma,
        1.0 / 6.0 + sigma / 24.0,
        (A_ss - A_st * 1.0 - 0.0) * 0.0 + ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / jnp.where(small_sigma, 1.0, jnp.maximum(sigma * sigma * sigma, _EPS)),
    )
    A = jnp.where(small_theta, A_st, A_gen)
    B = jnp.where(small_theta, B_st, B_gen)
    Wmat = A_ss[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2
    t = _einsum("...ij,...j->...i", Wmat, u)
    return {"R": R, "t": t, "s": s}


def log(S: dict) -> jnp.ndarray:
    """Sim3 logarithm: Sim3 -> (..., 7). Inverse of `exp` (via linear solve for u)."""
    w = se3.so3_log(S["R"])
    sigma = jnp.log(jnp.maximum(S["s"], _EPS))
    # Recompute the W matrix from (w, sigma) and solve W u = t.
    v_ws = jnp.concatenate([w, jnp.zeros_like(w), sigma[..., None]], axis=-1)
    Wmat = _w_matrix(v_ws)
    u = jnp.linalg.solve(Wmat, S["t"][..., None])[..., 0]
    return jnp.concatenate([w, u, sigma[..., None]], axis=-1)


def _w_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """Extract just the W matrix used by exp (for log's linear solve)."""
    w, sigma = v[..., :3], v[..., 6]
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = se3.hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), W.shape)
    small_sigma = jnp.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    A_ss = jnp.where(small_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / jnp.where(small_sigma, 1.0, sigma))
    sig2t2 = jnp.maximum(sigma * sigma + theta2, _EPS)
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    A_gen = (a * sigma + (1.0 - b) * theta) / jnp.maximum(theta * sig2t2, _EPS)
    B_gen = (A_ss - ((b - 1.0) * sigma + a * theta) / sig2t2) / jnp.maximum(theta2, _EPS)
    A_st = jnp.where(
        small_sigma,
        0.5 + sigma / 6.0,
        ((sigma - 1.0) * s + 1.0) / jnp.where(small_sigma, 1.0, jnp.maximum(sigma * sigma, _EPS)),
    )
    B_st = jnp.where(
        small_sigma,
        1.0 / 6.0 + sigma / 24.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / jnp.where(small_sigma, 1.0, jnp.maximum(sigma * sigma * sigma, _EPS)),
    )
    A = jnp.where(small_theta, A_st, A_gen)
    B = jnp.where(small_theta, B_st, B_gen)
    return A_ss[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2
