"""Batched Horn-alignment Sim3 RANSAC for loop closing.

Replacement for Sim3Solver (reference: src/solvers/sim3solver.{h,cpp}):
Horn 1987 closed-form similarity from 3-point sets (:230-341) inside sequential RANSAC
(:142-211). Here every hypothesis is computed at once: batched centroid/M-matrix,
quaternion from the dominant eigenvector of the 4x4 N matrix (batched eigh), optional
scale (fixed to 1 for stereo/RGB-D, slam_system.cpp:63-66), then reprojection-error
inlier counting in BOTH images (:344-368).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import sim3 as s3
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.utils.precision import einsum as _einsum


class Sim3Result(NamedTuple):
    R: jnp.ndarray          # (3,3) rotation mapping frame-2 points into frame 1
    t: jnp.ndarray          # (3,)
    s: jnp.ndarray          # () scale
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool


def horn_alignment(p1: jnp.ndarray, p2: jnp.ndarray, fix_scale: bool):
    """Batched Horn closed form: align (..., S, 3) p2 -> p1. Returns R, t, s with
    p1 ~ s * R @ p2 + t."""
    c1 = jnp.mean(p1, axis=-2, keepdims=True)
    c2 = jnp.mean(p2, axis=-2, keepdims=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = _einsum("...si,...sj->...ij", q2, q1)  # (...,3,3) — orientation: R maps 2 -> 1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    _, vecs = jnp.linalg.eigh(N)
    q = vecs[..., :, -1]  # largest eigenvalue -> (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
    if fix_scale:
        s = jnp.ones(R.shape[:-2], R.dtype)
    else:
        # Horn symmetric scale: sqrt(sum|q1|^2 / sum|R q2|^2) -> sum|q2|^2
        num = jnp.sum(q1 * q1, axis=(-1, -2))
        den = jnp.maximum(jnp.sum(q2 * q2, axis=(-1, -2)), 1e-12)
        s = jnp.sqrt(num / den)
    t = c1[..., 0, :] - s[..., None] * _einsum("...ij,...j->...i", R, c2[..., 0, :])
    return R, t, s


def solve_sim3_ransac(
    pts1: jnp.ndarray,        # (N, 3) points in keyframe-1 camera frame
    pts2: jnp.ndarray,        # (N, 3) matched points in keyframe-2 camera frame
    uv1: jnp.ndarray,         # (N, 2) pixel measurements in image 1
    uv2: jnp.ndarray,         # (N, 2) pixel measurements in image 2
    sigma2_1: jnp.ndarray,    # (N,) per-match sigma^2 (image 1 octave)
    sigma2_2: jnp.ndarray,    # (N,)
    mask: jnp.ndarray,        # (N,) valid matches
    K: Intrinsics,
    key: jax.Array,
    fix_scale: bool = True,
    n_hypotheses: int = 256,
    min_inliers: int = 20,    # loop_closer.cpp:339
    err_mult: float = 9.21,   # sim3solver.cpp:89-90
) -> Sim3Result:
    N = pts1.shape[0]
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hypotheses, 3), replace=True, p=probs)
    R, t, s = horn_alignment(pts1[idx], pts2[idx], fix_scale)  # (H,3,3),(H,3),(H,)

    def project(P):  # (..., 3) cam-frame -> pixels
        z = jnp.where(P[..., 2] > 1e-6, P[..., 2], 1e-6)
        return jnp.stack(
            [K.fx * P[..., 0] / z + K.cx, K.fy * P[..., 1] / z + K.cy], axis=-1
        )

    # err in image 1: project s R p2 + t
    p2_in_1 = s[:, None, None] * _einsum("hij,nj->hni", R, pts2) + t[:, None, :]
    e1 = jnp.sum((project(p2_in_1) - uv1[None]) ** 2, axis=-1)
    # err in image 2: project (1/s) R^T (p1 - t)
    Rt = jnp.swapaxes(R, -1, -2)
    p1_in_2 = _einsum("hij,hnj->hni", Rt, pts1[None] - t[:, None, :]) / s[:, None, None]
    e2 = jnp.sum((project(p1_in_2) - uv2[None]) ** 2, axis=-1)
    inl = (e1 < err_mult * sigma2_1[None]) & (e2 < err_mult * sigma2_2[None]) & mask[None]
    counts = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(counts)
    # GN refinement over the inlier set (the reference refines the RANSAC Sim3
    # with g2o OptimizeSim3, loop_closer.cpp:430-440 / optimizer.cpp:962-1152)
    Rb, tb, sb, inl_b, cnt_b = refine_sim3(
        R[best], t[best], s[best], pts1, pts2, uv1, uv2,
        sigma2_1, sigma2_2, inl[best], K,
        fix_scale=fix_scale, err_mult=err_mult,
    )
    return Sim3Result(
        R=Rb, t=tb, s=sb,
        inliers=inl_b, n_inliers=cnt_b,
        ok=cnt_b >= min_inliers,
    )


def refine_sim3(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    s0: jnp.ndarray,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    sigma2_1: jnp.ndarray,
    sigma2_2: jnp.ndarray,
    mask: jnp.ndarray,
    K: Intrinsics,
    fix_scale: bool = True,
    n_iters: int = 10,
    err_mult: float = 9.21,
    huber2: float = 10.0,     # chi2 kernel delta^2 (optimizer.cpp:1019 deltaHuber=sqrt(10))
):
    """Gauss-Newton Sim3 refinement on reprojection error in BOTH images — the
    Batched equivalent of Optimizer::OptimizeSim3 (optimizer.cpp:962-1152): forward
    (exp(xi) . S) updates of the 7-dof tangent (rot, trans, log-scale; the scale
    row is zeroed when fix_scale), Huber-weighted normal equations, inliers
    re-gated each iteration. Fixed shapes, fixed iteration count."""

    def project(P):
        z = jnp.where(P[..., 2] > 1e-6, P[..., 2], 1e-6)
        return jnp.stack(
            [K.fx * P[..., 0] / z + K.cx, K.fy * P[..., 1] / z + K.cy], axis=-1
        )

    inv_s2 = jnp.concatenate([1.0 / sigma2_1, 1.0 / sigma2_2])  # (2N,)

    def residuals(xi, S_flat):
        S = s3.make(S_flat[:9].reshape(3, 3), S_flat[9:12], S_flat[12])
        S2 = s3.compose(s3.exp(xi), S)
        r1 = project(s3.apply(S2, pts2)) - uv1       # (N, 2)
        r2 = project(s3.apply(s3.inverse(S2), pts1)) - uv2
        return jnp.concatenate([r1, r2], axis=0)     # (2N, 2)

    def chi2_of(r):
        return jnp.sum(r * r, axis=-1) * inv_s2      # (2N,)

    def body(_, carry):
        S_flat, inl = carry
        zero = jnp.zeros(7, S_flat.dtype)
        r = residuals(zero, S_flat)                  # (2N, 2)
        J = jax.jacfwd(residuals)(zero, S_flat)      # (2N, 2, 7)
        chi2 = chi2_of(r)
        w_huber = jnp.where(chi2 > huber2, jnp.sqrt(huber2 / jnp.maximum(chi2, 1e-12)), 1.0)
        w = inv_s2 * w_huber * inl.astype(S_flat.dtype)
        H = _einsum("nri,nrj,n->ij", J, J, w)
        g = _einsum("nri,nr,n->i", J, r, w)
        if fix_scale:
            # pin the scale direction: zero row+col 7 (incl. cross terms), unit
            # diagonal, zero gradient -> delta[6] == 0 exactly
            e = jnp.zeros(7).at[6].set(1.0)
            keep = 1.0 - e
            H = H * keep[:, None] * keep[None, :] + jnp.outer(e, e)
            g = g * keep
        delta = -jnp.linalg.solve(H + 1e-6 * jnp.eye(7), g)
        S = s3.make(S_flat[:9].reshape(3, 3), S_flat[9:12], S_flat[12])
        S2 = s3.compose(s3.exp(delta), S)
        S_flat2 = jnp.concatenate([S2["R"].reshape(-1), S2["t"], S2["s"][None]])
        # re-gate inliers with the updated transform (chi2 already sigma-scaled,
        # so the gate is err_mult directly, matching the RANSAC inlier test)
        r_new = residuals(jnp.zeros(7, S_flat.dtype), S_flat2)
        c_new = chi2_of(r_new)
        both = (c_new[: pts1.shape[0]] < err_mult) & (c_new[pts1.shape[0]:] < err_mult)
        inl2 = both & mask
        inl_full = jnp.concatenate([inl2, inl2])
        return S_flat2, inl_full

    S_flat0 = jnp.concatenate(
        [R0.reshape(-1), t0, jnp.asarray(s0, R0.dtype)[None]]
    ).astype(jnp.float32)
    inl0 = jnp.concatenate([mask, mask])
    S_flat, inl_full = jax.lax.fori_loop(0, n_iters, body, (S_flat0, inl0))
    inl = inl_full[: pts1.shape[0]]
    return (
        S_flat[:9].reshape(3, 3),
        S_flat[9:12],
        S_flat[12],
        inl,
        jnp.sum(inl.astype(jnp.int32)),
    )
