"""Batched two-view DLT triangulation.

Replacement for the per-match 4x4 SVD triangulation in the reference
(reference: src/core/local_mapper.cpp:375-392, src/util/initializer.cpp:738-751).
The reference triangulates one match at a time with cv::SVD; here whole match tensors
are triangulated at once. Instead of SVD we solve the 4x4 normal equations A^T A x = 0
via the eigenvector of the smallest eigenvalue, or — faster and equally accurate for
well-conditioned pairs — the inhomogeneous 3x3 solve. We use the inhomogeneous form
(set w=1), which is exact for finite points and maps to batched 3x3 solves.
"""

from __future__ import annotations

import jax.numpy as jnp

from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """Batched DLT: P1/P2 (..., 3, 4) projection matrices, uv1/uv2 (..., N, 2) pixels.

    Returns (..., N, 3) world points. Uses the homogeneous 4x4 system solved via
    the smallest eigenvector of A^T A (self-adjoint eigendecomposition, batched).
    """
    # Rows of A: u * P[2] - P[0]; v * P[2] - P[1]  (for both views)
    def two_rows(P, uv):
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        r0 = u * P[..., None, 2, :] - P[..., None, 0, :]
        r1 = v * P[..., None, 2, :] - P[..., None, 1, :]
        return r0, r1

    a0, a1 = two_rows(P1, uv1)
    a2, a3 = two_rows(P2, uv2)
    A = jnp.stack([a0, a1, a2, a3], axis=-2)  # (..., N, 4, 4)
    # Row-normalize: keeps the fp32 normal equations well-conditioned (raw rows
    # carry fx-scale entries whose squares eat most of the mantissa).
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12)
    # Inhomogeneous LS (w = 1): Householder QR on the 4x3 system, three unrolled
    # reflections of pure elementwise math. This avoids both the ~100 ms batched
    # eigh (iterative sweeps) and the condition-number squaring of the 3x3
    # normal equations (which loses cm-level accuracy in fp32 for some pairs).
    # Only points at infinity need the homogeneous form, and the callers'
    # depth/parallax checks cull those anyway.
    Mb = jnp.concatenate([A[..., :3], -A[..., 3:4]], axis=-1)  # (..., N, 4, 4) [M | b]
    for k in range(3):
        col = Mb[..., :, k]
        x = jnp.where(jnp.arange(4) >= k, col, 0.0)
        nx = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        xk = x[..., k : k + 1]
        alpha = jnp.where(xk >= 0, -nx, nx)
        e = (jnp.arange(4) == k).astype(Mb.dtype)
        v = x - alpha * e
        vn2 = jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-30)
        vtM = _einsum("...r,...rc->...c", v, Mb)
        Mb = Mb - 2.0 * v[..., :, None] * vtM[..., None, :] / vn2[..., None]

    def _safe(d):
        return jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)

    x2 = Mb[..., 2, 3] / _safe(Mb[..., 2, 2])
    x1 = (Mb[..., 1, 3] - Mb[..., 1, 2] * x2) / _safe(Mb[..., 1, 1])
    x0 = (Mb[..., 0, 3] - Mb[..., 0, 1] * x1 - Mb[..., 0, 2] * x2) / _safe(Mb[..., 0, 0])
    return jnp.stack([x0, x1, x2], axis=-1)


def reprojection_error(P: jnp.ndarray, pts_h: jnp.ndarray, uv: jnp.ndarray):
    """Project homogeneous-ified world points with (...,3,4) P; return squared pixel error."""
    ones = jnp.ones(pts_h.shape[:-1] + (1,), pts_h.dtype)
    xh = jnp.concatenate([pts_h, ones], axis=-1)
    proj = _einsum("...ij,...nj->...ni", P, xh)
    z = proj[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = proj[..., 0] / z_safe
    v = proj[..., 1] / z_safe
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return err2, z


def parallax_cosine(c1: jnp.ndarray, c2: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """cos of the ray angle between camera centers c1,c2 (...,3) and points (...,N,3).

    Mirrors the parallax checks in local_mapper.cpp:336-374 and initializer.cpp CheckRT.
    """
    r1 = pts - c1[..., None, :]
    r2 = pts - c2[..., None, :]
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    return jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
