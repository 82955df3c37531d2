"""Pinhole camera projection/unprojection + distortion, batched JAX.

Replacement for the reference's scattered projection math
(reference: src/data/frame.cpp:277-337 IsInFrustum, :599-611 UnprojectStereo,
src/orb_features/orb_matcher.cpp projection loops, src/data/frame.cpp:614-641
UndistortKeyPoints). Everything here operates on whole feature/point tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx; 0 for mono

    @property
    def baseline(self):
        return self.bf / self.fx


def project(pts_cam: jnp.ndarray, K: Intrinsics):
    """(..., 3) camera-frame points -> (u, v, depth). No distortion (rectified input)."""
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    return u, v, z


def project_stereo(pts_cam: jnp.ndarray, K: Intrinsics):
    """Returns (u, v, u_right, depth) — u_right = u - bf/z (frame.cpp stereo model)."""
    u, v, z = project(pts_cam, K)
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = u - K.bf * inv_z
    return u, v, ur, z


def backproject(u: jnp.ndarray, v: jnp.ndarray, depth: jnp.ndarray, K: Intrinsics) -> jnp.ndarray:
    """Pixel + depth -> camera-frame 3D point (frame.cpp:599-611 UnprojectStereo)."""
    x = (u - K.cx) * depth / K.fx
    y = (v - K.cy) * depth / K.fy
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(u: jnp.ndarray, ur: jnp.ndarray, K: Intrinsics) -> jnp.ndarray:
    """Stereo disparity -> depth: z = bf / (u - ur)."""
    disp = u - ur
    return jnp.where(disp > 1e-6, K.bf / jnp.maximum(disp, 1e-6), -1.0)


def undistort_points(uv: jnp.ndarray, K: Intrinsics, dist: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Iterative undistortion of (..., 2) pixel points.

    dist = (k1, k2, p1, p2, k3). Replaces cv::undistortPoints usage in
    frame.cpp:614-641. Fixed iteration count (XLA-friendly); identity when dist == 0.
    """
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0 = (uv[..., 0] - K.cx) / K.fx
    y0 = (uv[..., 1] - K.cy) / K.fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_r = 1.0 / jnp.maximum(radial, 1e-9)
        x = (x0 - dx) * inv_r
        y = (y0 - dy) * inv_r
    u = x * K.fx + K.cx
    v = y * K.fy + K.cy
    return jnp.stack([u, v], axis=-1)


def in_image_bounds(u, v, width, height, margin=0.0):
    return (u >= margin) & (u < width - margin) & (v >= margin) & (v < height - margin)
