"""Intensity-centroid keypoint orientation, batched over all keypoints.

Replacement for ORBextractor's IC_Angle
(reference: src/orb_features/orb_extractor.cpp:18-45): moments m10/m01 of the 31x31
circular patch around each keypoint, angle = atan2(m01, m10). The reference loops rows
of the circular patch per keypoint; here we gather all patches at once and reduce with
precomputed coordinate/disk masks (two masked dot products per keypoint).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1  # 31


@functools.lru_cache(maxsize=1)
def _disk_masks():
    """(31,31) xw, yw weight maps: coordinate * inside-circular-patch indicator.

    The disk uses the same u_max row extents as the reference (circular patch of
    radius 15 defined via cvRound(sqrt(r^2 - v^2)) per row, orb_extractor.cpp:969-983).
    """
    ys, xs = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
    # Reference u_max construction (symmetric-by-construction variant).
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int64)
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH**2 - v**2)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    inside = np.abs(xs) <= umax[np.abs(ys)]
    # NOTE: cached values must be numpy (not jnp) — jnp constants created inside a jit
    # trace would leak tracers into later traces via the lru_cache.
    xw = (xs * inside).astype(np.float32)
    yw = (ys * inside).astype(np.float32)
    return xw, yw


def gather_patches(img: jnp.ndarray, xy: jnp.ndarray, patch: int, pad: int) -> jnp.ndarray:
    """Gather (N, patch, patch) windows centered at xy (N,2) int32 from (H, W) img.

    `pad` must be >= patch//2; the image is edge-padded by pad so out-of-range
    keypoints (there are none after border masking, but masked slots hold (0,0))
    read valid memory.
    """
    padded = jnp.pad(img, pad, mode="edge")
    half = patch // 2

    def one(p):
        x, y = p[0], p[1]
        return jax.lax.dynamic_slice(padded, (y + pad - half, x + pad - half), (patch, patch))

    return jax.vmap(one)(xy)


@functools.lru_cache(maxsize=2)
def _disk_masks_embedded(side: int, off: int):
    """(side, side) weight maps with the 31x31 disk embedded at row/col `off`
    (for consumers that share one window gather with BRIEF — the disk offsets
    -15..15 sit at window indices off..off+30)."""
    xw, yw = _disk_masks()
    out_x = np.zeros((side, side), np.float32)
    out_y = np.zeros((side, side), np.float32)
    out_x[off : off + PATCH, off : off + PATCH] = xw
    out_y[off : off + PATCH, off : off + PATCH] = yw
    return out_x, out_y


def ic_angles_from_windows(wins: jnp.ndarray, off: int) -> jnp.ndarray:
    """Orientation from pre-gathered (N, side, side) windows whose row/col 0
    is keypoint offset -(15 + off) — shares the BRIEF window gather instead of
    issuing a second per-keypoint gather (measured: the two separate gathers
    cost 9.5 ms/image; one fused gather 5.2 ms)."""
    xw, yw = _disk_masks_embedded(wins.shape[-1], off)
    m10 = jnp.sum(wins * xw[None], axis=(1, 2))
    m01 = jnp.sum(wins * yw[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def ic_angles(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Orientation (radians, in [-pi, pi]) for each keypoint. xy (N,2) int32."""
    patches = gather_patches(img, xy, PATCH, HALF_PATCH + 1)
    xw, yw = _disk_masks()
    m10 = jnp.sum(patches * xw[None], axis=(1, 2))
    m01 = jnp.sum(patches * yw[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)
