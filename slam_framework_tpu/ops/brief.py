"""Rotated BRIEF (rBRIEF) 256-bit descriptors, batched over all keypoints.

Replacement for ORBextractor::computeOrbDescriptor
(reference: src/orb_features/orb_extractor.cpp:49-88) using the standard 256-pair ORB
sampling pattern (`orb_pattern.npy` — the public OpenCV `bit_pattern_31_` constant,
coordinates in [-13, 12], also hardcoded in the reference :91-349). Each pair's two
sample points are rotated by the keypoint orientation (rounded to integer offsets,
matching the reference's cvRound sampling), read from the blurred image, and compared:
bit = I(p_a) < I(p_b).

Descriptors are packed 256 bits -> 8 x uint32, little-endian within each word and
word-major in pair order: bit j of word w corresponds to pattern pair (w*32 + j).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

MAX_ROTATED_OFFSET = 19  # ceil(13 * sqrt(2)); image must be padded by this for sampling

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")


@functools.lru_cache(maxsize=1)
def pattern():
    """(256, 4) int32: x_a, y_a, x_b, y_b sample offsets per descriptor bit."""
    return np.load(_PATTERN_PATH)


def _einsum_nbk(samples: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
    """einsum('nbk,nb->nk') as a batched dot. HIGHEST precision: the selected
    samples feed strict `<` comparisons, and a TF32 product would round
    near-ties into flipped descriptor bits."""
    return jax.lax.dot_general(
        onehot[:, None, :], samples, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :]


@functools.lru_cache(maxsize=1)
def _pattern_cols():
    # numpy, not jnp: jnp constants made under a jit trace would leak via the cache
    p = pattern().astype(np.float32)
    return p[:, 0], p[:, 1], p[:, 2], p[:, 3]


ROTATION_BINS = 64  # 5.6 deg angle quantization (the original ORB paper uses 30)


@functools.lru_cache(maxsize=8)
def _binned_flat_idx(bins: int, side: int, pad: int):
    """(bins, 512) int32 flat within-window sample indices for each quantized
    rotation: [256 'a' samples | 256 'b' samples]. Precomputing the rotated
    pattern per angle bin (original ORB formulation) turns the per-keypoint
    rotated sampling into STATIC gathers the compiler lowers to slices.

    numpy, not jnp: cached constants must not capture tracers."""
    p = pattern().astype(np.float64)
    xa, ya, xb, yb = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    tables = []
    for b in range(bins):
        th = 2.0 * np.pi * b / bins
        ca, sa = np.cos(th), np.sin(th)

        def flat(px, py):
            rx = np.round(px * ca - py * sa).astype(np.int64)
            ry = np.round(px * sa + py * ca).astype(np.int64)
            return (ry + pad) * side + (rx + pad)

        tables.append(np.concatenate([flat(xa, ya), flat(xb, yb)]))
    return np.stack(tables).astype(np.int32)


def brief_descriptors(img_blur: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """Compute (N, 8) uint32 packed descriptors.

    img_blur: (H, W) fp32 Gaussian-blurred level image.
    xy: (N, 2) int32 keypoint coords in level pixels.
    angles: (N,) fp32 orientation in radians.
    """
    pad = MAX_ROTATED_OFFSET
    side = 2 * pad + 2  # 40 — even side keeps the window layout lane-aligned
    N = xy.shape[0]

    # Three-stage sampling, no data-dependent per-sample gather:
    #  1. one CONTIGUOUS (side, side) window per keypoint (a dynamic-slice gather
    #     XLA executes at near-copy speed);
    #  2. the rotation is quantized to ROTATION_BINS precomputed patterns
    #     (original-ORB formulation), so each bin's 512 samples are a STATIC
    #     column selection of the window — no data-dependent gather;
    #  3. a one-hot matmul picks each keypoint's bin.
    # Its cost against a direct (N, 512) gather is not measured on the H100.
    padded = jnp.pad(img_blur, pad + 1, mode="edge")

    def window(p):
        # keypoint (x, y) sits at padded (y + pad + 1, x + pad + 1); offsets
        # span [-pad, pad] so the window starts at (y + 1, x + 1)
        return jax.lax.dynamic_slice(padded, (p[1] + 1, p[0] + 1), (side, side))

    flat = jax.vmap(window)(xy).reshape(N, side * side)  # (N, side^2)

    return descriptors_from_windows(flat, angles, side=side, pad=pad)


def descriptors_from_windows(
    flat: jnp.ndarray, angles: jnp.ndarray,
    side: int = 2 * MAX_ROTATED_OFFSET + 2, pad: int = MAX_ROTATED_OFFSET,
) -> jnp.ndarray:
    """(N, 8) uint32 descriptors from pre-gathered flattened (N, side*side)
    windows whose row/col 0 is keypoint offset -pad (lets the extractor share
    ONE window gather between orientation and BRIEF)."""
    B = ROTATION_BINS
    tau = 2.0 * np.pi
    binf = jnp.round(jnp.mod(angles, tau) * (B / tau)).astype(jnp.int32) % B
    idx = _binned_flat_idx(B, side, pad)                  # (B, 512) static numpy
    samples = flat[:, jnp.asarray(idx)]                   # (N, B, 512) static gather
    onehot = jax.nn.one_hot(binf, B, dtype=samples.dtype)  # (N, B)
    sel = _einsum_nbk(samples, onehot)                    # (N, 512)
    bits = (sel[:, :256] < sel[:, 256:]).astype(jnp.uint32)  # (N, 256)

    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    words = jnp.sum(bits.reshape(-1, 8, 32) * weights, axis=-1, dtype=jnp.uint32)
    return words


def fused_windows(img: jnp.ndarray, blur: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """ONE per-keypoint window gather serving both orientation (channel 0, the
    raw level image) and BRIEF (channel 1, the blurred level): (N, side, side,
    2) with window corner = keypoint - MAX_ROTATED_OFFSET. One gather of two
    stacked channels replaces two gathers of one."""
    pad = MAX_ROTATED_OFFSET
    side = 2 * pad + 2
    stacked = jnp.stack([img, blur], axis=-1)
    sp = jnp.pad(stacked, ((pad + 1, pad + 1), (pad + 1, pad + 1), (0, 0)),
                 mode="edge")

    def one(p):
        return jax.lax.dynamic_slice(sp, (p[1] + 1, p[0] + 1, 0), (side, side, 2))

    return jax.vmap(one)(xy)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) {0,1} uint8, inverse of the packing above."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (desc[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], 256).astype(jnp.uint8)
