"""Hamming distance between packed 256-bit ORB descriptors — as matmuls.

Replacement for OrbMatcher::DescriptorDistance's popcount loop
(reference: src/orb_features/orb_matcher.cpp:1630-1646). For the all-pairs distance
matrices every matcher needs, we use the identity

    H(a, b) = |a| + |b| - 2 * <a, b>        (a, b as 0/1 bit vectors)

so an (N, 256) x (256, M) int8 matmul produces the whole matrix: popcount
becomes a dot product. This is the key reformulation that makes data association a
dense op instead of a scalar loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_to_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) int8 in {0, 1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (desc[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], 256).astype(jnp.int8)


def popcount(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N,) int32 number of set bits."""
    return jnp.sum(unpack_to_bits(desc).astype(jnp.int32), axis=-1)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distance: (N, 8), (M, 8) uint32 -> (N, M) int32 in [0, 256]."""
    a = unpack_to_bits(desc_a)
    b = unpack_to_bits(desc_b)
    dots = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    na = jnp.sum(a.astype(jnp.int32), axis=-1)
    nb = jnp.sum(b.astype(jnp.int32), axis=-1)
    return na[:, None] + nb[None, :] - 2 * dots


def hamming_pairwise(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise Hamming of aligned sets: (N, 8), (N, 8) -> (N,) int32 (XOR+popcount)."""
    x = jnp.bitwise_xor(desc_a, desc_b)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (x[:, :, None] >> shifts) & jnp.uint32(1)
    return jnp.sum(bits.astype(jnp.int32), axis=(1, 2))
