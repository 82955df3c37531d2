"""Full-precision matmul helpers for geometry-critical math.

On the H100, a float32 matmul left at JAX's default precision may run on the tensor
cores in TF32, which keeps a 10-bit mantissa (about three decimal digits). That is
catastrophic for pose/triangulation math: pixel-coordinate normal equations span a
~1e6 dynamic range, and a translation 100 m from the origin loses centimetres per
compose. All Lie/geometry/BA modules use these wrappers, and the one-hot selection
matmuls whose results are compared exactly (ops/brief.py, the local-BA Hessian sum)
pin HIGHEST themselves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

einsum = functools.partial(jnp.einsum, precision=HIGHEST)
matmul = functools.partial(jnp.matmul, precision=HIGHEST)
