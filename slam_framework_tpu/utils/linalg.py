"""Small fixed-size linear solvers, unrolled.

jnp.linalg.solve lowers to LU with pivoting (sequential scalar pivot selection), a
poor fit for the tiny 6x6 systems inside the pose-optimization scan; its cost on the
H100 is not measured. All hot-loop solvers in this codebase are SPD normal
equations, so Cholesky without pivoting is exact and the unrolled form compiles to
plain elementwise arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_solve_small(H: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Solve H x = b for SPD (n, n) H with an unrolled Cholesky. n is static.

    Supports leading batch dimensions on both H (..., n, n) and b (..., n).
    """
    # Decompose H = L L^T, storing columns of L as separate vectors (unrolled).
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = H[..., i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = H[..., j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    # Forward substitution: L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # Back substitution: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
