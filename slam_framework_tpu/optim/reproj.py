"""Reprojection residuals/Jacobians in structure-of-arrays (lane-friendly) layout.

Vector hardware works along the LAST axis. The natural (M, 3, 6) Jacobian tensors
put tiny dimensions there and made the LM inner loops of pose optimization and
bundle adjustment latency-bound on an earlier accelerator. Here every Jacobian row
entry is a plain (M,) array (observation index last), products are full-width
elementwise ops, and normal-equation blocks are built from the 21/18/6 unique scalar
products directly.

Analytic rows (left-multiplied twist xi = (omega, upsilon), residual = meas - pred,
J = d(residual)/dxi = -d(pred)/dxi):

  d(u)/d omega    = -fx * [ -xy/z^2, 1 + x^2/z^2, -y/z ]
  d(u)/d upsilon  = -fx * [ 1/z, 0, -x/z^2 ]
  d(v)/d omega    = -fy * [ -(1 + y^2/z^2), xy/z^2, x/z ]
  d(v)/d upsilon  = -fy * [ 0, 1/z, -y/z^2 ]
  d(ur)/d xi      = d(u)/d xi - bf/z^2 * d(z)/d xi,  d(z)/d omega = (y, -x, 0),
                    d(z)/d upsilon = (0, 0, 1)

(The signs above already include the residual = meas - pred negation; they match the
 einsum-based reference implementation bit-for-bit, which matched g2o's analytic
 EdgeSE3ProjectXYZ jacobians — third_party/g2o/g2o/types/types_six_dof_expmap.h.)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from slam_framework_tpu.geometry.projection import Intrinsics


def camera_rows(x, y, z, K: Intrinsics):
    """Jacobian rows wrt the camera twist for all observations.

    x, y, z: (M,) camera-frame point coords.
    Returns (du, dv, dur): each a list of 6 (M,) arrays, plus inv_z.
    """
    inv_z = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
    inv_z2 = inv_z * inv_z
    xz = x * inv_z
    yz = y * inv_z

    du = [
        K.fx * (xz * yz),
        -K.fx * (1.0 + xz * xz),
        K.fx * yz,
        -K.fx * inv_z,
        jnp.zeros_like(z),
        K.fx * x * inv_z2,
    ]
    dv = [
        K.fy * (1.0 + yz * yz),
        -K.fy * (xz * yz),
        -K.fy * xz,
        jnp.zeros_like(z),
        -K.fy * inv_z,
        K.fy * y * inv_z2,
    ]
    # ur = u - bf/z; d(r_ur) = d(r_u) - bf * d(inv z); d(inv z)/dxi = -inv_z2 * dz/dxi
    # dz/d omega = (y, -x, 0); dz/d upsilon = (0, 0, 1); residual sign folded in:
    dz = [yz * z, -xz * z, jnp.zeros_like(z), jnp.zeros_like(z), jnp.zeros_like(z), jnp.ones_like(z)]
    dur = [du[i] - K.bf * inv_z2 * dz[i] for i in range(6)]
    return du, dv, dur, inv_z


def point_rows(x, y, z, R_cols, K: Intrinsics):
    """Jacobian rows wrt the world point: J_row = -dproj_row . R.

    R_cols: R[:, :, k] entries as ((M,),)*9 in row-major order [R00..R22] for the
    observing camera of each observation.
    Returns (pu, pv, pur): each a list of 3 (M,) arrays.
    """
    inv_z = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
    inv_z2 = inv_z * inv_z
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = R_cols
    # dproj rows (d pred / d Xc): u: (fx/z, 0, -fx x/z^2); v: (0, fy/z, -fy y/z^2)
    au, cu = K.fx * inv_z, -K.fx * x * inv_z2
    bv, cv = K.fy * inv_z, -K.fy * y * inv_z2
    pu = [
        -(au * R00 + cu * R20),
        -(au * R01 + cu * R21),
        -(au * R02 + cu * R22),
    ]
    pv = [
        -(bv * R10 + cv * R20),
        -(bv * R11 + cv * R21),
        -(bv * R12 + cv * R22),
    ]
    # ur row adds bf/z^2 * dz/dXw = bf/z^2 * R row 2
    cz = K.bf * inv_z2
    pur = [pu[k] - cz * (R20, R21, R22)[k] for k in range(3)]
    return pu, pv, pur


def sym_outer_sum(rows_w: Sequence[Tuple[Sequence[jnp.ndarray], jnp.ndarray]], n: int) -> jnp.ndarray:
    """H = sum over (rows, w) of w * row row^T, reduced over M. Returns (n, n).

    rows_w: list of (row_entries [n x (M,)], weight (M,)).
    """
    H = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            acc = None
            for rows, w in rows_w:
                term = jnp.sum(w * rows[i] * rows[j])
                acc = term if acc is None else acc + term
            H[i][j] = acc
            H[j][i] = acc
    return jnp.stack([jnp.stack(r) for r in H])


def rhs_sum(rows_w_r: Sequence[Tuple[Sequence[jnp.ndarray], jnp.ndarray, jnp.ndarray]], n: int) -> jnp.ndarray:
    """b = sum over (rows, w, r) of w * row * r, reduced over M. Returns (n,)."""
    b = []
    for i in range(n):
        acc = None
        for rows, w, r in rows_w_r:
            term = jnp.sum(w * rows[i] * r)
            acc = term if acc is None else acc + term
        b.append(acc)
    return jnp.stack(b)
