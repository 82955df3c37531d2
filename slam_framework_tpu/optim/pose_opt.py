"""Motion-only bundle adjustment (pose optimization) — the per-frame hot solver.

Replacement for Optimizer::PoseOptimization
(reference: src/optimizer/optimizer.cpp:209-411): optimize a single SE3 camera pose
against fixed 3D map points with Huber-robustified mono/stereo reprojection edges.

Reference semantics reproduced:
  - 4 rounds x 10 LM iterations (:359, its[4]={10,10,10,10});
  - after each round every observation is reclassified inlier/outlier by chi2 against
    5.991 (mono) / 7.815 (stereo) (:365-401) — outliers are excluded from the next
    round but can be reclaimed later;
  - Huber kernel with delta = sqrt(chi2 threshold) on the first rounds; the last round
    drops the robust kernel for classified inliers (g2o edges set kernel nullptr after
    round 2 in ORB-SLAM2 style — we keep Huber throughout, which is strictly more
    robust and changes nothing for true inliers);
  - information = inv_sigma2 per observation octave.

Everything is fixed-shape: N observation slots with a validity mask; the whole
optimization is one jitted lax.scan program. Jacobians are analytic (left-multiplied
twist: T <- exp(xi) T, matching VertexSE3Expmap::oplusImpl).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import se3
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.optim import reproj
from slam_framework_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from slam_framework_tpu.utils.linalg import chol_solve_small
from slam_framework_tpu.utils.precision import einsum as _einsum

N_ROUNDS = 4
N_ITERS = 10


class PoseObs(NamedTuple):
    """Fixed-capacity observation block for one frame."""

    points_w: jnp.ndarray    # (N, 3) world points
    uv: jnp.ndarray          # (N, 2) measured pixel (undistorted)
    ur: jnp.ndarray          # (N,)  measured right-image u; < 0 => mono observation
    inv_sigma2: jnp.ndarray  # (N,)  information scale (1/1.2^(2*octave))
    mask: jnp.ndarray        # (N,)  bool — slot holds a real observation


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray        # (4, 4) optimized Tcw
    inliers: jnp.ndarray     # (N,) bool — post-optimization inlier classification
    num_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray        # (N,) final per-observation chi2


def _residuals_jacobians(Tcw: jnp.ndarray, obs: PoseObs, K: Intrinsics):
    """Batched residuals r (N,3) and Jacobians J (N,3,6) wrt left-multiplied twist.

    Row layout: [u, v, ur]; mono observations use only the first two rows (third row
    masked). Twist convention (omega, upsilon) as in geometry.se3.
    """
    Xc = se3.transform_points(Tcw, obs.points_w)  # (N, 3)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur_pred = u - K.bf * inv_z

    r_u = obs.uv[:, 0] - u
    r_v = obs.uv[:, 1] - v
    r_ur = obs.ur - ur_pred

    # d(u,v,ur)/dXc
    du = jnp.stack([K.fx * inv_z, jnp.zeros_like(z), -K.fx * x * inv_z2], axis=-1)
    dv = jnp.stack([jnp.zeros_like(z), K.fy * inv_z, -K.fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), K.bf * inv_z2], axis=-1
    )
    dproj = jnp.stack([du, dv, dur], axis=-2)  # (N, 3, 3)

    # dXc/dxi for left-multiplied twist: [-[Xc]x | I]
    dXc = jnp.concatenate([-se3.hat(Xc), jnp.broadcast_to(jnp.eye(3), Xc.shape[:-1] + (3, 3))], axis=-1)  # (N,3,6)
    J = -_einsum("nij,njk->nik", dproj, dXc)  # residual = meas - pred => J = -dpred/dxi
    r = jnp.stack([r_u, r_v, r_ur], axis=-1)
    return r, J, z


def optimize_pose(
    Tcw0: jnp.ndarray,
    obs: PoseObs,
    K: Intrinsics,
    n_rounds: int = N_ROUNDS,
    n_iters: int = N_ITERS,
) -> PoseOptResult:
    """Run the 4x10 LM schedule with per-round chi2 reclassification."""
    is_stereo = obs.ur >= 0.0
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    def chi2_of(r, z):
        # mono: 2 residual rows; stereo: 3. Information = inv_sigma2 * I.
        r2 = r[:, 0] ** 2 + r[:, 1] ** 2 + jnp.where(is_stereo, r[:, 2] ** 2, 0.0)
        c = r2 * obs.inv_sigma2
        # behind-camera observations are outliers regardless of pixel error
        return jnp.where(z > 1e-6, c, 1e9)

    def lm_round(Tcw, active):
        """10 LM iterations using only `active` observations."""

        def body(carry, _):
            Tcw, lam = carry
            # SoA residual/Jacobian assembly (see optim/reproj.py): all per-obs
            # quantities are (N,) arrays (full-width elementwise ops).
            Xc = se3.transform_points(Tcw, obs.points_w)
            x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
            inv_z = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
            u = K.fx * x * inv_z + K.cx
            v = K.fy * y * inv_z + K.cy
            r_u = obs.uv[:, 0] - u
            r_v = obs.uv[:, 1] - v
            r_ur = obs.ur - (u - K.bf * inv_z)
            r = jnp.stack([r_u, r_v, r_ur], axis=-1)
            chi2 = chi2_of(r, z)
            w_rob = huber_weight(chi2, delta2) * obs.inv_sigma2
            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            # behind-camera / grazing points get inv_z clamped to 1e6: their
            # residuals AND Jacobian rows are astronomical and would swamp the
            # normal equations (H grows ~J^2/|r|, unbounded even under Huber).
            # Zero-weight them — relevant for far initializations (reference-KF
            # fallback, relocalization), where a fraction of the map legitimately
            # lands behind the predicted camera.
            in_front = (z > 1e-2).astype(jnp.float32)
            w_uv = w_rob * active.astype(jnp.float32) * in_front
            w_ur = w_uv * is_stereo.astype(jnp.float32)
            H = reproj.sym_outer_sum([(du, w_uv), (dv, w_uv), (dur, w_ur)], 6)
            b = reproj.rhs_sum([(du, w_uv, r_u), (dv, w_uv, r_v), (dur, w_ur, r_ur)], 6)
            # LM step with multiplicative damping on the diagonal.
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            dx = -chol_solve_small(Hd, b, 6)  # GN: J^T W J dx = -J^T W r
            Tcw_new = se3.compose(se3.se3_exp(dx), Tcw)
            # Accept if total robust error decreased.
            r_new, _, z_new = _residuals_jacobians(Tcw_new, obs, K)
            chi2_new = chi2_of(r_new, z_new)
            err_old = jnp.sum(jnp.where(active, jnp.minimum(chi2, 1e6), 0.0))
            err_new = jnp.sum(jnp.where(active, jnp.minimum(chi2_new, 1e6), 0.0))
            improved = err_new < err_old
            Tcw = jnp.where(improved, Tcw_new, Tcw)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0)
            lam = jnp.clip(lam, 1e-9, 1e6)
            return (Tcw, lam), None

        (Tcw, _), _ = jax.lax.scan(body, (Tcw, jnp.float32(1e-3)), None, length=n_iters)
        return Tcw

    def round_body(carry, _):
        Tcw, active = carry
        Tcw = lm_round(Tcw, active)
        r, _, z = _residuals_jacobians(Tcw, obs, K)
        chi2 = chi2_of(r, z)
        active = obs.mask & (chi2 <= delta2)
        return (Tcw, active), None

    active0 = obs.mask
    (Tcw, inliers), _ = jax.lax.scan(
        round_body, (Tcw0, active0), None, length=n_rounds
    )
    r, _, z = _residuals_jacobians(Tcw, obs, K)
    chi2 = chi2_of(r, z)
    # 40 f32 retraction composes drift R off SO(3); downstream consumers
    # (velocity model, triangulation, BA seeds) assume a proper rotation
    Tcw = se3.reorthonormalize(Tcw)
    return PoseOptResult(
        pose=Tcw,
        inliers=inliers,
        num_inliers=jnp.sum(inliers.astype(jnp.int32)),
        chi2=chi2,
    )
