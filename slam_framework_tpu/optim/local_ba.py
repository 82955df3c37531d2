"""Local/global bundle adjustment with explicit Schur-complement reduction.

Replacement for Optimizer::LocalBundleAdjustment and
GlobalBundleAdjustemnt/BundleAdjustment (reference: src/optimizer/optimizer.cpp:18-207,
:413-716), which delegate to g2o's BlockSolver_6_3 with marginalized landmark vertices.

Here the whole solver is explicit, batched, fixed-shape JAX (the round-1 config runs it
on one chip; the observation/point tensors are laid out so the same code shards over a
mesh for the distributed configs — see parallel/):

  - Observations are a COO table (cam_idx, pt_idx, uv, ur, inv_sigma2, mask), padded to
    a static M.
  - Per-iteration: batched residuals/Jacobians; Hcc (C,6,6), Hpp (P,3,3), per-obs
    coupling W (M,6,3) via segment-sum; Schur complement
        S = Hcc - sum_p W_p Hpp_p^-1 W_p^T
    assembled from per-point observation pair products (points' observing cameras are
    capped at O_max slots, the standard trick to keep the pair tensor static);
  - dense (6C x 6C) solve for camera updates (C <= ~128 locally: a few-thousand-dim
    dense system), then back-substitution for point updates;
  - Levenberg damping with accept/reject, Huber IRLS weights;
  - reference schedule: 5 iterations, drop chi2 outliers, 10 more iterations
    (optimizer.cpp:607-668), thresholds 5.991 mono / 7.815 stereo.

Fixed cameras (boundary keyframes, optimizer.cpp:447-460) are handled by projecting
their rows/columns out of the reduced system.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import se3
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.optim import reproj
from slam_framework_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from slam_framework_tpu.utils.precision import einsum as _einsum


class BAProblem(NamedTuple):
    """Fixed-shape local-BA problem. C cams, P points, M observation slots."""

    cam_pose: jnp.ndarray    # (C, 4, 4) Tcw
    cam_fixed: jnp.ndarray   # (C,) bool — pose held constant
    cam_mask: jnp.ndarray    # (C,) bool — slot in use
    pt_pos: jnp.ndarray      # (P, 3)
    pt_mask: jnp.ndarray     # (P,) bool
    obs_cam: jnp.ndarray     # (M,) int32
    obs_pt: jnp.ndarray      # (M,) int32
    obs_uv: jnp.ndarray      # (M, 2)
    obs_ur: jnp.ndarray      # (M,) — < 0 for mono observations
    obs_inv_sigma2: jnp.ndarray  # (M,)
    obs_mask: jnp.ndarray    # (M,) bool
    pt_obs_slots: jnp.ndarray  # (P, O) int32 — obs indices per point (-1 pad)


class BAResult(NamedTuple):
    cam_pose: jnp.ndarray
    pt_pos: jnp.ndarray
    obs_inlier: jnp.ndarray  # (M,) bool — survived chi2 classification
    chi2: jnp.ndarray        # (M,) final per-obs chi2
    total_chi2: jnp.ndarray  # () f32


def _project_scalars(cam_pose, pt_pos, prob: BAProblem, K: Intrinsics):
    """Scalar (lane-friendly) projection: returns per-obs (M,) arrays.

    Pose entries are fetched with 1-D gathers from (C,) columns — an (M,4,4) gather
    or a one-hot matmul producing (M,16) had a pathological layout on an earlier
    accelerator; not re-measured on the H100)."""
    cp = cam_pose.reshape(cam_pose.shape[0], 16)
    cols = [cp[:, k][prob.obs_cam] for k in range(12)]
    R00, R01, R02, t0, R10, R11, R12, t1, R20, R21, R22, t2 = cols
    X0 = pt_pos[:, 0][prob.obs_pt]
    X1 = pt_pos[:, 1][prob.obs_pt]
    X2 = pt_pos[:, 2][prob.obs_pt]
    x = R00 * X0 + R01 * X1 + R02 * X2 + t0
    y = R10 * X0 + R11 * X1 + R12 * X2 + t1
    z = R20 * X0 + R21 * X1 + R22 * X2 + t2
    inv_z = 1.0 / jnp.where(z > 1e-6, z, 1e-6)
    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    r_u = prob.obs_uv[:, 0] - u
    r_v = prob.obs_uv[:, 1] - v
    r_ur = prob.obs_ur - (u - K.bf * inv_z)
    Rc = (R00, R01, R02, R10, R11, R12, R20, R21, R22)
    return x, y, z, r_u, r_v, r_ur, Rc


def _chi2_scalars(r_u, r_v, r_ur, z, prob: BAProblem, is_stereo):
    r2 = r_u**2 + r_v**2 + jnp.where(is_stereo, r_ur**2, 0.0)
    c = r2 * prob.obs_inv_sigma2
    return jnp.where(z > 1e-6, c, 1e9)


def _residuals(cam_pose, pt_pos, prob: BAProblem, K: Intrinsics):
    """Batched residuals r (M,3), Jacobians Jc (M,3,6), Jp (M,3,3), depth z (M,)."""
    Tcw = cam_pose[prob.obs_cam]            # (M,4,4)
    Xw = pt_pos[prob.obs_pt]                # (M,3)
    R = Tcw[:, :3, :3]
    Xc = _einsum("mij,mj->mi", R, Xw) + Tcw[:, :3, 3]
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    z_safe = jnp.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur = u - K.bf * inv_z

    r = jnp.stack(
        [prob.obs_uv[:, 0] - u, prob.obs_uv[:, 1] - v, prob.obs_ur - ur], axis=-1
    )

    du = jnp.stack([K.fx * inv_z, jnp.zeros_like(z), -K.fx * x * inv_z2], axis=-1)
    dv = jnp.stack([jnp.zeros_like(z), K.fy * inv_z, -K.fy * y * inv_z2], axis=-1)
    dur = du + jnp.stack([jnp.zeros_like(z), jnp.zeros_like(z), K.bf * inv_z2], axis=-1)
    dproj = jnp.stack([du, dv, dur], axis=-2)  # (M,3,3) d(u,v,ur)/dXc

    # camera: left-multiplied twist -> dXc/dxi = [-[Xc]x | I]
    dXc_dxi = jnp.concatenate(
        [-se3.hat(Xc), jnp.broadcast_to(jnp.eye(3), Xc.shape[:-1] + (3, 3))], axis=-1
    )  # (M,3,6)
    Jc = -_einsum("mij,mjk->mik", dproj, dXc_dxi)
    # point: dXc/dXw = R
    Jp = -_einsum("mij,mjk->mik", dproj, R)
    return r, Jc, Jp, z


def _chi2(r, z, prob: BAProblem):
    is_stereo = prob.obs_ur >= 0.0
    r2 = r[:, 0] ** 2 + r[:, 1] ** 2 + jnp.where(is_stereo, r[:, 2] ** 2, 0.0)
    c = r2 * prob.obs_inv_sigma2
    return jnp.where(z > 1e-6, c, 1e9)


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate/determinant) — elementwise ops
    instead of a batched LU of many tiny matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _pcg(A: jnp.ndarray, b: jnp.ndarray, iters: int = 50) -> jnp.ndarray:
    """Jacobi-preconditioned conjugate gradient for SPD A x = b (fixed iterations)."""
    d_inv = 1.0 / jnp.maximum(jnp.abs(jnp.diag(A)), 1e-12)

    def mv(v):
        # pinned precision: reduced-precision (TF32/bf16) matvecs stall CG
        # convergence on the ill-conditioned Schur system (diag spans ~1e6)
        return jnp.matmul(A, v, precision=jax.lax.Precision.HIGHEST)

    def dot(a, c):
        return jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = d_inv * r0
    p0 = z0

    def body(i, st):
        x, r, z, pvec, rz = st
        Ap = mv(pvec)
        alpha = rz / jnp.maximum(dot(pvec, Ap), 1e-20)
        x = x + alpha * pvec
        r = r - alpha * Ap
        z = d_inv * r
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        return (x, r, z, z + beta * pvec, rz_new)

    x, *_ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, p0, dot(r0, z0)))
    return x


def optimize(
    prob: BAProblem,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    lam0: float = 1e-4,
) -> BAResult:
    C = prob.cam_pose.shape[0]
    is_stereo = prob.obs_ur >= 0.0
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    free = (~prob.cam_fixed) & prob.cam_mask

    def lm_iters(cam_pose, pt_pos, active, n_iters):
        def body(carry, _):
            cam_pose, pt_pos, lam = carry
            # SoA residual/Jacobian assembly (optim/reproj.py): per-obs quantities
            # as (M,) arrays; normal-equation blocks from unique scalar products.
            P_ = pt_pos.shape[0]
            x, y, z, r_u, r_v, r_ur, R_cols = _project_scalars(cam_pose, pt_pos, prob, K)
            chi2 = _chi2_scalars(r_u, r_v, r_ur, z, prob, is_stereo)
            w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2
            # behind-camera/grazing observations: clamped 1/z makes residuals AND
            # Jacobian rows astronomical (H ~ J^2/|r| unbounded even under Huber)
            # — zero-weight them like optim/pose_opt.py
            w_uv = w * active.astype(jnp.float32) * (z > 1e-2).astype(jnp.float32)
            w_ur = w_uv * is_stereo.astype(jnp.float32)

            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            pu, pv, pur = reproj.point_rows(x, y, z, R_cols, K)

            # Hcc (21 unique) + bc (6): one stacked (M, 27) matrix, one matmul
            # against the camera one-hot.
            cols = []
            for i in range(6):
                for j in range(i, 6):
                    cols.append(w_uv * (du[i] * du[j] + dv[i] * dv[j]) + w_ur * dur[i] * dur[j])
            for i in range(6):
                cols.append(w_uv * (du[i] * r_u + dv[i] * r_v) + w_ur * dur[i] * r_ur)
            stacked = jnp.stack(cols, axis=-1)  # (M, 27)
            onehot_cam = jax.nn.one_hot(prob.obs_cam, C, dtype=jnp.float32)  # (M, C)
            per_cam = jax.lax.dot_general(
                onehot_cam, stacked, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )  # (C, 27) — HIGHEST: a TF32 sum would round the Hessian blocks
            Hcc = jnp.zeros((C, 6, 6))
            idx = 0
            for i in range(6):
                for j in range(i, 6):
                    Hcc = Hcc.at[:, i, j].set(per_cam[:, idx])
                    if i != j:
                        Hcc = Hcc.at[:, j, i].set(per_cam[:, idx])
                    idx += 1
            bc = per_cam[:, 21:27]

            # Hpp (6 unique) + bp (3): (M, 9) terms gathered into per-point slots.
            pcols = []
            for i in range(3):
                for j in range(i, 3):
                    pcols.append(w_uv * (pu[i] * pu[j] + pv[i] * pv[j]) + w_ur * pur[i] * pur[j])
            for i in range(3):
                pcols.append(w_uv * (pu[i] * r_u + pv[i] * r_v) + w_ur * pur[i] * r_ur)
            pstacked = jnp.stack(pcols, axis=-1)  # (M, 9)
            slots = prob.pt_obs_slots  # (P, O)
            has = slots >= 0
            safe = jnp.maximum(slots, 0)
            per_pt = jnp.sum(pstacked[safe] * has[..., None], axis=1)  # (P, 9)
            Hpp = jnp.zeros((P_, 3, 3))
            idx = 0
            for i in range(3):
                for j in range(i, 3):
                    Hpp = Hpp.at[:, i, j].set(per_pt[:, idx])
                    if i != j:
                        Hpp = Hpp.at[:, j, i].set(per_pt[:, idx])
                    idx += 1
            bp = per_pt[:, 6:9]

            # W (M, 6, 3) coupling from 18 scalar products
            W = jnp.stack(
                [
                    jnp.stack(
                        [
                            w_uv * (du[i] * pu[j] + dv[i] * pv[j]) + w_ur * dur[i] * pur[j]
                            for j in range(3)
                        ],
                        axis=-1,
                    )
                    for i in range(6)
                ],
                axis=-2,
            )

            lamI3 = lam * jnp.eye(3)
            Hpp_damped = Hpp + lamI3[None] + 1e-8 * jnp.eye(3)[None]
            Hpp_inv = _inv3x3(Hpp_damped)  # closed form, no batched LU

            # Schur: S = Hcc_aug - sum_p sum_{a,b in obs(p)} W_a Hpp_p^-1 W_b^T
            # as U_p = sum_o onehot(cam) Y_o, V_p likewise with W, S -= U V^T over P.
            Wp = W[safe] * has[..., None, None]          # (P,O,6,3)
            Yp = _einsum("poij,pjk->poik", Wp, Hpp_inv)  # (P,O,6,3)
            cam_of = prob.obs_cam[safe]                  # (P,O)
            A = jax.nn.one_hot(cam_of, C, dtype=jnp.float32) * has[..., None]  # (P,O,C)
            U = _einsum("poc,poik->pcik", A, Yp)         # (P,C,6,3)
            V = _einsum("poc,pojk->pcjk", A, Wp)         # (P,C,6,3)
            S = _einsum("pcik,pdjk->cdij", U, V)         # (C,C,6,6)
            v = _einsum("pcik,pk->ci", U, bp)            # (C,6)

            Hcc_d = Hcc + lam * _einsum("cij,ij->cij", Hcc, jnp.eye(6)) + 1e-8 * jnp.eye(6)[None]
            S_full = -S
            S_full = S_full.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
            rhs = bc - v

            # Project out fixed/unused cameras: identity rows/cols, zero rhs.
            free_f = free.astype(jnp.float32)
            S_big = S_full.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
            mask6 = jnp.repeat(free_f, 6)
            S_big = S_big * mask6[:, None] * mask6[None, :] + jnp.diag(1.0 - mask6)
            rhs_big = rhs.reshape(-1) * mask6

            # SPD system: Jacobi-preconditioned CG. Factorizations (LU/Cholesky)
            # run sequential panels; CG is pure matvecs and converges well on the
            # damped system.
            dxc = -_pcg(S_big, rhs_big, iters=28).reshape(C, 6)
            # Back-substitute points: dp = -Hpp^-1 (bp + sum_obs W^T dxc[cam])
            Wt_dxc = _einsum("poij,poi->poj", Wp, dxc[cam_of])  # (P,O,3)
            sum_Wt = jnp.sum(Wt_dxc, axis=1)
            dxp = -_einsum("pij,pj->pi", Hpp_inv, bp + sum_Wt)
            dxp = dxp * prob.pt_mask[:, None]

            new_cam = se3.compose(se3.se3_exp(dxc), cam_pose)
            new_cam = jnp.where(free[:, None, None], new_cam, cam_pose)
            new_pt = pt_pos + dxp

            _, _, z_new, ru_n, rv_n, rur_n, _ = _project_scalars(new_cam, new_pt, prob, K)
            chi2_new = _chi2_scalars(ru_n, rv_n, rur_n, z_new, prob, is_stereo)
            # acceptance compares only in-front observations on BOTH sides:
            # behind-camera chi2 is a clamp artifact, and an obs flipping across
            # z=0 injects +-1e6 jumps that reject genuinely good steps
            cmp_ok = active & (z > 1e-2) & (z_new > 1e-2)
            err_old = jnp.sum(jnp.where(cmp_ok, jnp.minimum(chi2, 1e6), 0.0))
            err_new = jnp.sum(jnp.where(cmp_ok, jnp.minimum(chi2_new, 1e6), 0.0))
            improved = err_new < err_old
            cam_pose = jnp.where(improved, new_cam, cam_pose)
            pt_pos = jnp.where(improved, new_pt, pt_pos)
            lam = jnp.clip(jnp.where(improved, lam * 0.5, lam * 5.0), 1e-8, 1e5)
            return (cam_pose, pt_pos, lam), None

        (cam_pose, pt_pos, _), _ = jax.lax.scan(
            body, (cam_pose, pt_pos, jnp.float32(lam0)), None, length=n_iters
        )
        return cam_pose, pt_pos

    active0 = prob.obs_mask
    cam_pose, pt_pos = lm_iters(prob.cam_pose, prob.pt_pos, active0, iters_first)
    # outlier classification (optimizer.cpp:620-640)
    _, _, z, ru, rv, rur, _ = _project_scalars(cam_pose, pt_pos, prob, K)
    chi2 = _chi2_scalars(ru, rv, rur, z, prob, is_stereo)
    active1 = active0 & (chi2 <= delta2)
    cam_pose, pt_pos = lm_iters(cam_pose, pt_pos, active1, iters_second)
    _, _, z, ru, rv, rur, _ = _project_scalars(cam_pose, pt_pos, prob, K)
    chi2 = _chi2_scalars(ru, rv, rur, z, prob, is_stereo)
    inlier = prob.obs_mask & (chi2 <= delta2)
    total = jnp.sum(jnp.where(inlier, chi2, 0.0))
    return BAResult(
        cam_pose=se3.reorthonormalize(cam_pose), pt_pos=pt_pos,
        obs_inlier=inlier, chi2=chi2, total_chi2=total
    )
