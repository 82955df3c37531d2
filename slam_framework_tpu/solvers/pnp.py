"""Batched PnP RANSAC for relocalization.

Replacement for PnPsolver (reference: src/solvers/pnp_solver.{h,cpp}):
the reference runs EPnP on random 4-point sets inside sequential adaptive RANSAC
(:118-211). RANSAC is embarrassingly parallel, so here ALL hypotheses are solved at
once: each hypothesis takes a random 6-point subset, solves the 11-dof DLT camera
resection (smallest eigenvector of the 12x12 normal matrix — batched eigh), projects
ALL correspondences, and scores chi2 inliers per pyramid level like the reference
(:261-293). The best hypothesis is then refined on its inliers by the caller via
optim.pose_opt (the reference likewise refines with PoseOptimization,
tracker.cpp:886-983).

The linear resection needs 6 points instead of EPnP's 4; with hundreds of parallel
hypotheses the success statistics match or beat the reference's 300 sequential
iterations at a fraction of the latency.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm

MIN_SET = 6


class PnPResult(NamedTuple):
    pose: jnp.ndarray       # (4, 4) best Tcw
    inliers: jnp.ndarray    # (N,) bool for the best hypothesis
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool — enough inliers found


def _dlt_resection(pts_w: jnp.ndarray, uv_norm: jnp.ndarray):
    """Batched DLT: (..., S, 3) world pts + (..., S, 2) normalized image coords ->
    R (..., 3, 3), t (..., 3) with Hartley-normalized conditioning, cheirality sign
    fix and SVD orthonormalization."""
    # Hartley normalization of the 3D points (fp32 eigh needs the conditioning)
    mean = jnp.mean(pts_w, axis=-2, keepdims=True)
    spread = jnp.mean(jnp.linalg.norm(pts_w - mean, axis=-1), axis=-1)
    s_n = jnp.maximum(spread, 1e-6)[..., None, None]
    Xn = (pts_w - mean) / s_n

    ones = jnp.ones(Xn.shape[:-1] + (1,), Xn.dtype)
    Xh = jnp.concatenate([Xn, ones], axis=-1)  # (..., S, 4)
    zeros = jnp.zeros_like(Xh)
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    row_u = jnp.concatenate([Xh, zeros, -u * Xh], axis=-1)  # (..., S, 12)
    row_v = jnp.concatenate([zeros, Xh, -v * Xh], axis=-1)
    A = jnp.concatenate([row_u, row_v], axis=-2)  # (..., 2S, 12)
    AtA = _einsum("...ki,...kj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    p = vecs[..., :, 0]  # (..., 12) smallest eigenvector
    Pn = p.reshape(p.shape[:-1] + (3, 4))
    # undo normalization: P = Pn @ T_norm, T_norm = [[I/s, -mean/s], [0, 1]]
    Rp = Pn[..., :3] / s_n
    tp = Pn[..., 3] - _einsum("...ij,...j->...i", Rp, mean[..., 0, :])
    # cheirality: majority of minimal-set points must have positive depth
    z = _einsum("...ij,...sj->...si", Rp, pts_w)[..., 2] + tp[..., None, 2]
    flip = jnp.median(z, axis=-1) < 0
    sgn = jnp.where(flip, -1.0, 1.0)[..., None, None]
    Rp = Rp * sgn
    tp = tp * sgn[..., 0]
    # orthonormalize rotation; recover DLT scale from singular values
    U, s, Vt = jnp.linalg.svd(Rp)
    det = jnp.linalg.det(_einsum("...ij,...jk->...ik", U, Vt))
    D = jnp.concatenate([jnp.ones(det.shape + (2,)), det[..., None]], axis=-1)
    R_ortho = _einsum("...ij,...j,...jk->...ik", U, D, Vt)
    scale = jnp.mean(s, axis=-1)
    t_fixed = tp / jnp.maximum(scale, 1e-12)[..., None]
    return R_ortho, t_fixed


def solve_pnp_ransac(
    pts_w: jnp.ndarray,        # (N, 3) world points
    uv: jnp.ndarray,           # (N, 2) pixel observations
    inv_sigma2: jnp.ndarray,   # (N,) per-obs information (octave)
    mask: jnp.ndarray,         # (N,) valid correspondences
    K: Intrinsics,
    key: jax.Array,
    n_hypotheses: int = 256,
    chi2_thresh: float = 16.0,
    min_inliers: int = 10,        # tracker.cpp:871
) -> PnPResult:
    """All-hypotheses-at-once PnP RANSAC. Returns the best hypothesis."""
    N = pts_w.shape[0]
    # random minimal sets, biased to valid entries by probability weighting
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(
        key, N, shape=(n_hypotheses, MIN_SET), replace=True, p=probs
    )
    sel_w = pts_w[idx]                 # (H, S, 3)
    sel_uv = uv[idx]                   # (H, S, 2)
    uvn = jnp.stack(
        [(sel_uv[..., 0] - K.cx) / K.fx, (sel_uv[..., 1] - K.cy) / K.fy], axis=-1
    )
    R, t = _dlt_resection(sel_w, uvn)  # (H, 3, 3), (H, 3)

    def score(R, t, thresh):
        Xc = _einsum("...ij,nj->...ni", R, pts_w) + t[..., None, :]
        z = Xc[..., 2]
        z_safe = jnp.where(z > 1e-6, z, 1e-6)
        up = K.fx * Xc[..., 0] / z_safe + K.cx
        vp = K.fy * Xc[..., 1] / z_safe + K.cy
        err2 = ((up - uv[..., :, 0]) ** 2 + (vp - uv[..., :, 1]) ** 2) * inv_sigma2
        inl = (err2 < thresh) & (z > 0.05) & mask
        return inl, jnp.sum(inl.astype(jnp.int32), axis=-1)

    # Stage 1: loose consensus. Minimal-set DLT is noise-amplifying (~1 m at 0.5 px
    # noise), so strict gating would find no consensus; the loose gate only needs to
    # separate the right basin from garbage hypotheses.
    loose = 15.0**2
    inl_l, counts_l = score(R, t, loose)
    best = jnp.argmax(counts_l)
    Rb, tb = R[best], t[best]
    inl_b = inl_l[best]

    # Stage 2: refine with masked all-point DLT on the loose inliers, shrinking gate.
    uvn_all = jnp.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy], axis=-1)
    for thresh in (8.0**2, 4.0**2):
        w = inl_b.astype(jnp.float32)[:, None]
        Rb, tb = _dlt_resection_weighted(pts_w, uvn_all, w)
        inl_b, _ = score(Rb, tb, thresh)

    # Final consensus at the stage-2 gate. This is intentionally looser than the
    # reference's chi2 5.991 (tracker.cpp:874): the refined-but-unpolished DLT pose
    # still carries ~0.2 m of error, and the caller's motion-only BA
    # (optim/pose_opt.py) re-classifies inliers per round from the FULL match set
    # anyway — the RANSAC result only seeds the pose, exactly as in the reference
    # where PnPsolver::iterate feeds PoseOptimization (tracker.cpp:886-983).
    inl, n = score(Rb, tb, chi2_thresh)
    pose = jnp.eye(4).at[:3, :3].set(Rb).at[:3, 3].set(tb)
    return PnPResult(pose=pose, inliers=inl, n_inliers=n, ok=n >= min_inliers)


def _dlt_resection_weighted(pts_w: jnp.ndarray, uv_norm: jnp.ndarray, w: jnp.ndarray):
    """Single DLT resection over ALL correspondences with per-row weights (N, 1)."""
    mean = jnp.sum(pts_w * w, axis=0) / jnp.maximum(jnp.sum(w), 1e-6)
    spread = jnp.sum(jnp.linalg.norm(pts_w - mean, axis=-1) * w[:, 0]) / jnp.maximum(jnp.sum(w), 1e-6)
    s_n = jnp.maximum(spread, 1e-6)
    Xn = (pts_w - mean) / s_n
    ones = jnp.ones((Xn.shape[0], 1), Xn.dtype)
    Xh = jnp.concatenate([Xn, ones], axis=-1)
    zeros = jnp.zeros_like(Xh)
    u = uv_norm[:, 0:1]
    v = uv_norm[:, 1:2]
    row_u = jnp.concatenate([Xh, zeros, -u * Xh], axis=-1) * w
    row_v = jnp.concatenate([zeros, Xh, -v * Xh], axis=-1) * w
    A = jnp.concatenate([row_u, row_v], axis=0)
    AtA = _einsum("ki,kj->ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    Pn = vecs[:, 0].reshape(3, 4)
    Rp = Pn[:, :3] / s_n
    tp = Pn[:, 3] - _einsum("ij,j->i", Rp, mean)
    z = _einsum("ni,i->n", pts_w, Rp[2]) + tp[2]
    flip = jnp.sum(jnp.where(w[:, 0] > 0, jnp.sign(z), 0.0)) < 0
    sgn = jnp.where(flip, -1.0, 1.0)
    Rp = Rp * sgn
    tp = tp * sgn
    U, s, Vt = jnp.linalg.svd(Rp)
    det = jnp.linalg.det(_mm(U, Vt))
    D = jnp.asarray([1.0, 1.0, 0.0]) + jnp.asarray([0.0, 0.0, 1.0]) * det
    R_ortho = _mm(U * D[None, :], Vt)
    tp = tp / jnp.maximum(jnp.mean(s), 1e-12)
    return R_ortho, tp


# --------------------------------------------------------------- stereo 3D-3D path


def _gn_refine_pose(R, t, Xw, uv, w, K: Intrinsics, iters: int = 5,
                    damping: float = 1e-3):
    """Batched Gauss-Newton on REPROJECTION for pose hypotheses.

    R (..., 3, 3), t (..., 3); Xw (..., M, 3) world points; uv (..., M, 2)
    observations; w (..., M) weights (0 disables a row). Minimizes
    sum w * |pi(R X + t) - uv|^2 over the SE3 left-perturbation. With M = 3
    and exact correspondences this converges to the P3P solution — which is
    why it fixes the far-depth failure: the 3-point Horn seed from stereo
    back-projections is meters off at z > 20 m (sigma_z ~ z^2/bf), but the
    2D observations are pixel-tight, so a few GN steps snap the hypothesis
    to them before scoring."""
    from slam_framework_tpu.geometry import se3

    def step(carry, _):
        R, t = carry
        Xc = _einsum("...ij,...mj->...mi", R, Xw) + t[..., None, :]
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = jnp.maximum(z, 1e-3)
        u = K.fx * x / zs + K.cx
        v = K.fy * y / zs + K.cy
        r = jnp.stack([u - uv[..., 0], v - uv[..., 1]], axis=-1)  # (..., M, 2)
        zero = jnp.zeros_like(zs)
        Jp = jnp.stack(
            [
                jnp.stack([K.fx / zs, zero, -K.fx * x / (zs * zs)], axis=-1),
                jnp.stack([zero, K.fy / zs, -K.fy * y / (zs * zs)], axis=-1),
            ],
            axis=-2,
        )                                                     # (..., M, 2, 3)
        Jx = jnp.concatenate(
            [
                jnp.broadcast_to(jnp.eye(3), Xc.shape[:-1] + (3, 3)),
                -se3.hat(Xc),
            ],
            axis=-1,
        )                                                     # (..., M, 3, 6)
        J = _einsum("...mij,...mjk->...mik", Jp, Jx)           # (..., M, 2, 6)
        wv = w[..., None, None]
        A = jnp.sum(_einsum("...mij,...mik->...mjk", J, J) * wv, axis=-3)
        b = jnp.sum(_einsum("...mij,...mi->...mj", J, r) * wv[..., 0], axis=-2)
        A = A + damping * jnp.eye(6)
        delta = jnp.linalg.solve(A, b[..., None])[..., 0]      # (..., 6)
        dR = se3.so3_exp(-delta[..., 3:6])
        R2 = _einsum("...ij,...jk->...ik", dR, R)
        t2 = _einsum("...ij,...j->...i", dR, t) - delta[..., 0:3]
        # guard: a singular system must not poison the hypothesis
        good = jnp.isfinite(delta).all(axis=-1)
        R2 = jnp.where(good[..., None, None], R2, R)
        t2 = jnp.where(good[..., None], t2, t)
        return (R2, t2), None

    (R, t), _ = jax.lax.scan(step, (R, t), None, length=iters)
    return R, t


def _weighted_horn(p1: jnp.ndarray, p2: jnp.ndarray, w: jnp.ndarray):
    """Weighted Horn SE3: p1 ~ R @ p2 + t with per-row weights (N,).
    Same quaternion closed form as sim3solver.horn_alignment, centroids and the
    orientation matrix weighted by w (inlier refinement over the full set)."""
    wn = w / jnp.maximum(jnp.sum(w), 1e-9)
    c1 = jnp.sum(p1 * wn[:, None], axis=0)
    c2 = jnp.sum(p2 * wn[:, None], axis=0)
    q1 = (p1 - c1) * w[:, None]
    q2 = p2 - c2
    M = _einsum("si,sj->ij", q2, q1)
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N4 = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]),
        ]
    )
    _, vecs = jnp.linalg.eigh(N4)
    q = vecs[:, -1]
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    R = jnp.stack(
        [
            jnp.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)]),
            jnp.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)]),
            jnp.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]),
        ]
    )
    t = c1 - _einsum("ij,j->i", R, c2)
    return R, t


def solve_pnp3d_ransac(
    pts_w: jnp.ndarray,        # (N, 3) matched map points (world)
    pts_c: jnp.ndarray,        # (N, 3) frame keypoints back-projected via stereo depth
    uv: jnp.ndarray,           # (N, 2) pixel observations
    inv_sigma2: jnp.ndarray,   # (N,)
    mask: jnp.ndarray,         # (N,) valid correspondences WITH depth
    K: Intrinsics,
    key: jax.Array,
    n_hypotheses: int = 256,
    chi2_thresh: float = 16.0,
    min_inliers: int = 10,
) -> PnPResult:
    """Stereo/RGB-D relocalization pose: 3-point Horn SE3 alignment inside
    batched RANSAC, refined by weighted Horn on the consensus.

    The reference relocalizes with EPnP (pnp_solver.cpp) because its Frame only
    carries 2D keypoints into the solver; with stereo depth the 3D-3D closed
    form is strictly better conditioned — a 3-point minimal set, no planar
    degeneracy (the 11-dof DLT resection above loses the pose on corridor
    scenes whose samples land near one plane: measured 0 inliers on a 90%%-good
    182-match set where this solver recovers the pose)."""
    from slam_framework_tpu.solvers.sim3solver import horn_alignment

    N = pts_w.shape[0]
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hypotheses, 3), replace=True, p=probs)
    R, t, _ = horn_alignment(pts_c[idx], pts_w[idx], fix_scale=True)  # (H,3,3),(H,3)
    # The Horn seed aligns against stereo BACK-projections, whose depth noise
    # grows as z^2/bf (sigma_z ~ 3 m at z = 25 m on KITTI geometry): a far
    # minimal set yields a meters-wrong pose even from correct matches
    # (measured: 1-inlier consensus on a 66%-good 53-match set). The 2D
    # observations stay pixel-tight, so each hypothesis is snapped to ITS 3
    # points by reprojection Gauss-Newton (= iterative P3P) before scoring.
    R, t = _gn_refine_pose(
        R, t, pts_w[idx], uv[idx], jnp.ones((n_hypotheses, 3)), K, iters=6
    )

    z_obs = pts_c[:, 2]

    def score(R, t, thresh):
        Xc = _einsum("...ij,nj->...ni", R, pts_w) + t[..., None, :]
        z = Xc[..., 2]
        z_safe = jnp.where(z > 1e-6, z, 1e-6)
        up = K.fx * Xc[..., 0] / z_safe + K.cx
        vp = K.fy * Xc[..., 1] / z_safe + K.cy
        err2 = ((up - uv[..., :, 0]) ** 2 + (vp - uv[..., :, 1]) ** 2) * inv_sigma2
        # Depth-consistency gate: on repeating structure (corridors), a pose
        # displaced one texture period can match MORE 2D reprojections than
        # the true one (measured: 47 vs 44 on a post-blackout reloc — the
        # accepted pose was 4.3 m off). The predicted map-point depth vs the
        # keypoint's stereo depth separates the modes (alias fails by ~the
        # displacement; truth only by stereo noise sigma_z ~ z^2/bf, covered
        # by the 20%-of-z band).
        dz_ok = jnp.abs(z - z_obs) < 0.2 * jnp.maximum(z_obs, 1.0) + 0.5
        inl = (err2 < thresh) & (z > 0.05) & mask & dz_ok
        return inl, jnp.sum(inl.astype(jnp.int32), axis=-1)

    inl_l, counts_l = score(R, t, 10.0**2)
    best = jnp.argmax(counts_l)
    Rb, tb = R[best], t[best]
    inl_b = inl_l[best]
    for thresh in (6.0**2, chi2_thresh):
        # refine on the consensus set — again on reprojection, not 3D-3D
        Rb, tb = _gn_refine_pose(
            Rb, tb, pts_w, uv, inl_b.astype(jnp.float32) * inv_sigma2, K, iters=3
        )
        inl_b, _ = score(Rb, tb, thresh)
    n = jnp.sum(inl_b.astype(jnp.int32))
    pose = jnp.eye(4).at[:3, :3].set(Rb).at[:3, 3].set(tb)
    return PnPResult(pose=pose, inliers=inl_b, n_inliers=n, ok=n >= min_inliers)
