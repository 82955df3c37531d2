"""Monocular two-view initializer: batched homography/essential RANSAC + reconstruction.

Replacement for Initializer (reference: src/util/initializer.{h,cpp}).
The reference computes a homography and a fundamental matrix on two CPU threads over
200 shared 8-point RANSAC sets (:57-89), scores both by symmetric transfer error,
selects by RH = SH/(SH+SF) > 0.40 (:92-98), then decomposes (ReconstructH :568-736 /
ReconstructF :459-566) with cheirality + parallax validation (CheckRT :804-922).

Here ALL hypotheses for BOTH models are solved in one program:
  - E-matrix (normalized 8-point; with calibrated K this is the reference's F path
    expressed in normalized coordinates) via batched 9x9 eigh;
  - H via batched DLT on the same sets;
  - scoring with the reference's symmetric-transfer chi2 (5.991 / 3.841, sigma = 1 px);
  - model selection with the same RH rule;
  - E decomposed into 4 motions, validated by batched triangulation (cheirality both
    views, reprojection, parallax), reproducing CheckRT's accept rules.
Planar-dominant scenes (H selected) are reconstructed with the Faugeras SVD-based
8-motion decomposition (ReconstructH :568-736) validated by the same batched
triangulation checks; both model paths run in the one program and the RH rule picks
which result is returned.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import triangulation
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm

CHI2_H = 5.991   # initializer.cpp CheckHomography
CHI2_F = 3.841   # CheckFundamental (1-dof transfer)
SCORE_OFFSET = 5.991


class InitResult(NamedTuple):
    R: jnp.ndarray         # (3,3) rotation cam1 -> cam2 (Tcw of frame 2, frame 1 = I)
    t: jnp.ndarray         # (3,) unit-norm translation
    points: jnp.ndarray    # (N, 3) triangulated points in frame-1 camera coords
    good: jnp.ndarray      # (N,) bool — triangulated + validated matches
    n_good: jnp.ndarray    # () int32
    is_planar: jnp.ndarray  # () bool — H model won (reconstructed via Faugeras)
    ok: jnp.ndarray        # () bool


def _normalize(uv, K: Intrinsics):
    return jnp.stack([(uv[..., 0] - K.cx) / K.fx, (uv[..., 1] - K.cy) / K.fy], axis=-1)


def _eight_point_E(x1, x2):
    """Batched essential from (..., 8, 2) normalized correspondences."""
    a = jnp.stack(
        [
            x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
            x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
            x1[..., 0], x1[..., 1], jnp.ones_like(x1[..., 0]),
        ],
        axis=-1,
    )  # (..., 8, 9)
    AtA = _einsum("...ki,...kj->...ij", a, a)
    _, vecs = jnp.linalg.eigh(AtA)
    E = vecs[..., :, 0].reshape(x1.shape[:-2] + (3, 3))
    # project to essential manifold: singular values (1, 1, 0)
    U, s, Vt = jnp.linalg.svd(E)
    D = jnp.stack([jnp.ones_like(s[..., 0]), jnp.ones_like(s[..., 0]), jnp.zeros_like(s[..., 0])], -1)
    return _einsum("...ij,...j,...jk->...ik", U, D, Vt)


def _eight_point_E_weighted(x1, x2, w):
    """Essential from ALL correspondences with per-row weights (N,)."""
    a = jnp.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], jnp.ones_like(x1[:, 0]),
        ],
        axis=-1,
    ) * w[:, None]
    AtA = _einsum("ki,kj->ij", a, a)
    _, vecs = jnp.linalg.eigh(AtA)
    E = vecs[:, 0].reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(E)
    return _mm(U * jnp.asarray([1.0, 1.0, 0.0])[None, :], Vt)


def _dlt_H(x1, x2):
    """Batched homography from (..., S, 2) normalized correspondences (DLT)."""
    S = x1.shape[-2]
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    xh = jnp.concatenate([x1, ones], axis=-1)  # (..., S, 3)
    zeros = jnp.zeros_like(xh)
    u2 = x2[..., 0:1]
    v2 = x2[..., 1:2]
    rows_u = jnp.concatenate([xh, zeros, -u2 * xh], axis=-1)
    rows_v = jnp.concatenate([zeros, xh, -v2 * xh], axis=-1)
    A = jnp.concatenate([rows_u, rows_v], axis=-2)  # (..., 2S, 9)
    AtA = _einsum("...ki,...kj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0].reshape(x1.shape[:-2] + (3, 3))


def _dlt_H_weighted(x1, x2, w):
    """Homography from ALL correspondences with per-row weights (N,) — the
    inlier-weighted refit mirroring the E path's, so the planar reconstruction
    is not limited to minimal-set noise."""
    ones = jnp.ones(x1.shape[:-1] + (1,), x1.dtype)
    xh = jnp.concatenate([x1, ones], axis=-1)
    zeros = jnp.zeros_like(xh)
    u2 = x2[:, 0:1]
    v2 = x2[:, 1:2]
    rows_u = jnp.concatenate([xh, zeros, -u2 * xh], axis=-1) * w[:, None]
    rows_v = jnp.concatenate([zeros, xh, -v2 * xh], axis=-1) * w[:, None]
    A = jnp.concatenate([rows_u, rows_v], axis=0)
    AtA = _einsum("ki,kj->ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[:, 0].reshape(3, 3)


def _sampson_chi2(E, x1, x2, K: Intrinsics):
    """Per-match squared epipolar error (pixels^2-ish) for each hypothesis.

    E: (H, 3, 3); x1/x2: (N, 2) normalized. Scales to pixel units with fx."""
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    p1 = jnp.concatenate([x1, ones], -1)  # (N,3)
    p2 = jnp.concatenate([x2, ones], -1)
    Ep1 = _einsum("hij,nj->hni", E, p1)
    Etp2 = _einsum("hji,nj->hni", E, p2)
    x2tEp1 = jnp.sum(p2[None] * Ep1, axis=-1)
    denom = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    sampson = (x2tEp1**2) / jnp.maximum(denom, 1e-12)
    return sampson * (K.fx**2)  # to pixel^2


def _transfer_chi2_H(Hm, x1, x2, K: Intrinsics):
    """Symmetric transfer error for homographies, pixel^2."""
    ones = jnp.ones((x1.shape[0], 1), x1.dtype)
    p1 = jnp.concatenate([x1, ones], -1)
    p2 = jnp.concatenate([x2, ones], -1)

    def xfer(Hm, pa, pb):
        q = _einsum("hij,nj->hni", Hm, pa)
        qz = jnp.where(jnp.abs(q[..., 2]) < 1e-9, 1e-9, q[..., 2])
        return ((q[..., 0] / qz - pb[None, :, 0]) ** 2 + (q[..., 1] / qz - pb[None, :, 1]) ** 2)

    Hinv = jnp.linalg.inv(Hm + 1e-12 * jnp.eye(3))
    return (xfer(Hm, p1, p2) + xfer(Hinv, p2, p1)) * (K.fx**2) * 0.5


def _decompose_H(Hn: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Faugeras SVD decomposition of a normalized homography into 8 (R, t) motions.

    Reference: Initializer::ReconstructH, initializer.cpp:568-736. Hn maps normalized
    coordinates (K factored out), so Hn ~ R + t n^T / d directly. Returns Rs (8,3,3),
    ts (8,3) with unit-norm translations, and a `degenerate` flag replicating the
    reference's early-out (initializer.cpp:601-604): a near-equal singular-value
    spectrum (d1~d2 or d2~d3, e.g. pure rotation) makes the decomposition
    ill-conditioned, so callers must reject all 8 motions.
    """
    U, d, Vt = jnp.linalg.svd(Hn)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom13 = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / denom13, 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / denom13, 0.0))
    eps1 = jnp.asarray([1.0, 1.0, -1.0, -1.0])
    eps3 = jnp.asarray([1.0, -1.0, 1.0, -1.0])
    x1v = eps1 * aux1
    x3v = eps3 * aux3
    zero4 = jnp.zeros(4)
    one4 = jnp.ones(4)

    def rot_y(c, sgn_s, flip):
        # (4,3,3); flip=+1: [[c,0,-s],[0,1,0],[s,0,c]]; flip=-1: [[c,0,s],[0,-1,0],[s,0,-c]]
        c4 = c * one4
        r = jnp.stack(
            [
                jnp.stack([c4, zero4, -flip * sgn_s], -1),
                jnp.stack([zero4, flip * one4, zero4], -1),
                jnp.stack([sgn_s, zero4, flip * c4], -1),
            ],
            axis=-2,
        )
        return r

    # case d' = +d2 (initializer.cpp:597-635)
    den_t = jnp.maximum((d1 + d3) * d2, 1e-12)
    sin_t = eps1 * eps3 * jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / den_t
    cos_t = (d2 * d2 + d1 * d3) / den_t
    Rp_pos = rot_y(cos_t, sin_t, 1.0)
    tp_pos = (d1 - d3) * jnp.stack([x1v, zero4, -x3v], -1)
    # case d' = -d2 (initializer.cpp:637-676)
    den_p = jnp.where(jnp.abs((d1 - d3) * d2) < 1e-12, 1e-12, (d1 - d3) * d2)
    sin_p = eps1 * eps3 * jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / den_p
    cos_p = (d1 * d3 - d2 * d2) / den_p
    Rp_neg = rot_y(cos_p, sin_p, -1.0)
    tp_neg = (d1 + d3) * jnp.stack([x1v, zero4, x3v], -1)

    Rp = jnp.concatenate([Rp_pos, Rp_neg], axis=0)  # (8,3,3)
    tp = jnp.concatenate([tp_pos, tp_neg], axis=0)  # (8,3)
    Rs = s * _einsum("ij,mjk,kl->mil", U, Rp, Vt)
    ts = _einsum("ij,mj->mi", U, tp)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=-1, keepdims=True), 1e-12)
    degenerate = (d1 / jnp.maximum(d2, 1e-12) < 1.00001) | (
        d2 / jnp.maximum(d3, 1e-12) < 1.00001
    )
    return Rs, ts, degenerate


def _check_motions(Rs, ts, x1, x2, mask, K: Intrinsics, sigma):
    """CheckRT (initializer.cpp:804-922) batched over M motion hypotheses.

    Triangulates each hypothesis's RANSAC-inlier matches (the reference iterates
    vbMatchesInliers) and validates cheirality in both views + reprojection error.
    Like the reference:
      - cheirality is waived for near-zero-parallax points (cosParallax >= 0.99998
        skips the z<=0 rejection, :871-879) — "infinite" points triangulate to
        arbitrary-sign depth;
      - `ngood` counts ALL validated points (no per-point parallax demand);
      - `good` (points eligible to become landmarks) additionally requires
        cosParallax < 0.99998 (:906-907);
      - `parallax_deg` is the motion's global parallax statistic: the angle of the
        50th-smallest cosParallax among counted points (:911-917), which the
        caller compares against minParallax.
    mask: (N,) or (M, N) per-hypothesis inlier mask.
    Returns (pts (M,N,3), good (M,N), ngood (M,), parallax_deg (M,))."""
    M, N = Rs.shape[0], x1.shape[0]
    if mask.ndim == 1:
        mask = jnp.broadcast_to(mask[None], (M, N))
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)[None]
    P2 = jnp.concatenate([Rs, ts[..., None]], axis=-1)  # (M, 3, 4)
    pts = triangulation.triangulate_dlt(
        jnp.broadcast_to(P1, (M, 3, 4)), P2,
        jnp.broadcast_to(x1[None], (M, N, 2)), jnp.broadcast_to(x2[None], (M, N, 2)),
    )  # (M, N, 3) in frame-1 coords
    z1 = pts[..., 2]
    Xc2 = _einsum("mij,mnj->mni", Rs, pts) + ts[:, None, :]
    z2 = Xc2[..., 2]
    e1 = jnp.sum((pts[..., :2] / jnp.where(jnp.abs(z1[..., None]) < 1e-9, 1e-9, z1[..., None]) - x1[None]) ** 2, -1) * K.fx**2
    e2 = jnp.sum((Xc2[..., :2] / jnp.where(jnp.abs(z2[..., None]) < 1e-9, 1e-9, z2[..., None]) - x2[None]) ** 2, -1) * K.fx**2
    cosp = triangulation.parallax_cosine(
        jnp.zeros((M, 3)), -_einsum("mji,mj->mi", Rs, ts), pts
    )
    has_parallax = cosp < 0.99998  # initializer.cpp:871 cheirality waiver bound
    counted = (
        ((z1 > 0) | ~has_parallax) & ((z2 > 0) | ~has_parallax)
        & (e1 < 4.0 * sigma**2) & (e2 < 4.0 * sigma**2)
        & jnp.isfinite(pts).all(-1)
        & mask
    )
    ngood = jnp.sum(counted.astype(jnp.int32), axis=1)
    good = counted & has_parallax
    # global parallax: 50th smallest cosParallax among counted (or the largest
    # counted one when fewer than 50) -> degrees
    cosp_sorted = jnp.sort(jnp.where(counted, cosp, jnp.inf), axis=1)
    idx50 = jnp.minimum(50, jnp.maximum(ngood - 1, 0))
    c50 = jnp.take_along_axis(cosp_sorted, idx50[:, None], axis=1)[:, 0]
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(c50, -1.0, 1.0)))
    parallax_deg = jnp.where(ngood > 0, parallax_deg, 0.0)
    return pts, good, ngood, parallax_deg


def initialize_two_view(
    uv1: jnp.ndarray,     # (N, 2) pixels in frame 1
    uv2: jnp.ndarray,     # (N, 2) matched pixels in frame 2
    mask: jnp.ndarray,    # (N,) valid matches
    K: Intrinsics,
    key: jax.Array,
    n_hypotheses: int = 200,   # initializer.cpp:60 (200 RANSAC sets)
    sigma: float = 1.0,
    min_good: int = 50,        # minTriangulated (tracker.cpp:335 passes 50)
    min_parallax_deg: float = 1.0,
) -> InitResult:
    N = uv1.shape[0]
    x1 = _normalize(uv1, K)
    x2 = _normalize(uv2, K)
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hypotheses, 8), replace=True, p=probs)

    # --- essential path ---
    E = _eight_point_E(x1[idx], x2[idx])
    chi2_e = _sampson_chi2(E, x1, x2, K) / (sigma**2)
    inl_e = (chi2_e < CHI2_F) & mask[None]
    # reference scoring: sum of (offset - chi2) over inliers (CheckFundamental)
    score_e = jnp.sum(jnp.where(inl_e, SCORE_OFFSET - chi2_e, 0.0), axis=1)
    best_e = jnp.argmax(score_e)
    # refit on the best hypothesis's inliers (all-point weighted 8-point): the
    # minimal-set E is noise-limited; the refit sharpens the epipole (t direction)
    w_in = inl_e[best_e].astype(jnp.float32)
    E_refit = _eight_point_E_weighted(x1, x2, w_in)
    chi2_r = _sampson_chi2(E_refit[None], x1, x2, K)[0] / (sigma**2)
    E = E.at[best_e].set(E_refit)
    chi2_e = chi2_e.at[best_e].set(chi2_r)

    # --- homography path (same sets) ---
    Hm = _dlt_H(x1[idx], x2[idx])
    chi2_h = _transfer_chi2_H(Hm, x1, x2, K) / (sigma**2)
    inl_h = (chi2_h < CHI2_H) & mask[None]
    score_h = jnp.sum(jnp.where(inl_h, CHI2_H - chi2_h, 0.0), axis=1)

    SH = jnp.max(score_h)
    SF = jnp.max(score_e)
    RH = SH / jnp.maximum(SH + SF, 1e-9)
    is_planar = RH > 0.40  # initializer.cpp:95

    # --- decompose best E into 4 motions (ReconstructF :459-566) ---
    Eb = E[best_e]
    U, _, Vt = jnp.linalg.svd(Eb)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    Wm = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = _mm(_mm(U, Wm), Vt)
    R2 = _mm(_mm(U, Wm.T), Vt)
    tu = U[:, 2]
    tu = tu / jnp.maximum(jnp.linalg.norm(tu), 1e-12)
    Rs_e = jnp.stack([R1, R1, R2, R2])
    ts_e = jnp.stack([tu, -tu, tu, -tu])

    # --- decompose best H into 8 motions (ReconstructH :568-736), refit on the
    # best hypothesis's inliers first (mirrors the E refit above) ---
    best_h = jnp.argmax(score_h)
    H_refit = _dlt_H_weighted(x1, x2, inl_h[best_h].astype(jnp.float32))
    Rs_h, ts_h, h_degenerate = _decompose_H(H_refit)

    # Validate all 12 motions with the shared CheckRT program over each model's
    # OWN RANSAC inlier set (the reference's CheckRT iterates vbMatchesInliers);
    # the RH rule then selects which model's winner is returned (:92-98).
    Rs = jnp.concatenate([Rs_e, Rs_h], axis=0)   # (12,3,3)
    ts = jnp.concatenate([ts_e, ts_h], axis=0)
    model_mask = jnp.concatenate(
        [
            jnp.broadcast_to((inl_e[best_e] & mask)[None], (4, N)),
            jnp.broadcast_to((inl_h[best_h] & mask)[None], (8, N)),
        ],
        axis=0,
    )
    pts, good, ngood, parallax_deg = _check_motions(
        Rs, ts, x1, x2, model_mask, K, sigma
    )
    model_h = jnp.arange(12) >= 4
    # degenerate-spectrum early-out (initializer.cpp:601-604): reject all 8 H motions
    ngood = jnp.where(model_h & h_degenerate, -1, ngood)
    ngood_model = jnp.where(model_h == is_planar, ngood, -1)
    best_m = jnp.argmax(ngood_model)
    n_best = ngood_model[best_m]
    n_bestf = n_best.astype(jnp.float32)
    # reference acceptance, per model:
    #   E (ReconstructF :500-516): maxGood >= max(0.9*N, minTriangulated) and no
    #     second motion with nGood > 0.7*maxGood; winner's parallax > minParallax;
    #   H (ReconstructH :706-735): bestGood > 0.9*N, secondBest < 0.75*bestGood,
    #     parallax > minParallax, bestGood > minTriangulated.
    n_model_inl = jnp.where(
        is_planar, jnp.sum(inl_h[best_h] & mask), jnp.sum(inl_e[best_e] & mask)
    ).astype(jnp.float32)
    n_similar_e = jnp.sum((ngood_model.astype(jnp.float32) > 0.7 * n_bestf).astype(jnp.int32))
    second = jnp.sort(ngood_model)[-2].astype(jnp.float32)
    clear_winner = jnp.where(is_planar, second < 0.75 * n_bestf, n_similar_e <= 1)
    ok = (
        (n_best >= min_good)
        & (n_bestf > 0.9 * n_model_inl)
        & clear_winner
        & (parallax_deg[best_m] > min_parallax_deg)
    )
    return InitResult(
        R=Rs[best_m],
        t=ts[best_m],
        points=pts[best_m],
        good=good[best_m],
        n_good=n_best,
        is_planar=is_planar,
        ok=ok,
    )
