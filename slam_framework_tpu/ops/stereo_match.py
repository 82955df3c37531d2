"""Rectified stereo matching: row-banded Hamming search + SAD subpixel refinement.

Replacement for Frame::ComputeStereoMatches
(reference: src/data/frame.cpp:406-577). The reference builds per-row candidate lists
and loops left keypoints; here the whole thing is one dense program:

  1. (N_l, N_r) Hamming matrix as a matmul (matching.hamming), gated by
     row-band  |v_l - v_r| <= 2 * scale_l,  octave agreement (+-1), and disparity in
     [min_disp, max_disp]  (reference :427-443, :469-480).
  2. best right match per left keypoint, threshold (TH_HIGH + TH_LOW)/2 = 75 (:466).
  3. subpixel: 11x11 SAD between level-image windows over +-5 shifts with
     center-intensity normalization and parabola interpolation (:490-549), done for all
     keypoints of each level at once (masked), then outlier rejection at
     1.5 * 1.4 * median-ish threshold — the reference sorts distances and cuts at
     1.5 * 1.4 * median (:555-570); we use the same rule computed via quantile.

Outputs per left feature: u_right (fp32, -1 invalid) and depth (fp32, -1 invalid).
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.ops.extractor import Features

SAD_W = 5          # half window -> 11x11 (frame.cpp:495)
SAD_L = 5          # search slides -> +-5 (frame.cpp:496)
TH_STEREO = 75     # (TH_HIGH + TH_LOW) / 2 (frame.cpp:466 area)


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray  # (N,) fp32, -1 where unmatched
    depth: jnp.ndarray    # (N,) fp32, -1 where unmatched


def match_stereo(
    left: Features,
    right: Features,
    left_pyr: List[jnp.ndarray],
    right_pyr: List[jnp.ndarray],
    K: Intrinsics,
    scale_factors,
) -> StereoMatches:
    """scale_factors: (L,) fp32 per-octave scale (1.2^l)."""
    sf = jnp.asarray(scale_factors)
    scale_l = sf[left.octave]

    ham = hamming.hamming_matrix(left.desc, right.desc)

    # Gates (reference :427-443): row band scaled by left octave, octave +-1,
    # disparity within [min_disp, max_disp].
    vl = left.xy[:, 1]
    vr = right.xy[:, 1]
    row_gate = jnp.abs(vl[:, None] - vr[None, :]) <= (2.0 * scale_l)[:, None]
    oct_gate = matcher.octave_gate(left.octave, right.octave, -1, 1)
    min_disp = 0.0
    max_disp = K.bf / max(K.baseline, 1e-6)  # = fx: disparity at depth = baseline (:439)
    disp = left.xy[:, 0][:, None] - right.xy[None, :, 0]
    disp_gate = (disp >= min_disp) & (disp <= max_disp)
    valid_gate = left.valid[:, None] & right.valid[None, :]

    res = matcher.gated_match(
        ham, row_gate & oct_gate & disp_gate & valid_gate, max_dist=TH_STEREO
    )

    safe_j = jnp.where(res.valid, res.idx, 0)
    ur0 = right.xy[safe_j, 0]  # level-0 coords of best right match

    # --- Subpixel SAD from a pyramid ATLAS (all levels stacked vertically) ---
    # A per-level pass would gather windows for ALL N keypoints at EVERY level
    # (8x the data); stacking the levels into one tall image lets each keypoint
    # gather exactly one (11, 11) + (11, 21) window from its own level.
    # Keypoints whose window would cross a level edge are masked out instead of
    # padded — same semantics as the reference's bounds 'continue'
    # (frame.cpp:505-515 area).
    num_levels = len(left_pyr)
    W, Lr = SAD_W, SAD_L
    W0 = left_pyr[0].shape[1]
    row_off_np = np.cumsum([0] + [lp_.shape[0] for lp_ in left_pyr[:-1]])
    atlas_l = jnp.concatenate(
        [jnp.pad(lp_, ((0, 0), (0, W0 - lp_.shape[1]))) for lp_ in left_pyr], axis=0
    )
    atlas_r = jnp.concatenate(
        [jnp.pad(rp_, ((0, 0), (0, W0 - rp_.shape[1]))) for rp_ in right_pyr], axis=0
    )
    row_off = jnp.asarray(row_off_np, jnp.int32)
    lvl_h = jnp.asarray([lp_.shape[0] for lp_ in left_pyr], jnp.int32)
    lvl_w = jnp.asarray([lp_.shape[1] for lp_ in left_pyr], jnp.int32)

    inv_s = 1.0 / scale_l
    xl = jnp.round(left.xy[:, 0] * inv_s).astype(jnp.int32)
    yl = jnp.round(left.xy[:, 1] * inv_s).astype(jnp.int32)
    xr = jnp.round(ur0 * inv_s).astype(jnp.int32)

    oct_ = left.octave
    h_l, w_l = lvl_h[oct_], lvl_w[oct_]
    in_bounds = (
        (xl >= W) & (xl <= w_l - 1 - W)
        & (yl >= W) & (yl <= h_l - 1 - W)
        & (xr >= W + Lr) & (xr <= w_l - 1 - W - Lr)
    )
    sad_on = res.valid & in_bounds
    y_at = jnp.clip(yl + row_off[oct_], W, atlas_l.shape[0] - 1 - W)
    xl_c = jnp.clip(xl, W, W0 - 1 - W)
    xr_c = jnp.clip(xr, W + Lr, W0 - 1 - W - Lr)

    def left_window(x, y):
        return jax.lax.dynamic_slice(atlas_l, (y - W, x - W), (2 * W + 1, 2 * W + 1))

    def right_strip(x, y):
        return jax.lax.dynamic_slice(
            atlas_r, (y - W, x - W - Lr), (2 * W + 1, 2 * W + 1 + 2 * Lr)
        )

    lw = jax.vmap(left_window)(xl_c, y_at)
    rs = jax.vmap(right_strip)(xr_c, y_at)
    # Center-intensity normalization (frame.cpp:502, :517)
    lw = lw - lw[:, W : W + 1, W : W + 1]
    # SAD for each of the 2L+1 shifts
    sads = []
    for s in range(2 * Lr + 1):
        rw = rs[:, :, s : s + 2 * W + 1]
        rw = rw - rw[:, W : W + 1, W : W + 1]
        sads.append(jnp.sum(jnp.abs(lw - rw), axis=(1, 2)))
    sads = jnp.stack(sads, axis=1)  # (N, 2L+1)
    best_s = jnp.argmin(sads, axis=1)
    best_v = jnp.min(sads, axis=1)
    # Parabola fit needs interior optimum (frame.cpp:528-534)
    interior = (best_s > 0) & (best_s < 2 * Lr)
    sm1 = jnp.take_along_axis(sads, jnp.maximum(best_s - 1, 0)[:, None], axis=1)[:, 0]
    sp1 = jnp.take_along_axis(sads, jnp.minimum(best_s + 1, 2 * Lr)[:, None], axis=1)[:, 0]
    denom = jnp.maximum(2.0 * (sm1 + sp1 - 2.0 * best_v), 1e-6)
    delta = (sm1 - sp1) / denom
    delta = jnp.clip(delta, -1.0, 1.0)
    ur_sub = (xr.astype(jnp.float32) + (best_s - Lr).astype(jnp.float32) + delta) * scale_l

    use = sad_on & interior
    best_ur = jnp.where(use, ur_sub, -1.0)
    sad_best = jnp.where(sad_on, best_v, jnp.inf)

    matched = res.valid & use
    disparity = left.xy[:, 0] - best_ur
    matched &= (disparity >= min_disp) & (disparity < max_disp)
    # Reference also nudges disparity<=0 to 0.01 (:552); emulate by clamping tiny disp.
    disparity = jnp.maximum(disparity, 0.01)

    # Median-based outlier cut on SAD distances (frame.cpp:555-570: 1.5 * 1.4 * median)
    sad_for_median = jnp.where(matched, sad_best, jnp.nan)
    median = jnp.nanmedian(sad_for_median)
    keep = matched & (sad_best <= 1.5 * 1.4 * jnp.where(jnp.isnan(median), jnp.inf, median))

    depth = jnp.where(keep, K.bf / disparity, -1.0)
    u_right = jnp.where(keep, best_ur, -1.0)
    return StereoMatches(u_right=u_right, depth=depth)
