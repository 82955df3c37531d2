"""Device-side tracking kernels: motion-model association + local-map association.

Replacements for the two per-frame hot associations + optimizations:
  - TrackWithMotionModel: OrbMatcher::SearchByProjection(F, LastFrame, th)
    (reference: src/orb_features/orb_matcher.cpp:1312-1453) followed by
    Optimizer::PoseOptimization (src/core/tracker.cpp:756-824).
  - TrackLocalMap: Frame::IsInFrustum + SearchByProjection(F, points, th)
    (src/data/frame.cpp:277-337, orb_matcher.cpp:13-103) followed by PoseOptimization
    (tracker.cpp:1136-1174).

Each is one jitted fixed-shape program: dense matmul Hamming + dense gate masks replace
the grid lookups; the two PoseOptimizations run inside the same program, so a tracked
frame is TWO device dispatches end-to-end (front-end + tracking).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import se3
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.optim import pose_opt
from slam_framework_tpu.pipeline.frame import FrameData

TH_HIGH = 100
TH_LOW = 50


class TrackResult(NamedTuple):
    pose: jnp.ndarray        # (4,4) optimized Tcw
    assoc: jnp.ndarray       # (N_cur,) int32 — index into the point block, -1 if none
    inlier: jnp.ndarray      # (N_cur,) bool — assoc survived pose optimization
    n_matches: jnp.ndarray   # () int32 matches fed to the optimizer
    n_inliers: jnp.ndarray   # () int32 inliers after optimization
    visible: jnp.ndarray = None  # (P,) bool — block point in frustum (local-map stage)


class PointBlock(NamedTuple):
    """Fixed-capacity block of map points shipped to device for association."""

    pos: jnp.ndarray        # (P, 3)
    desc: jnp.ndarray       # (P, 8) uint32
    normal: jnp.ndarray     # (P, 3) mean viewing direction (world)
    min_dist: jnp.ndarray   # (P,)
    max_dist: jnp.ndarray   # (P,)
    mask: jnp.ndarray       # (P,) bool


def _obs_from_assoc(cur: FrameData, pts: jnp.ndarray, assoc: jnp.ndarray) -> pose_opt.PoseObs:
    """Build fixed-shape PoseObs: one slot per current feature."""
    matched = assoc >= 0
    safe = jnp.where(matched, assoc, 0)
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * cur.octave.astype(jnp.float32)))
    return pose_opt.PoseObs(
        points_w=pts[safe],
        uv=cur.xy,
        ur=jnp.where(matched & (cur.u_right >= 0), cur.u_right, -1.0),
        inv_sigma2=inv_sigma2,
        mask=matched,
    )


def predict_scale(dist: jnp.ndarray, max_dist: jnp.ndarray, num_levels: int = 8, log_sf: float = 0.1823215568) -> jnp.ndarray:
    """MapPoint::PredictScale (map_point.cpp:366-396): level from distance ratio."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / log_sf)
    return jnp.clip(lvl, 0, num_levels - 1).astype(jnp.int32)


def track_motion(
    cur: FrameData,
    pred_pose: jnp.ndarray,
    last_pts: jnp.ndarray,     # (N_last, 3) world positions of last frame's points
    last_desc: jnp.ndarray,    # (N_last, 8)
    last_octave: jnp.ndarray,  # (N_last,)
    last_angle: jnp.ndarray,   # (N_last,)
    last_mask: jnp.ndarray,    # (N_last,) bool — slot has a map point
    K: Intrinsics,
    th: float = 7.0,
    num_levels: int = 8,
    scale_factor: float = 1.2,
) -> TrackResult:
    """SearchByProjection(F, LastFrame) + PoseOptimization, one device program.

    Window radius th * scale(last octave) with the reference's doubling retry fused in:
    we use 2*th directly when the narrow search yields < 20 matches (computed branch-
    free by running both gates and selecting)."""
    sf = scale_factor ** last_octave.astype(jnp.float32)

    uvz = _project(pred_pose, last_pts, K)
    u, v, z = uvz
    in_front = z > 0.1  # the window gate handles image bounds
    pred_uv = jnp.stack([u, v], axis=-1)

    ham = hamming.hamming_matrix(last_desc, cur.desc)
    oct_g = matcher.octave_gate(last_octave, cur.octave, -1, 1)
    base_gate = oct_g & last_mask[:, None] & cur.valid[None, :] & in_front[:, None]

    def run(radius_mult):
        gate = matcher.window_gate(pred_uv, cur.xy, radius_mult * th * sf) & base_gate
        res = matcher.gated_match(ham, gate, max_dist=TH_HIGH)
        res = matcher.rotation_consistency(last_angle, cur.angle, res)
        return res

    res1 = run(1.0)
    res2 = run(2.0)
    use_wide = res1.count < 20
    res = matcher.MatchResult(
        idx=jnp.where(use_wide, res2.idx, res1.idx),
        dist=jnp.where(use_wide, res2.dist, res1.dist),
        valid=jnp.where(use_wide, res2.valid, res1.valid),
    )
    res = matcher.resolve_duplicate_columns(res, cur.capacity)

    # invert: per current feature -> last slot
    assoc = _invert_matches(res, last_pts.shape[0], cur.capacity)

    obs = _obs_from_assoc(cur, last_pts, assoc)
    # 3 rounds x 4 LM iters: per-frame tracking starts near the optimum; the
    # reference's 4x10 schedule (optimizer.cpp:359) is sized for cold starts and
    # costs 80 sequential solves per frame.
    opt = pose_opt.optimize_pose(pred_pose, obs, K, n_rounds=3, n_iters=4)
    return TrackResult(
        pose=opt.pose,
        assoc=assoc,
        inlier=opt.inliers,
        n_matches=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_inliers=opt.num_inliers,
    )


def track_local_map(
    cur: FrameData,
    pose: jnp.ndarray,
    prior_assoc: jnp.ndarray,   # (N_cur,) int32 into `block` (from motion tracking), -1 none
    block: PointBlock,
    K: Intrinsics,
    th: float = 1.0,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
) -> TrackResult:
    """Frustum-cull + SearchByProjection(local map) + PoseOptimization.

    Reproduces the reference gates (frame.cpp:277-337, orb_matcher.cpp:13-103):
    in-image projection, distance within [0.8*min, 1.2*max], viewing cos > 0.5,
    radius 2.5 (viewCos>0.998) else 4.0, scaled by predicted octave; nn-ratio 0.9
    within the window; TH_HIGH acceptance.
    """
    u, v, z = _project(pose, block.pos, K)
    Twc = se3.se3_inverse(pose)
    cam_center = Twc[:3, 3]
    delta = block.pos - cam_center[None, :]
    dist = jnp.linalg.norm(delta, axis=-1)
    view_cos = jnp.sum(delta * block.normal, axis=-1) / jnp.maximum(dist, 1e-6)

    W, H = image_wh
    in_frustum = (
        block.mask
        & (z > 0.1)
        & (u >= 0)
        & (u < W)
        & (v >= 0)
        & (v < H)
        & (dist >= 0.8 * block.min_dist)
        & (dist <= 1.2 * block.max_dist)
        & (view_cos > 0.5)
    )

    lvl = predict_scale(dist, block.max_dist, num_levels)
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * (scale_factor ** lvl.astype(jnp.float32)) * th
    pred_uv = jnp.stack([u, v], axis=-1)

    ham = hamming.hamming_matrix(block.desc, cur.desc)
    gate = (
        matcher.window_gate(pred_uv, cur.xy, radius)
        & matcher.octave_gate(lvl, cur.octave, -1, 1)
        & in_frustum[:, None]
        & cur.valid[None, :]
    )
    # don't steal features already associated by motion tracking
    already = prior_assoc >= 0
    gate &= ~already[None, :]
    # NOTE: the reference applies the 0.9 nn-ratio only when best and second-best
    # candidates sit on the same pyramid level (orb_matcher.cpp:13-103). Until
    # SearchInNeighbors-style fusion lands, duplicate map points of the same landmark
    # would fail any ratio test, so the ratio gate is deliberately off here.
    res = matcher.gated_match(ham, gate, max_dist=TH_HIGH)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)

    assoc = _invert_matches(res, block.pos.shape[0], cur.capacity)
    assoc = jnp.where(already, prior_assoc, assoc)

    obs = _obs_from_assoc(cur, block.pos, assoc)
    opt = pose_opt.optimize_pose(pose, obs, K, n_rounds=3, n_iters=4)
    return TrackResult(
        pose=opt.pose,
        assoc=assoc,
        inlier=opt.inliers,
        n_matches=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_inliers=opt.num_inliers,
        visible=in_frustum,
    )


def track_reference_fallback(
    cur: FrameData,
    last_pose: jnp.ndarray,      # (4,4) last tracked frame's pose (NOT extrapolated)
    block: PointBlock,
    K: Intrinsics,
) -> TrackResult:
    """TrackReferenceKeyFrame (tracker.cpp:657-694 + SearchByBoW,
    orb_matcher.cpp:133-262): when the constant-velocity model breaks, associate by
    GLOBAL descriptor matching against the local point block — no projection window
    (the predicted pose is exactly what can't be trusted) — with mutual-best,
    0.7 nn-ratio and TH_LOW acceptance, then optimize from the LAST pose.
    The reference restricts candidates by shared vocabulary node to cut CPU cost;
    the dense Hamming matrix needs no such pruning."""
    ham = hamming.hamming_matrix(block.desc, cur.desc)
    gate = block.mask[:, None] & cur.valid[None, :]
    res = matcher.gated_match(ham, gate, max_dist=TH_LOW, nn_ratio=0.7, mutual=True)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    assoc = _invert_matches(res, block.pos.shape[0], cur.capacity)
    obs = _obs_from_assoc(cur, block.pos, assoc)
    # cold start: the reference runs the full 4x10 schedule here (optimizer.cpp:359)
    opt = pose_opt.optimize_pose(last_pose, obs, K, n_rounds=4, n_iters=6)
    return TrackResult(
        pose=opt.pose,
        assoc=assoc,
        inlier=opt.inliers,
        n_matches=jnp.sum((assoc >= 0).astype(jnp.int32)),
        n_inliers=opt.num_inliers,
    )


def fuse_candidates(
    cur: FrameData,
    pose: jnp.ndarray,
    assoc: jnp.ndarray,          # (N_cur,) current associations into `block` (-1 none)
    block: PointBlock,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
) -> jnp.ndarray:
    """Per unassociated feature: the block point it duplicates, or -1.

    Dense formulation of OrbMatcher::Fuse (reference: orb_matcher.cpp:804-954): project
    map points into the frame, and for features that are NOT yet associated, accept a
    strict match (radius 4 * scale(predicted level), Hamming <= TH_LOW, octave within
    +-1, depth-consistent for stereo features). The keyframe-creation path uses this to
    bind re-detections to EXISTING points instead of spawning duplicates — the
    mechanism that anchors new geometry to old geometry (MapPoint::Replace /
    SearchInNeighbors semantics, local_mapper.cpp:494-554)."""
    u, v, z = _project(pose, block.pos, K)
    Twc = se3.se3_inverse(pose)
    cam_center = Twc[:3, 3]
    delta = block.pos - cam_center[None, :]
    dist = jnp.linalg.norm(delta, axis=-1)
    W, H = image_wh
    in_frustum = (
        block.mask & (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & (dist >= 0.5 * block.min_dist) & (dist <= 1.5 * block.max_dist)
    )
    lvl = predict_scale(dist, block.max_dist, num_levels)
    radius = 4.0 * (scale_factor ** lvl.astype(jnp.float32))
    pred_uv = jnp.stack([u, v], axis=-1)

    ham = hamming.hamming_matrix(block.desc, cur.desc)
    # depth consistency: stereo feature depth must agree with the point depth
    has_d = cur.depth > 0
    depth_ok = (~has_d)[None, :] | (
        jnp.abs(z[:, None] - cur.depth[None, :]) < 0.2 * jnp.maximum(z[:, None], 1.0)
    )
    gate = (
        matcher.window_gate(pred_uv, cur.xy, radius)
        & matcher.octave_gate(lvl, cur.octave, -1, 1)
        & in_frustum[:, None]
        & cur.valid[None, :]
        & depth_ok
        & (assoc < 0)[None, :]
    )
    res = matcher.gated_match(ham, gate, max_dist=TH_LOW)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    return _invert_matches(res, block.pos.shape[0], cur.capacity)


def _invert_matches(res: matcher.MatchResult, n_rows: int, n_cols: int) -> jnp.ndarray:
    """Row->col matches to per-column best row index (-1 none), dense formulation
    (argmin over a (R, C) masked distance matrix — no colliding scatters)."""
    cols = jnp.arange(n_cols, dtype=jnp.int32)
    chose = res.valid[:, None] & (res.idx[:, None] == cols[None, :])
    d = jnp.where(chose, res.dist[:, None], matcher.BIG)
    best_row = jnp.argmin(d, axis=0).astype(jnp.int32)
    has = jnp.min(d, axis=0) < matcher.BIG
    return jnp.where(has, best_row, -1)


def _project(Tcw: jnp.ndarray, pts: jnp.ndarray, K: Intrinsics):
    Xc = se3.transform_points(Tcw, pts)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = K.fx * x / z_safe + K.cx
    v = K.fy * y / z_safe + K.cy
    return u, v, z
