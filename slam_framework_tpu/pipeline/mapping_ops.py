"""Batched mapping ops: epipolar-gated triangulation of new map points.

Replacement for LocalMapper::CreateNewMapPoints +
OrbMatcher::SearchForTriangulation (reference: src/core/local_mapper.cpp:258-492,
src/orb_features/orb_matcher.cpp:634-802): the reference walks vocabulary nodes and
matches feature-by-feature against each neighbor keyframe, then triangulates one
match at a time with cv::SVD. Here ALL neighbors are processed in one device
program: the (Nn, N, N) epipolar-gated Hamming tensor as a matmul, mutual-best
matching, batched DLT triangulation and validity checks as masked lanes.

The reference's vocabulary-node pruning (FeatureVector alignment) exists to cut CPU
cost; the dense matrix is a plain matmul, and the epipolar + octave gates carry
the selectivity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.geometry import se3, triangulation
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.utils.precision import einsum as _einsum, matmul as _mm


class KFBlock(NamedTuple):
    """Feature block of one keyframe (leading axis = neighbor index when stacked)."""

    pose: jnp.ndarray    # (..., 4, 4) Tcw
    xy: jnp.ndarray      # (..., N, 2)
    ur: jnp.ndarray      # (..., N) right-u or -1
    octave: jnp.ndarray  # (..., N) int32
    angle: jnp.ndarray   # (..., N)
    desc: jnp.ndarray    # (..., N, 8) uint32
    cand: jnp.ndarray    # (..., N) bool — valid feature, not yet associated


def block_from_store(packs, descs, idxs, poses, cand) -> KFBlock:
    """Assemble (stacked) KFBlocks by gathering keyframe rows from the
    device-resident store (pipeline/kf_store.py) INSIDE the consuming program —
    the dispatch ships only indices, poses, and candidate masks.

    packs: (K, N, 9) f32 store; descs: (K, N, 8) u32; idxs: (Nn,) int32;
    poses: (Nn, 4, 4); cand: (Nn, N) bool."""
    rows = jnp.take(packs, idxs, axis=0)        # (Nn, N, 9)
    desc = jnp.take(descs, idxs, axis=0)        # (Nn, N, 8)
    return KFBlock(
        pose=poses,
        xy=rows[..., 0:2],
        ur=rows[..., 2],
        octave=rows[..., 4].astype(jnp.int32),
        angle=rows[..., 5],
        desc=desc,
        cand=cand,
    )


class TriangulationResult(NamedTuple):
    idx: jnp.ndarray     # (Nn, N) int32 — neighbor feature matched to cur feature i
    pts: jnp.ndarray     # (Nn, N, 3) world points
    valid: jnp.ndarray   # (Nn, N) bool — passed all checks


class CompactTriangulation(NamedTuple):
    """Per-current-feature first-match compaction of TriangulationResult —
    8x smaller device->host transfer (the host writeback only ever uses the
    first neighbor that matched each feature)."""

    ni: jnp.ndarray      # (N,) int32 first matching neighbor index
    nf: jnp.ndarray      # (N,) int32 that neighbor's feature index
    pts: jnp.ndarray     # (N, 3) world point from that pair
    valid: jnp.ndarray   # (N,) bool any neighbor matched


def compact_first_match(res: TriangulationResult) -> CompactTriangulation:
    any_v = res.valid.any(axis=0)
    ni = jnp.argmax(res.valid, axis=0).astype(jnp.int32)
    ar = jnp.arange(res.idx.shape[1])
    return CompactTriangulation(
        ni=ni, nf=res.idx[ni, ar], pts=res.pts[ni, ar], valid=any_v
    )


def _fundamental_12(T1w: jnp.ndarray, T2w: jnp.ndarray, K: Intrinsics) -> jnp.ndarray:
    """F12 such that x2^T F12 x1 = 0 (ComputeFundamentalMatrix,
    local_mapper.cpp:615-630 computes the transpose convention; we keep x2'Fx1)."""
    T21 = se3.compose(T2w, se3.se3_inverse(T1w))
    R = T21[:3, :3]
    t = T21[:3, 3]
    E = _mm(se3.hat(t), R)
    Km = jnp.array([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]])
    Kinv = jnp.linalg.inv(Km)
    return _mm(_mm(Kinv.T, E), Kinv)


def _epipolar_dist2(F12: jnp.ndarray, xy1: jnp.ndarray, xy2: jnp.ndarray) -> jnp.ndarray:
    """(N1, N2) squared distance of x2 to the epipolar line of x1
    (CheckDistEpipolarLine, orb_matcher.cpp:~720)."""
    ones1 = jnp.ones((xy1.shape[0], 1), xy1.dtype)
    x1h = jnp.concatenate([xy1, ones1], axis=1)           # (N1, 3)
    lines = _mm(x1h, F12.T)                                # (N1, 3) line in image 2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    # dist^2 = (a u2 + b v2 + c)^2 / (a^2 + b^2)
    val = a * xy2[:, 0][None, :] + b * xy2[:, 1][None, :] + c
    den = jnp.maximum(a * a + b * b, 1e-12)
    return (val * val) / den


def _triangulate_pair(
    cur: KFBlock,
    nbr: KFBlock,
    K: Intrinsics,
    num_levels: int,
    scale_factor: float,
    min_baseline: float,
):
    """One neighbor: match + triangulate + validate. Shapes (N, ...)."""
    N = cur.xy.shape[0]
    sf2 = scale_factor**2
    sigma2_n = sf2 ** nbr.octave.astype(jnp.float32)

    # baseline gate (local_mapper.cpp:300-318): skip neighbor if cameras too close
    c1 = -_einsum("ji,j->i", cur.pose[:3, :3], cur.pose[:3, 3])
    c2 = -_einsum("ji,j->i", nbr.pose[:3, :3], nbr.pose[:3, 3])
    baseline_ok = jnp.linalg.norm(c2 - c1) > min_baseline

    F12 = _fundamental_12(cur.pose, nbr.pose, K)
    ed2 = _epipolar_dist2(F12, cur.xy, nbr.xy)             # (N, N)
    epi_gate = ed2 < 3.84 * sigma2_n[None, :]
    oct_gate = matcher.octave_gate(cur.octave, nbr.octave, -1, 1)
    gate = epi_gate & oct_gate & cur.cand[:, None] & nbr.cand[None, :]

    ham = hamming.hamming_matrix(cur.desc, nbr.desc)
    # best-per-row like the reference SearchForTriangulation (no mutual gate —
    # epipolar + rotation consistency carry the selectivity; mutual halves yield)
    res = matcher.gated_match(ham, gate, max_dist=50)
    res = matcher.rotation_consistency(cur.angle, nbr.angle, res)
    res = matcher.resolve_duplicate_columns(res, nbr.xy.shape[0])

    safe_j = jnp.where(res.valid, res.idx, 0)
    uv2 = nbr.xy[safe_j]

    # projection matrices P = K [R|t]
    Km = jnp.array([[K.fx, 0, K.cx], [0, K.fy, K.cy], [0, 0, 1.0]])
    P1 = _mm(Km, cur.pose[:3, :4])
    P2 = _mm(Km, nbr.pose[:3, :4])
    pts = triangulation.triangulate_dlt(P1, P2, cur.xy, uv2)  # (N, 3)

    # validity (local_mapper.cpp:394-471)
    err1, z1 = triangulation.reprojection_error(P1, pts, cur.xy)
    err2, z2 = triangulation.reprojection_error(P2, pts, uv2)
    sig2_1 = sf2 ** cur.octave.astype(jnp.float32)
    sig2_2 = sigma2_n[safe_j]
    cosp = triangulation.parallax_cosine(c1, c2, pts)
    d1 = jnp.linalg.norm(pts - c1[None, :], axis=-1)
    d2 = jnp.linalg.norm(pts - c2[None, :], axis=-1)
    ratio_factor = 1.5 * scale_factor
    ratio_octave = scale_factor ** (
        cur.octave.astype(jnp.float32) - nbr.octave[safe_j].astype(jnp.float32)
    )
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & (
        ratio_dist * ratio_factor > ratio_octave
    )
    ok = (
        res.valid
        & baseline_ok
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.9998)
        & (err1 < 5.991 * sig2_1)
        & (err2 < 5.991 * sig2_2)
        & scale_ok
        & (d1 > 1e-3)
    )
    return res.idx, pts, ok


def _fuse_points_one_kf(
    pt_pos, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_mask,
    kf: KFBlock,
    K: Intrinsics,
    num_levels: int,
    scale_factor: float,
    image_wh: tuple,
):
    """Project a point set into ONE keyframe and pick, per keyframe feature, the
    best duplicate-candidate point (OrbMatcher::Fuse, orb_matcher.cpp:804-954):
    in-frustum, dist within [min,max], viewing cos > 0.5, radius 3*scale(predicted
    level), octave within +-1, Hamming <= TH_LOW. Returns (F,) int32 point index
    per keyframe feature, -1 if none."""
    from slam_framework_tpu.pipeline import track_ops

    u, v, z = track_ops._project(kf.pose, pt_pos, K)
    Twc = se3.se3_inverse(kf.pose)
    center = Twc[:3, 3]
    delta = pt_pos - center[None, :]
    dist = jnp.linalg.norm(delta, axis=-1)
    view_cos = jnp.sum(delta * pt_normal, axis=-1) / jnp.maximum(dist, 1e-6)
    W, H = image_wh
    in_frustum = (
        pt_mask & (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & (dist >= 0.5 * pt_min_dist) & (dist <= 1.5 * pt_max_dist)
        & (view_cos > 0.5)
    )
    lvl = track_ops.predict_scale(dist, pt_max_dist, num_levels)
    radius = 3.0 * (scale_factor ** lvl.astype(jnp.float32))
    pred_uv = jnp.stack([u, v], axis=-1)

    ham = hamming.hamming_matrix(pt_desc, kf.desc)
    gate = (
        matcher.window_gate(pred_uv, kf.xy, radius)
        & matcher.octave_gate(lvl, kf.octave, -1, 1)
        & in_frustum[:, None]
        & kf.cand[None, :]
    )
    res = matcher.gated_match(ham, gate, max_dist=track_ops.TH_LOW)
    res = matcher.resolve_duplicate_columns(res, kf.xy.shape[0])
    return track_ops._invert_matches(res, pt_pos.shape[0], kf.xy.shape[0])


@functools.partial(
    jax.jit, static_argnames=("K", "num_levels", "scale_factor", "image_wh")
)
def fuse_points_into_kfs(
    pt_pos, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_mask,
    kfs: KFBlock,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
):
    """SearchInNeighbors' Fuse pass (local_mapper.cpp:494-554) over ALL neighbor
    keyframes in one device program. kfs: (Nn, ...) stacked blocks with `cand` =
    feature-valid (bound features included — conflicts become host-side merges).
    Returns (Nn, F) int32: best point per (keyframe, feature), -1 none."""
    fn = functools.partial(
        _fuse_points_one_kf, K=K, num_levels=num_levels,
        scale_factor=scale_factor, image_wh=image_wh,
    )
    return jax.vmap(
        lambda kf: fn(pt_pos, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_mask, kf)
    )(kfs)


@functools.partial(
    jax.jit, static_argnames=("K", "num_levels", "scale_factor")
)
def triangulate_with_neighbors(
    cur: KFBlock,
    nbrs: KFBlock,
    min_baseline: jnp.ndarray,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
) -> TriangulationResult:
    """cur: (N, ...) block; nbrs: (Nn, N, ...) stacked neighbor blocks. One device
    program for the whole CreateNewMapPoints pass."""
    fn = functools.partial(
        _triangulate_pair, K=K, num_levels=num_levels,
        scale_factor=scale_factor, min_baseline=min_baseline,
    )
    idx, pts, ok = jax.vmap(lambda nb: fn(cur, nb))(nbrs)
    return TriangulationResult(idx=idx, pts=pts, valid=ok)
