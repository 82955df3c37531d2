"""Generic gated descriptor matching — the one primitive behind all 9 reference matchers.

The reference OrbMatcher (src/orb_features/orb_matcher.h:24-96) has 9 entry points
(SearchByProjection x4, SearchByBoW x2, SearchForInitialization, SearchForTriangulation,
SearchBySim3, Fuse x2) that all share one inner loop: for a query feature/point, scan a
candidate set, keep the best/second-best Hamming distance subject to geometric gates,
then apply threshold / nn-ratio / rotation-histogram filters.

The dense formulation: build the full (N, M) Hamming matrix as a matmul
(matching.hamming), AND it with a boolean gate matrix encoding the geometric windows,
then do masked row argmin + filters as dense vector ops. Each reference entry point
becomes "construct gates, call gated_match" (see pipeline/ modules for the
constructions). Rotation-histogram consistency reproduces ComputeThreeMaxima
(orb_matcher.cpp:1584-1625, HISTO_LENGTH=30).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

BIG = 1 << 20  # sentinel distance for gated-out pairs (must exceed 256)

HISTO_LENGTH = 30  # orb_matcher.cpp:7


class MatchResult(NamedTuple):
    idx: jnp.ndarray    # (N,) int32 — matched column per row, -1 if none
    dist: jnp.ndarray   # (N,) int32 — Hamming distance of the match (BIG if none)
    valid: jnp.ndarray  # (N,) bool

    @property
    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def gated_match(
    ham: jnp.ndarray,
    gate: Optional[jnp.ndarray] = None,
    max_dist: int = 256,
    nn_ratio: Optional[float] = None,
    mutual: bool = False,
) -> MatchResult:
    """Masked best-match per row of a Hamming matrix.

    ham:  (N, M) int32 distances.
    gate: (N, M) bool — admissible pairs (geometric windows, scale checks, ...).
    max_dist: accept threshold (TH_LOW=50 / TH_HIGH=100 in the reference).
    nn_ratio: if set, require best < ratio * second_best (reference nn_ratio_).
    mutual: if set, require row i's best column j to also have i as its best row
            (the reference achieves this with erase-on-better loops; mutual-best is
            the order-independent equivalent).
    """
    d = ham if gate is None else jnp.where(gate, ham, BIG)
    best_j = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.min(d, axis=1)
    # Second best: mask out the best column per row.
    cols = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
    d2 = jnp.where(cols == best_j[:, None], BIG, d)
    second_d = jnp.min(d2, axis=1)

    valid = best_d <= max_dist
    if nn_ratio is not None:
        valid &= best_d.astype(jnp.float32) < nn_ratio * second_d.astype(jnp.float32)
    if mutual:
        col_best_i = jnp.argmin(d, axis=0).astype(jnp.int32)  # (M,)
        valid &= col_best_i[best_j] == jnp.arange(d.shape[0], dtype=jnp.int32)
    idx = jnp.where(valid, best_j, -1)
    return MatchResult(idx=idx, dist=best_d, valid=valid)


def resolve_duplicate_columns(res: MatchResult, num_cols: int) -> MatchResult:
    """Keep only the lowest-distance row per matched column.

    Reference matchers overwrite earlier matches when a better one arrives
    (e.g. orb_matcher.cpp SearchByProjection duplicate handling); this is the
    batched equivalent: a column matched by several rows keeps the best row.
    """
    # Dense formulation (scatters serialize on colliding indices): build the
    # (rows, cols) assignment mask and reduce per column.
    rows_n = res.idx.shape[0]
    cols = jnp.arange(num_cols, dtype=jnp.int32)
    chose = res.valid[:, None] & (res.idx[:, None] == cols[None, :])  # (R, C)
    d = jnp.where(chose, res.dist[:, None], BIG)
    col_min = jnp.min(d, axis=0)                      # (C,)
    col_row = jnp.argmin(d, axis=0).astype(jnp.int32)  # lowest row wins ties
    safe_j = jnp.where(res.valid, res.idx, 0)
    winner = res.valid & (col_row[safe_j] == jnp.arange(rows_n, dtype=jnp.int32)) & (
        col_min[safe_j] < BIG
    )
    return MatchResult(idx=jnp.where(winner, res.idx, -1), dist=res.dist, valid=winner)


def rotation_consistency(
    angle_a: jnp.ndarray,
    angle_b: jnp.ndarray,
    res: MatchResult,
) -> MatchResult:
    """Keep matches whose orientation delta falls in the 3 dominant histogram bins.

    Reproduces the reference's rotation-histogram filter
    (orb_matcher.cpp ComputeThreeMaxima :1584-1625): 30 bins over [0, 2pi); bins 2 and 3
    are dropped when below 0.1x the top bin.
    angle_a: (N,) query angles (radians); angle_b: (M,) train angles.
    """
    safe_j = jnp.where(res.valid, res.idx, 0)
    delta = angle_a - angle_b[safe_j]
    # wrap to [0, 2pi)
    two_pi = 2.0 * jnp.pi
    delta = jnp.mod(delta, two_pi)
    bins = jnp.clip((delta * (HISTO_LENGTH / two_pi)).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    # one-hot reduction instead of scatter-add (scatters serialize on collisions)
    onehot = (bins[:, None] == jnp.arange(HISTO_LENGTH, dtype=jnp.int32)[None, :])
    hist = jnp.sum(onehot & res.valid[:, None], axis=0, dtype=jnp.int32)
    top3_vals, top3_idx = jax.lax.top_k(hist, 3)
    # Reference guards: drop 2nd/3rd bins if < 0.1 * max.
    keep_bin2 = top3_vals[1].astype(jnp.float32) >= 0.1 * top3_vals[0].astype(jnp.float32)
    keep_bin3 = top3_vals[2].astype(jnp.float32) >= 0.1 * top3_vals[0].astype(jnp.float32)
    ok = (
        (bins == top3_idx[0])
        | ((bins == top3_idx[1]) & keep_bin2)
        | ((bins == top3_idx[2]) & keep_bin3)
    )
    valid = res.valid & ok
    return MatchResult(idx=jnp.where(valid, res.idx, -1), dist=res.dist, valid=valid)


def window_gate(
    pred_uv: jnp.ndarray,
    feat_uv: jnp.ndarray,
    radius: jnp.ndarray,
) -> jnp.ndarray:
    """(N, M) gate: feature j within a square window of radius_i around prediction i.

    Reproduces the grid-search windows of SearchByProjection / GetFeaturesInArea
    (frame.cpp:348-403) without the 64x48 grid: the dense mask IS the grid.
    """
    du = jnp.abs(pred_uv[:, None, 0] - feat_uv[None, :, 0])
    dv = jnp.abs(pred_uv[:, None, 1] - feat_uv[None, :, 1])
    r = radius[:, None] if radius.ndim == 1 else radius
    return (du < r) & (dv < r)


def octave_gate(
    pred_octave: jnp.ndarray,
    feat_octave: jnp.ndarray,
    min_delta: int = -1,
    max_delta: int = 1,
) -> jnp.ndarray:
    """(N, M) gate on pyramid-level agreement (reference scale checks)."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= min_delta) & (d <= max_delta)
