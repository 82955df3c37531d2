"""Spatially-uniform keypoint selection: fixed-grid ranked top-K.

Replacement for the reference's sequential quadtree distribution
(ORBextractor::DistributeOctTree, src/orb_features/orb_extractor.cpp:480-704) and the
per-cell FAST threshold fallback 20 -> 7 (:750-757).

Mechanism: the score map is tiled into fixed cells; per cell we take the top
K_CELL responses; each candidate carries its within-cell rank. The global selection
takes candidates ordered by (rank, -score): all cells' best first, then all cells'
second-best, etc. — the same spatial-uniformity objective as the quadtree, but fully
parallel and fixed-shape. The low-threshold score map is consulted only in cells where
the high-threshold map is empty, matching the reference semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Selected(NamedTuple):
    xy: jnp.ndarray        # (N, 2) int32, (x, y) level pixel coords
    response: jnp.ndarray  # (N,) fp32
    valid: jnp.ndarray     # (N,) bool


K_CELL = 8  # candidates retained per cell before global ranking


def _pad_to_multiple(score: jnp.ndarray, cell: int) -> jnp.ndarray:
    h, w = score.shape
    ph = (-h) % cell
    pw = (-w) % cell
    if ph or pw:
        score = jnp.pad(score, ((0, ph), (0, pw)))
    return score


def select_uniform(
    score_hi: jnp.ndarray,
    score_lo: jnp.ndarray,
    n_target: int,
    cell: int = 32,
) -> Selected:
    """Pick up to n_target keypoints, spatially uniform across `cell`-px tiles.

    score_hi / score_lo: (H, W) NMS'd corner-strength maps at the high / low FAST
    threshold (0 = not a corner). Returns fixed-size (n_target,) outputs with a
    validity mask.
    """
    h, w = score_hi.shape
    hi = _pad_to_multiple(score_hi, cell)
    lo = _pad_to_multiple(score_lo, cell)
    ph, pw = hi.shape
    ncy, ncx = ph // cell, pw // cell

    def to_cells(s):
        return s.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)

    hi_c = to_cells(hi)
    lo_c = to_cells(lo)
    # Per-cell fallback: use lo-threshold corners only where the hi map found nothing.
    cell_has_hi = jnp.max(hi_c, axis=1) > 0
    sc = jnp.where(cell_has_hi[:, None], hi_c, lo_c)

    k = min(K_CELL, cell * cell)
    top_scores, top_idx = jax.lax.top_k(sc, k)  # (ncells, k)

    # Decode in-cell flat index -> level (x, y)
    cell_ids = jnp.arange(ncy * ncx, dtype=jnp.int32)
    cy = (cell_ids // ncx)[:, None]
    cx = (cell_ids % ncx)[:, None]
    iy = top_idx // cell
    ix = top_idx % cell
    y = cy * cell + iy
    x = cx * cell + ix

    rank = jnp.broadcast_to(jnp.arange(k, dtype=jnp.float32)[None, :], top_scores.shape)
    flat_scores = top_scores.reshape(-1)
    flat_rank = rank.reshape(-1)
    flat_x = x.reshape(-1)
    flat_y = y.reshape(-1)
    is_corner = flat_scores > 0

    # Key: lower rank first, then higher score. Invalid candidates go last.
    max_score = 1e6
    key = jnp.where(is_corner, flat_rank * max_score - flat_scores, jnp.inf)
    n_pick = min(n_target, key.shape[0])
    _, order = jax.lax.top_k(-key, n_pick)
    sel_x = flat_x[order]
    sel_y = flat_y[order]
    sel_s = flat_scores[order]
    sel_valid = is_corner[order]

    if n_pick < n_target:
        pad = n_target - n_pick
        sel_x = jnp.concatenate([sel_x, jnp.zeros(pad, sel_x.dtype)])
        sel_y = jnp.concatenate([sel_y, jnp.zeros(pad, sel_y.dtype)])
        sel_s = jnp.concatenate([sel_s, jnp.zeros(pad, sel_s.dtype)])
        sel_valid = jnp.concatenate([sel_valid, jnp.zeros(pad, bool)])

    xy = jnp.stack([sel_x, sel_y], axis=-1).astype(jnp.int32)
    return Selected(xy=xy, response=sel_s, valid=sel_valid)
