"""FAST-9/16 corner detection as whole-image vectorized ops.

Replacement for the per-cell cv::FAST calls in ORBextractor
(reference: src/orb_features/orb_extractor.cpp:750-757). Instead of looping over 30px
cells and calling a scalar detector, we compute a dense corner-strength map for the
whole level in one shot: 16 shifted copies of the image, bright/dark masks, and a
contiguous-arc test (>= 9 of 16), then 3x3 non-max suppression. The per-cell
high->low threshold fallback (20 -> 7) is applied at selection time (see select.py),
matching the reference's semantics of "use low-threshold corners only in cells where
the high threshold found nothing".

The corner score is the exact FAST strength: the largest threshold for which the pixel
is still a corner, i.e. max over 9-arcs of (min over the arc of |p_i - c|).
"""

from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3 — 16 (dy, dx) offsets, clockwise from 12 o'clock.
# Same circle as every FAST implementation (offsets are a public constant).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9: need 9 contiguous of 16


def _shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img shifted so output[y, x] = img[y + dy, x + dx], edge-padded at borders."""
    padded = jnp.pad(img, 3, mode="edge")
    h, w = img.shape
    return padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]


def fast_strength_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense, threshold-free FAST-9 corner-strength map.

    img: (H, W) fp32. Returns (H, W) fp32 strength: the largest threshold t for which
    the pixel is still a FAST-9 corner (max over 9-arcs of min over the arc of the
    signed diff, bright and dark branches). A pixel is a corner at threshold t iff
    strength > t, so one strength map serves BOTH the reference's 20 and 7 thresholds
    (orb_extractor.cpp:750-757) — threshold commutes with NMS because a suppressing
    neighbor is always stronger than the pixel it suppresses.
    """
    diffs = jnp.stack([_shifted(img, dy, dx) for dy, dx in CIRCLE], axis=0) - img[None]
    # (16, H, W)

    def arc_strength(d):
        # Sliding circular window-min of width 9 in log steps: 4 elementwise mins
        # over (16, H, W) instead of 16 stacked 9-element reductions.
        m2 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
        m4 = jnp.minimum(m2, jnp.roll(m2, -2, axis=0))
        m8 = jnp.minimum(m4, jnp.roll(m4, -4, axis=0))
        m9 = jnp.minimum(m8, jnp.roll(d, -8, axis=0))
        return jnp.max(m9, axis=0)

    bright = arc_strength(diffs)
    dark = arc_strength(-diffs)
    return jnp.maximum(bright, dark)


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9 corner-strength map. 0 where not a corner at `threshold`.

    img: (H, W) fp32. Returns (H, W) fp32 score map (strength > threshold where corner).
    """
    strength = fast_strength_map(img)
    return jnp.where(strength > threshold, strength, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only pixels that are the strict max of their 3x3 neighborhood."""
    padded = jnp.pad(score, 1, mode="constant", constant_values=-jnp.inf)
    h, w = score.shape
    neigh = jnp.stack(
        [
            padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        axis=0,
    )
    keep = score > jnp.max(neigh, axis=0)
    return jnp.where(keep, score, 0.0)


def mask_border(score: jnp.ndarray, margin: int) -> jnp.ndarray:
    """Zero scores within `margin` pixels of the border (detection region clamp;
    reference uses EDGE_THRESHOLD-3 = 16, orb_extractor.cpp:707-713)."""
    h, w = score.shape
    out = jnp.zeros_like(score)
    return out.at[margin : h - margin, margin : w - margin].set(
        score[margin : h - margin, margin : w - margin]
    )
