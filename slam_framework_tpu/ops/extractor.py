"""Top-level ORB extractor: pyramid -> FAST -> uniform select -> orientation -> rBRIEF.

Replacement for ORBextractor::Compute
(reference: src/orb_features/orb_extractor.cpp:985-1049). One jitted program per image
geometry; all outputs are fixed-shape (max_features slots + validity mask), so the whole
per-frame front-end compiles once and never recompiles during a sequence.

Output coordinate convention: `xy` is in level-0 (full-resolution) pixels, like the
reference's scaled-up keypoints (orb_extractor.cpp:1041-1048); `octave` is the pyramid
level, `size`/`sigma2` follow the reference's scale-pyramid bookkeeping used by the
matchers and BA (frame.h level_sigma2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.config import OrbConfig
from slam_framework_tpu.ops import brief, fast, orient, pyramid, select


DETECT_MARGIN = 16  # = EDGE_THRESHOLD - 3 (reference orb_extractor.cpp:707-713)


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (the device Frame's feature block)."""

    xy: jnp.ndarray        # (N, 2) fp32 — level-0 pixel coords (x, y)
    response: jnp.ndarray  # (N,) fp32
    angle: jnp.ndarray     # (N,) fp32 radians
    octave: jnp.ndarray    # (N,) int32 pyramid level
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit descriptors
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class OrbExtractor:
    """Callable extractor; jit-compiles per (H, W) image geometry."""

    def __init__(self, cfg: OrbConfig, max_features: int | None = None):
        self.cfg = cfg
        self.max_features = max_features or cfg.num_features
        self.scales = pyramid.scale_factors(cfg.num_levels, cfg.scale_factor)
        self.sigma2 = (self.scales**2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.per_level = pyramid.features_per_level(
            self.max_features, cfg.num_levels, cfg.scale_factor
        )
        self._jit = jax.jit(self._extract)

    def __call__(self, img: jnp.ndarray) -> Features:
        """img: (H, W) uint8 or fp32 grayscale."""
        return self._jit(img)

    def _extract(self, img: jnp.ndarray) -> Features:
        cfg = self.cfg
        img = img.astype(jnp.float32)
        levels = pyramid.build_pyramid(img, cfg.num_levels, cfg.scale_factor)
        blurred = pyramid.build_blurred_pyramid(img, cfg.num_levels, cfg.scale_factor)
        return self._extract_from_pyramid(levels, blurred)

    def _extract_from_pyramid(self, levels, blurred=None) -> Features:
        """Extract from a prebuilt fp32 pyramid (lets the caller share the pyramid
        with stereo matching instead of building it twice). `blurred` optionally
        supplies the pre-BRIEF Gaussian-blurred levels (the fused resize+blur
        operators in ops/pyramid.py make them nearly free); falls back to
        per-level gaussian_blur when absent."""
        cfg = self.cfg

        per_level_feats = []
        for lvl, lvl_img in enumerate(levels):
            n_lvl = self.per_level[lvl]
            if n_lvl <= 0:
                continue
            # ONE strength map + ONE NMS serves both FAST thresholds: suppression
            # only ever comes from a strictly stronger neighbor, which passes every
            # threshold the suppressed pixel passes, so NMS commutes with the
            # threshold cut (reference runs cv::FAST twice per cell,
            # orb_extractor.cpp:750-757).
            with jax.named_scope("fast"):
                nms = fast.nms3x3(fast.fast_strength_map(lvl_img))
            strength = fast.mask_border(nms, DETECT_MARGIN)
            score_hi = jnp.where(strength > float(cfg.ini_thresh_fast), strength, 0.0)
            score_lo = jnp.where(strength > float(cfg.min_thresh_fast), strength, 0.0)
            sel = select.select_uniform(score_hi, score_lo, n_lvl, cell=cfg.fast_cell_size)

            # ONE window gather feeds both orientation (raw level, channel 0)
            # and BRIEF (blurred level, channel 1): per-slice latency dominates
            # the gather, so stacking channels halves the front-end's largest
            # device cost (ops/brief.fused_windows)
            blur_lvl = blurred[lvl] if blurred is not None else pyramid.gaussian_blur(lvl_img)
            wins = brief.fused_windows(lvl_img, blur_lvl, sel.xy)
            angles = orient.ic_angles_from_windows(
                wins[..., 0], brief.MAX_ROTATED_OFFSET - orient.HALF_PATCH
            )
            desc = brief.descriptors_from_windows(
                wins[..., 1].reshape(wins.shape[0], -1), angles
            )

            scale = float(self.scales[lvl])
            xy0 = sel.xy.astype(jnp.float32) * scale
            octave = jnp.full((n_lvl,), lvl, jnp.int32)
            per_level_feats.append(
                Features(
                    xy=xy0,
                    response=sel.response,
                    angle=angles,
                    octave=octave,
                    desc=desc,
                    valid=sel.valid,
                )
            )

        cat = Features(*[jnp.concatenate([f[i] for f in per_level_feats], axis=0)
                         for i in range(len(per_level_feats[0]))])
        # Pad or trim to the fixed capacity.
        n = cat.xy.shape[0]
        cap = self.max_features
        if n < cap:
            pad = cap - n
            cat = Features(
                xy=jnp.concatenate([cat.xy, jnp.zeros((pad, 2), jnp.float32)]),
                response=jnp.concatenate([cat.response, jnp.zeros(pad, jnp.float32)]),
                angle=jnp.concatenate([cat.angle, jnp.zeros(pad, jnp.float32)]),
                octave=jnp.concatenate([cat.octave, jnp.zeros(pad, jnp.int32)]),
                desc=jnp.concatenate([cat.desc, jnp.zeros((pad, 8), jnp.uint32)]),
                valid=jnp.concatenate([cat.valid, jnp.zeros(pad, bool)]),
            )
        elif n > cap:
            cat = Features(*[a[:cap] for a in cat])
        return cat


@functools.lru_cache(maxsize=4)
def default_extractor(num_features: int = 2000, num_levels: int = 8) -> OrbExtractor:
    return OrbExtractor(OrbConfig(num_features=num_features, num_levels=num_levels))
