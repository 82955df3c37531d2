"""Per-frame front-end: extraction + stereo association as one jitted program.

Replacement for the Frame constructors
(reference: src/data/frame.cpp:61-209 — parallel L/R ORB extraction, undistortion,
ComputeStereoMatches, grid assignment). The reference's 64x48 feature grid exists to
accelerate windowed search; our matchers build dense window gates instead, so the grid
is unnecessary. The whole front-end is one XLA program per image geometry.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.geometry import projection
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.ops import pyramid, stereo_match
from slam_framework_tpu.utils import progcache
from slam_framework_tpu.ops.extractor import Features, OrbExtractor


def _undistort_if_needed(xy: jnp.ndarray, cfg: SlamConfig, K: Intrinsics) -> jnp.ndarray:
    """UndistortKeyPoints (frame.cpp:614-641): geometry downstream uses undistorted
    pixel coordinates; identity (no extra ops traced) when all coefficients are 0,
    which is the rectified-stereo/KITTI case."""
    cam = cfg.camera
    coeffs = (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    if not any(coeffs):
        return xy
    return projection.undistort_points(xy, K, jnp.asarray(coeffs, jnp.float32))


class FrameData(NamedTuple):
    """Fixed-capacity per-frame data block (device arrays)."""

    xy: jnp.ndarray       # (N, 2) f32 level-0 pixel coords
    response: jnp.ndarray  # (N,)
    angle: jnp.ndarray    # (N,)
    octave: jnp.ndarray   # (N,) int32
    desc: jnp.ndarray     # (N, 8) uint32
    valid: jnp.ndarray    # (N,) bool
    u_right: jnp.ndarray  # (N,) f32, -1 if no stereo match
    depth: jnp.ndarray    # (N,) f32, -1 if unknown

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class StereoFrontend:
    """left+right grayscale -> FrameData. Compiles once per image geometry."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = Intrinsics(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, cfg.camera.bf
        )
        self.extractor = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)
        self._jit = progcache.shared_jit(
            ("StereoFrontend", progcache.config_fingerprint(cfg)),
            lambda: jax.jit(self._process),
        )

    def __call__(self, left: jnp.ndarray, right: jnp.ndarray) -> FrameData:
        return self._jit(left, right)

    def _process(self, left: jnp.ndarray, right: jnp.ndarray) -> FrameData:
        cfg = self.cfg
        # ONE pyramid per image, shared between extraction and stereo matching
        # (the reference's parallel L/R extraction, frame.cpp:86-89, rebuilds
        # nothing either — each thread owns its pyramid).
        lf32 = left.astype(jnp.float32)
        rf32 = right.astype(jnp.float32)
        lp = pyramid.build_pyramid(lf32, cfg.orb.num_levels, cfg.orb.scale_factor)
        rp = pyramid.build_pyramid(rf32, cfg.orb.num_levels, cfg.orb.scale_factor)
        lb = pyramid.build_blurred_pyramid(lf32, cfg.orb.num_levels, cfg.orb.scale_factor)
        rb = pyramid.build_blurred_pyramid(rf32, cfg.orb.num_levels, cfg.orb.scale_factor)
        fl: Features = self.extractor._extract_from_pyramid(lp, lb)
        fr: Features = self.extractor._extract_from_pyramid(rp, rb)
        # stereo matching searches RAW rectified rows (frame.cpp:406-577);
        # undistortion applies to the geometry coordinates only
        sm = stereo_match.match_stereo(fl, fr, lp, rp, self.K, self.extractor.scales)
        return FrameData(
            xy=_undistort_if_needed(fl.xy, cfg, self.K),
            response=fl.response,
            angle=fl.angle,
            octave=fl.octave,
            desc=fl.desc,
            valid=fl.valid,
            u_right=sm.u_right,
            depth=sm.depth,
        )


class RgbdFrontend:
    """grayscale + registered depth map -> FrameData.

    Replacement for the RGB-D Frame constructor (reference:
    src/data/frame.cpp:120-158 + ComputeStereoFromRGBD :579-597): depth is sampled
    at each keypoint's integer location and a virtual right-image coordinate
    u_r = u - bf/d is synthesized so the whole stereo pipeline (tracking, BA stereo
    residuals) applies unchanged. Drop-in replacement for StereoFrontend: `_process`
    takes (gray, depth) like (left, right).
    """

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = Intrinsics(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, cfg.camera.bf
        )
        self.extractor = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)
        self._jit = progcache.shared_jit(
            ("RgbdFrontend", progcache.config_fingerprint(cfg)),
            lambda: jax.jit(self._process),
        )

    def __call__(self, gray: jnp.ndarray, depth: jnp.ndarray) -> FrameData:
        return self._jit(gray, depth)

    def _process(self, gray: jnp.ndarray, depth: jnp.ndarray) -> FrameData:
        cfg = self.cfg
        f: Features = self.extractor._extract(gray.astype(jnp.uint8))
        H, W = depth.shape
        ui = jnp.clip(jnp.round(f.xy[:, 0]).astype(jnp.int32), 0, W - 1)
        vi = jnp.clip(jnp.round(f.xy[:, 1]).astype(jnp.int32), 0, H - 1)
        d = depth[vi, ui].astype(jnp.float32)
        if cfg.camera.depth_map_factor not in (0.0, 1.0):
            d = d / cfg.camera.depth_map_factor
        has = (d > 0) & f.valid
        # depth sampled at the RAW pixel; u_right synthesized from the UNDISTORTED
        # coordinate like the reference (ComputeStereoFromRGBD, frame.cpp:579-597)
        xy_un = _undistort_if_needed(f.xy, cfg, self.K)
        u_right = jnp.where(has, xy_un[:, 0] - self.K.bf / jnp.maximum(d, 1e-6), -1.0)
        return FrameData(
            xy=xy_un,
            response=f.response,
            angle=f.angle,
            octave=f.octave,
            desc=f.desc,
            valid=f.valid,
            u_right=u_right,
            depth=jnp.where(has, d, -1.0),
        )


class MonoFrontend:
    """Single grayscale image -> FrameData (depth/u_right invalid)."""

    def __init__(self, cfg: SlamConfig, feature_multiplier: int = 1):
        self.cfg = cfg
        self.K = Intrinsics(
            cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, 0.0
        )
        import dataclasses

        orb = dataclasses.replace(
            cfg.orb, num_features=cfg.orb.num_features * feature_multiplier
        )
        self.extractor = OrbExtractor(orb, max_features=cfg.capacity.max_features * feature_multiplier)
        self._jit = progcache.shared_jit(
            ("MonoFrontend", progcache.config_fingerprint(cfg), feature_multiplier),
            lambda: jax.jit(self._process),
        )

    def __call__(self, img: jnp.ndarray) -> FrameData:
        return self._jit(img)

    def _process(self, img: jnp.ndarray) -> FrameData:
        f: Features = self.extractor._extract(img)
        n = f.xy.shape[0]
        return FrameData(
            xy=_undistort_if_needed(f.xy, self.cfg, self.K),
            response=f.response,
            angle=f.angle,
            octave=f.octave,
            desc=f.desc,
            valid=f.valid,
            u_right=jnp.full((n,), -1.0, jnp.float32),
            depth=jnp.full((n,), -1.0, jnp.float32),
        )
