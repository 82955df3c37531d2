"""Typed configuration for the SLAM engine.

Covers the reference JSON schema (reference: src/core/tracker.cpp:29-99,
config/kitti_config_stereo.json) plus every algorithmic constant the reference hardcodes
(SURVEY.md Appendix A), surfaced as fields so they are tunable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + radial-tangential distortion camera model.

    Mirrors the reference `camera` JSON block (config/kitti_config_stereo.json:4-19).
    """

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    bf: float = 386.1448  # baseline * fx (stereo)
    rgb: bool = True
    depth_map_factor: float = 0.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extractor parameters (reference: config `orb_parameters`,
    src/orb_features/orb_extractor.cpp)."""

    num_features: int = 2000
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_thresh_fast: int = 20
    min_thresh_fast: int = 7
    # Constants hardcoded in the reference (orb_extractor.cpp:13-15, :710):
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    fast_cell_size: int = 32  # reference uses 30 (orb_extractor.cpp:710); 32 tiles evenly


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor-matching thresholds (reference: src/orb_features/orb_matcher.cpp:5-7)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9
    nn_ratio_reloc: float = 0.75


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking-stage thresholds (reference: src/core/tracker.cpp, SURVEY.md App. A)."""

    grid_cols: int = 64
    grid_rows: int = 48
    min_matches_ref_kf: int = 15
    min_map_matches: int = 10
    min_matches_motion_model: int = 20
    track_local_map_min_inliers: int = 30
    track_local_map_min_inliers_reloc: int = 50
    local_map_kf_cap: int = 80
    new_kf_ref_ratio: float = 0.75
    new_kf_ref_ratio_few_kfs: float = 0.4
    new_kf_ref_ratio_mono: float = 0.9
    mono_init_min_matches: int = 100
    # stereo init gates: > 500 features (tracker.cpp:251) + a healthy stereo-
    # depth count; surfaced so tiny-shape configs (dryrun, tests) can bootstrap
    min_init_features: int = 500
    min_init_stereo: int = 250
    depth_threshold_factor: float = 35.0  # depth_threshold_ = bf*th/fx (tracker.cpp:91-94)
    # Rotational smoothing of the constant-velocity motion model. The reference
    # extrapolates the raw per-frame SE3 velocity (tracker.cpp:765); with chunked
    # (lag-batched) map refresh, raw rotational extrapolation couples with map
    # insertion into an unstable feedback loop (empirically: geometric error
    # growth ~1.55x/frame until loss). Round 1 damped the rotation rate by a
    # constant 0.75, which stabilized the loop but UNDER-predicts sustained
    # turns by 25% — at KITTI-like turn rates (>1 deg/frame) the projection
    # windows walk off the features and tracking is lost. This IIR smoothing
    # w_k = (1-a) * w_measured + a * w_{k-1} has DC gain 1 (steady turns
    # predicted exactly) while damping the oscillatory feedback mode (gain
    # |1-2a| < 1 for alternating errors).
    velocity_rotation_smoothing: float = 0.5


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Local-mapping thresholds (reference: src/core/local_mapper.cpp)."""

    covisibility_edge_min: int = 15           # keyframe.cpp:230
    point_cull_found_ratio: float = 0.25      # local_mapper.cpp:236-251
    kf_cull_redundancy: float = 0.9           # local_mapper.cpp:609
    triangulation_neighbors: int = 10         # local_mapper.cpp:264 (20 mono)
    triangulate_new_points: bool = True       # CreateNewMapPoints stage on/off
    cull_keyframes: bool = True               # KeyFrameCulling stage on/off
    kf_cull_min_age: int = 4                  # settle window before redundancy test
    local_ba_iters_first: int = 5             # optimizer.cpp:611
    local_ba_iters_second: int = 10           # optimizer.cpp:655
    # Pipelined dataflow over devices (SURVEY.md §2.3): run the
    # mapper's async device programs (local BA, triangulation, fusion) on this
    # device index so they never contend with the tracker's per-frame chip.
    # Falls back to the default device when the index doesn't exist (1-chip).
    device_index: int = 1
    # Write-back policy for the in-flight (async) local BA when a NEW keyframe
    # arrives before the tracker's drain fetched the result (stereo/RGB-D only;
    # mono is always synchronous). "block" = fetch it now, blocking on the
    # device (every result lands); "discard" = drop it — the reference's abort
    # (LocalMapper::InsertKeyFrame sets abort_bundle_adjustment_,
    # local_mapper.cpp:89-93). The BA slot is single-entry, so there is no
    # "lag": a new dispatch would overwrite the unfetched result anyway.
    ba_writeback: str = "block"
    # Policy for the in-flight triangulation + neighbor-fuse results: "block" =
    # fetch now; "lag" = stay in the pending lists and land at the next tracker
    # drain (no discard — geometry is never thrown away).
    trifuse_writeback: str = "block"


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop-closing thresholds (reference: src/core/loop_closer.cpp, loop_closer.h:81)."""

    min_kf_gap: int = 10
    consistency_threshold: int = 3
    sim3_min_inliers: int = 20
    accept_total_matches: int = 40
    essential_graph_min_feat: int = 100
    essential_graph_iters: int = 20
    # Suppress a candidate covisibility group for this many keyframes after it
    # fails Sim3/guided acceptance. Each attempt costs a mapper drain plus
    # several host-device round trips on the critical path, so a cooldown
    # saves host time — but it can DELAY the true closure and cost accuracy
    # (its effect on the H100 is not measured). Default 0 = the reference's
    # always-retry behavior (accuracy first); raise only where loop latency
    # is cheaper than host time.
    sim3_fail_cooldown: int = 0
    global_ba_iters: int = 10
    run_global_ba: bool = True            # loop_closer.cpp:685-690 spawns GBA


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Fixed-capacity arena sizes — the device-array replacement for the reference's
    dynamically grown pointer graph (SURVEY.md §7). All device arrays are allocated at
    these capacities; liveness is tracked with masks."""

    max_keyframes: int = 2048
    max_map_points: int = 262144
    max_features: int = 2048          # per-frame feature slots (>= OrbConfig.num_features)
    max_obs_per_point: int = 32       # capped observation fan-in used in BA
    local_window_kfs: int = 128       # local-map KF cap for tracking association
    local_window_points: int = 16384  # local-map point cap for tracking association
    ba_cams: int = 32                 # local-BA camera slots (window + fixed boundary)
    ba_points: int = 4096             # local-BA landmark slots
    ba_obs: int = 16384               # local-BA observation slots
    ba_obs_per_point: int = 8         # capped per-point fan-in in the Schur pair tensor


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    capacity: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)
    sensor: str = "stereo"  # "stereo" | "rgbd" | "monocular" (util/sensor_type.h:4-8)
    vocabulary_path: Optional[str] = None
    use_viewer: bool = False

    @property
    def depth_threshold(self) -> float:
        """Close/far stereo point split: bf * factor / fx (tracker.cpp:91-94)."""
        return self.camera.bf * self.tracker.depth_threshold_factor / self.camera.fx

    @property
    def min_frames_between_kfs(self) -> int:
        return 0  # tracker.cpp:58

    @property
    def max_frames_between_kfs(self) -> int:
        return int(self.camera.fps)  # tracker.cpp:60

    @staticmethod
    def from_json(path: str, sensor: str = "stereo") -> "SlamConfig":
        """Load the reference JSON schema (slam_system.cpp:14-17, tracker.cpp:29-99)."""
        with open(path) as f:
            raw = json.load(f)
        cam_raw = raw.get("camera", {})
        cam = CameraConfig(
            **{k: v for k, v in cam_raw.items() if k in {f.name for f in dataclasses.fields(CameraConfig)}}
        )
        orb_raw = raw.get("orb_parameters", {})
        orb = OrbConfig(
            num_features=orb_raw.get("num_features", 2000),
            scale_factor=orb_raw.get("scale_factor", 1.2),
            num_levels=orb_raw.get("num_levels", 8),
            ini_thresh_fast=orb_raw.get("ini_thresh_FAST", 20),
            min_thresh_fast=orb_raw.get("min_thresh_FAST", 7),
        )
        tuning = raw.get("tuning_params", {})
        tracker = TrackerConfig(depth_threshold_factor=float(tuning.get("depth_threshold", 35.0)))
        return SlamConfig(
            camera=cam,
            orb=orb,
            tracker=tracker,
            sensor=sensor,
            vocabulary_path=raw.get("orb_vocabulary"),
            # the reference's `use_ros` gates its visualization thread
            # (slam_system.cpp:69-73) — here it gates the viz.MapPublisher
            use_viewer=bool(raw.get("use_ros", raw.get("use_viewer", False))),
        )
