#!/usr/bin/env python
"""Benchmark: full-system stereo SLAM throughput + accuracy on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

Workload: a 330-frame loopy synthetic sequence at KITTI stereo geometry
(1241x376, 2000 ORB features, 8 levels) driven through the COMPLETE SlamSystem —
tracking, local mapping (culling/triangulation/fusion/local BA), place
recognition, loop closing with essential-graph optimization and async global BA.
The trajectory closes a full circle so the loop closer must fire; the reported
`ate_m` is the SE3-aligned RMSE of the final per-frame trajectory against ground
truth, so a throughput gain that costs accuracy shows up here.

Baseline: the reference (ThorsteinnJonsson/SLAM_framework) publishes no numbers
(BASELINE.md); its design target is real-time at the KITTI sensor rate, 10 fps
on CPU (config/kitti_config_stereo.json fps=10, examples/main_stereo.cpp pacing
loop). vs_baseline is therefore frames/s / 10; BASELINE.json's target is >= 5x.

Input protocol: frames are pre-staged into device memory before the timed loop
and fed through `track_stereo_device` — the production ingestion path (a
deployment prefetches sensor frames to the device ahead of compute). This
matches the reference's measurement boundary: its per-frame clock wraps
TrackStereo only, with cv::imread outside the timed region
(examples/main_stereo.cpp:102-130).

Device: the run needs a GPU. It prints JAX's platform, device kind and device
count and the card's name and power limit first, and exits non-zero when JAX's
first device is not a GPU.
"""

import json
import os
import sys
import time

import numpy as np

# A/B hook: chunk length of the staged pipeline (frames per tracker dispatch).
SYNC = int(os.environ.get("SLAM_BENCH_SYNC", "8"))


def make_bench_world(cam, n_frames: int = 330):
    """The bench's loopy world: a full circle in ~300 frames, so the camera
    revisits its start and the loop closer must fire."""
    from slam_framework_tpu.io import synthetic

    return synthetic.make_world(
        num_frames=n_frames, cam=cam, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )


def main() -> None:
    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.config import SlamConfig
    from slam_framework_tpu.io import trajectory
    from slam_framework_tpu.system import SlamSystem
    from slam_framework_tpu.utils import device

    info = device.require_gpu()
    print(f"device: {info['platform']} {info['kind']} x{info['count']}", file=sys.stderr)
    print(f"card: {device.card_line()}", file=sys.stderr)

    cfg = SlamConfig()  # KITTI stereo geometry: 1241x376, 2000 feats, 8 levels
    n_frames = 330
    world = make_bench_world(cfg.camera, n_frames)
    # Pre-render on host and pre-stage ALL frames into device memory (330
    # pairs ~ 300 MB) before the first device fetch, so the timed loop
    # measures the SLAM system, not the host->device copy.
    pairs = []
    for f in range(n_frames):
        l, r = world.stereo_pair(f)
        pairs.append(jax.device_put(jnp.stack([jnp.asarray(l), jnp.asarray(r)])))
    jax.block_until_ready(pairs)

    # Phase 1 (untimed compile warmup): drive a throwaway system over the FULL
    # sequence so every program compiles — both chunk shapes, the keyframe path
    # (store/remap/triangulate/fuse/local BA), the depth-2 pipeline transition,
    # BoW, and the complete loop-closure stack (Sim3 RANSAC, SearchBySim3,
    # guided fusion, essential-graph optimization, async global BA) at the
    # exact pow2-padded shapes the measured lap will hit. A deployment
    # AOT-compiles once per camera geometry before serving; JAX's persistent
    # compilation cache carries the kernels across processes, so repeat runs
    # pay Python tracing + cache loads only.
    warm = SlamSystem(cfg, sync_every=SYNC)
    for f in range(n_frames):
        warm.track_stereo_device(pairs[f], world.timestamps[f])
    warm.shutdown()
    del warm

    # Phase 2 (timed): fresh system over the FULL sequence. Wall clock covers
    # every frame including the tail flush and the one-time loop-closure
    # program compiles — no warmup exclusion, no per-frame statistics. (An
    # earlier protocol used a 10%-trimmed mean of per-frame times; with
    # chunked execution most cost lands on the 1-in-sync_every chunk-boundary
    # frames, which the trim discarded — wall clock is the only honest
    # accounting.)
    system = SlamSystem(cfg, sync_every=SYNC)
    t_start = time.perf_counter()
    for f, pair in enumerate(pairs):
        system.track_stereo_device(pair, world.timestamps[f])
    system.tracker.flush()
    wall = time.perf_counter() - t_start
    stats = system.shutdown()  # final merges (untimed, like the reference's
    # SaveTrajectory after the loop)

    est = system.frame_poses()
    gt = world.poses[: len(est)]
    ate = trajectory.ate_rmse(est, gt, align="se3")

    fps = n_frames / wall

    print(
        json.dumps(
            {
                "metric": "stereo_tracked_frames_per_sec",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 10.0, 2),
                "ate_m": round(float(ate), 4),
                "frames": n_frames,
                "lost_frames": sum(1 for r in system.tracker.records if r.lost),
                "loops_closed": stats.get("loops_closed", 0),
                "keyframes": stats.get("keyframes", 0),
                "device": info,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
