#!/usr/bin/env python
"""Per-stage profile of the stereo tracking pipeline + optional xprof trace.

Runs the bench workload (KITTI-geometry synthetic stereo) and prints:
  - frames/s (same protocol as bench.py),
  - the StageTimers breakdown (dispatch / drain / keyframe / mapper stages),
  - per-chunk device time vs host time split,
and optionally captures a jax.profiler trace for xprof/perfetto (--trace DIR):
the pipeline stages appear as named spans via utils/observability.trace_span.

Usage:
  python tools/profile_pipeline.py [--frames 80] [--trace /tmp/slamtrace] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--trace", default=None, help="xprof trace output dir")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sync-every", type=int, default=4)
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from slam_framework_tpu.config import SlamConfig
    from slam_framework_tpu.io import synthetic
    from slam_framework_tpu.pipeline.tracker import StereoTracker

    cfg = SlamConfig()
    world = synthetic.make_world(
        num_frames=args.frames, cam=cfg.camera, seed=3, speed=1.0, num_landmarks=9000
    )
    pairs = [world.stereo_pair(f) for f in range(args.frames)]

    tracker = StereoTracker(cfg, sync_every=args.sync_every)
    # warm up compiles before tracing/timing
    for f in range(args.warmup):
        tracker.track(*pairs[f], world.timestamps[f])
    tracker.timers.total_s.clear()
    tracker.timers.count.clear()

    if args.trace:
        jax.profiler.start_trace(args.trace)

    frame_times = []
    t_run0 = time.perf_counter()
    for f in range(args.warmup, args.frames):
        t0 = time.perf_counter()
        tracker.track(*pairs[f], world.timestamps[f])
        frame_times.append(time.perf_counter() - t0)
    run_wall = time.perf_counter() - t_run0

    if args.trace:
        jax.profiler.stop_trace()
        print(f"trace written to {args.trace}", file=sys.stderr)

    ft = np.sort(np.asarray(frame_times))
    k = max(1, len(ft) // 10)
    fps = 1.0 / float(ft[k:-k].mean())
    stages = tracker.timers.summary()
    accounted = sum(v["total_ms"] for s, v in stages.items() if "/" not in s)
    print(json.dumps({
        "fps": round(fps, 2),
        "wall_s": round(run_wall, 3),
        "frames": args.frames - args.warmup,
        "stage_ms_per_frame": {
            s: round(v["total_ms"] / (args.frames - args.warmup), 3)
            for s, v in stages.items()
        },
        "unaccounted_ms_per_frame": round(
            (run_wall * 1e3 - accounted) / (args.frames - args.warmup), 3
        ),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
