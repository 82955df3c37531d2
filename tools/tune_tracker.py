#!/usr/bin/env python
"""Tracker throughput/accuracy sweep on the bench workload.

Measures frames/s AND trajectory ATE across pipeline knobs so throughput gains
that cost accuracy are visible immediately:

  - sync_every: frames per device dispatch (dispatch amortization vs keyframe lag)
  - local_window_points: local-map block capacity (association cost vs recall)
  - pose-opt schedule is fixed in track_ops (change there to sweep it)

Usage:
  python tools/tune_tracker.py                      # default grid on the default backend
  python tools/tune_tracker.py --cpu --frames 40    # small CPU smoke
  python tools/tune_tracker.py --sync 4 8 --window 4096 8192

Prints one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_config(cfg, world, pairs, sync_every, warmup):
    import jax

    from slam_framework_tpu.io import trajectory
    from slam_framework_tpu.pipeline.tracker import StereoTracker

    tracker = StereoTracker(cfg, sync_every=sync_every)
    frame_times = []
    for f, (l, r) in enumerate(pairs):
        t0 = time.perf_counter()
        tracker.track(l, r, world.timestamps[f])
        if f >= warmup:
            frame_times.append(time.perf_counter() - t0)
    tracker.flush()
    ft = np.sort(np.asarray(frame_times))
    k = max(1, len(ft) // 10)
    fps = 1.0 / float(ft[k:-k].mean())
    est = tracker.trajectory_poses()
    n = len(est)
    ate = trajectory.ate_rmse(est, world.poses[:n], align="se3")
    lost = sum(1 for r in tracker.records if r.lost)
    return {
        "fps": round(fps, 2),
        "ate_m": round(float(ate), 4),
        "lost_frames": lost,
        "keyframes": int(tracker.arena.n_valid_kfs),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--sync", type=int, nargs="+", default=[4, 6, 8])
    ap.add_argument("--window", type=int, nargs="+", default=[8192])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from slam_framework_tpu.config import CapacityConfig, SlamConfig
    from slam_framework_tpu.io import synthetic

    base = SlamConfig()
    world = synthetic.make_world(
        num_frames=args.frames, cam=base.camera, seed=3, speed=1.0, num_landmarks=9000
    )
    pairs = [world.stereo_pair(f) for f in range(args.frames)]

    for window in args.window:
        cfg = dataclasses.replace(
            base, capacity=dataclasses.replace(base.capacity, local_window_points=window)
        )
        for sync in args.sync:
            res = run_config(cfg, world, pairs, sync, args.warmup)
            print(json.dumps({"sync_every": sync, "window_points": window, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
