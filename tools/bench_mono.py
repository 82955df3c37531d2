#!/usr/bin/env python
"""Monocular full-system bench at the stereo bench's scale (VERDICT r3 item 10).

Same 330-frame loopy synthetic world as bench.py, driven through the COMPLETE
monocular pipeline (two-view H/F initialization, mono tracking, triangulation-
only mapping, loop closing) — the reference's main_mono path
(examples/main_mono.cpp + SaveKeyFrameTrajectory, slam_system.cpp:316-349).
ATE is Sim3-aligned (monocular scale is gauge-free).

Prints ONE JSON line: {"metric": "mono_tracked_frames_per_sec", ...,
"mono_ate_m": ...}.

Usage: python tools/bench_mono.py [--frames 330]
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
    ap.add_argument("--frames", type=int, default=330)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from slam_framework_tpu.config import SlamConfig
    from slam_framework_tpu.io import synthetic, trajectory
    from slam_framework_tpu.system import SlamSystem

    cfg = SlamConfig(sensor="monocular")
    n_frames = args.frames
    world = synthetic.make_world(
        num_frames=n_frames, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )
    frames = [world.stereo_pair(f)[0] for f in range(n_frames)]

    # untimed compile warmup lap (same protocol as bench.py)
    warm = SlamSystem(cfg)
    for f in range(n_frames):
        warm.track_monocular(frames[f], world.timestamps[f])
    warm.shutdown()
    del warm

    system = SlamSystem(cfg)
    t0 = time.perf_counter()
    for f in range(n_frames):
        system.track_monocular(frames[f], world.timestamps[f])
    system.tracker.flush()
    wall = time.perf_counter() - t0
    stats = system.shutdown()

    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    est = system.frame_poses()[tracked]
    gt = world.poses[[records[i].frame_id for i in tracked]]
    ate = trajectory.ate_rmse(est, gt, align="sim3")
    fps = n_frames / wall

    print(json.dumps({
        "metric": "mono_tracked_frames_per_sec",
        "value": round(fps, 2),
        "unit": "frames/s",
        "mono_ate_m": round(float(ate), 4),
        "frames": n_frames,
        "tracked_frames": len(tracked),
        "lost_frames": sum(1 for r in records if r.lost),
        "loops_closed": stats.get("loops_closed", 0),
        "keyframes": stats.get("keyframes", 0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
