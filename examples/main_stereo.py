#!/usr/bin/env python
"""Stereo KITTI runner — the JAX equivalent of the reference's main_stereo binary
(reference: examples/main_stereo.cpp): load config + sequence, feed every stereo
pair through the system, save the KITTI-format trajectory, report timing and (when
ground truth is present) ATE.

Usage:
    python examples/main_stereo.py CONFIG_JSON SEQUENCE_DIR [--out positions.txt]
        [--gt-root DATASET_ROOT --seq 00] [--max-frames N] [--pace]

`--pace` throttles to the sensor rate like the reference intends (its own pacing
loop is buggy, SURVEY.md Appendix B.2 — this one sleeps on real timestamps).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.io import kitti, trajectory
from slam_framework_tpu.system import SlamSystem


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("sequence_dir")
    ap.add_argument("--out", default="positions.txt")
    ap.add_argument("--gt-root", default=None, help="dataset root holding ground_truth_poses/")
    ap.add_argument("--seq", default=None, help="sequence id for ground truth, e.g. 00")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--pace", action="store_true", help="throttle to sensor timestamps")
    args = ap.parse_args(argv)

    cfg = SlamConfig.from_json(args.config, sensor="stereo")
    seq = kitti.load_sequence(args.sequence_dir)
    n = min(len(seq), args.max_frames) if args.max_frames else len(seq)
    print(f"sequence: {args.sequence_dir} ({n} frames)")

    system = SlamSystem(cfg)
    times = []
    t_wall0 = time.perf_counter()
    for f in range(n):
        left, right = seq.stereo_pair(f)
        t0 = time.perf_counter()
        system.track_stereo(left, right, float(seq.timestamps[f]))
        times.append(time.perf_counter() - t0)
        if args.pace and f + 1 < n:
            ahead = float(seq.timestamps[f + 1]) - (time.perf_counter() - t_wall0)
            if ahead > 0:
                time.sleep(ahead)
        if f % 100 == 0:
            print(f"frame {f}/{n}  state={system.tracking_state.name}")
    stats = system.shutdown()
    wall = time.perf_counter() - t_wall0

    system.save_trajectory_kitti(args.out)
    med = float(np.median(times))
    report = {
        "frames": stats["frames"], "keyframes": stats["keyframes"],
        "map_points": stats["map_points"], "loops_closed": stats["loops_closed"],
        "fps": round(stats["frames"] / wall, 2),
        "median_track_ms": round(med * 1e3, 2),
        "trajectory": args.out,
    }
    if args.gt_root and args.seq:
        gt = kitti.load_ground_truth(args.gt_root, args.seq)
        if gt is not None:
            est = system.frame_poses()
            m = min(len(est), len(gt))
            report["ate_rmse_m"] = round(
                float(trajectory.ate_rmse(est[:m], _wc_to_cw(gt[:m]), align="se3")), 4
            )
    print(json.dumps(report))
    return 0


def _wc_to_cw(poses_wc: np.ndarray) -> np.ndarray:
    return np.linalg.inv(poses_wc)


if __name__ == "__main__":
    sys.exit(run())
