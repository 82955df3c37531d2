#!/usr/bin/env python
"""A/B: shipped 100k-word offline vocabulary vs the 10k-word online one on
loop-candidate precision/recall (VERDICT r3 item 6 / r4 Weak #7).

Protocol: drive the full system over the 270-frame loop world (the
test_system e2e circle) with each vocabulary, and at every keyframe record
the RAW BoW loop candidates (`KeyframeDatabase.detect_loop_candidates`, i.e.
before Sim3 verification). A candidate is ground-truth POSITIVE when the
candidate keyframe's true camera center is within `gt_radius` meters of the
query's AND at least `min_gap` keyframes older (a genuine revisit, not the
recent past). Reports per-vocabulary:
  - candidate precision = GT-positive candidates / all candidates,
  - revisit recall = fraction of revisit-phase keyframes (a GT-positive
    candidate exists in the database) for which one was retrieved,
  - closed loops + final ATE (end-to-end effect).

Results are recorded in SCALING.md's vocabulary table. Runs on CPU
(JAX_PLATFORMS-independent: forces the cpu backend like tests/conftest.py).

Usage: python tools/vocab_ab.py [--frames 270] [--gt-radius 6.0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(use_shipped: bool, n_frames: int, gt_radius: float):
    import dataclasses

    import jax

    from slam_framework_tpu import system as system_mod
    from slam_framework_tpu.config import (
        CameraConfig, CapacityConfig, OrbConfig, SlamConfig,
    )
    from slam_framework_tpu.io import synthetic, trajectory
    from slam_framework_tpu.system import SlamSystem

    cfg = SlamConfig(
        camera=CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0,
                            width=640, height=240, fps=10.0, bf=400.0 * 0.54),
        orb=OrbConfig(num_features=800, num_levels=4),
        capacity=CapacityConfig(max_keyframes=128, max_map_points=65536,
                                max_features=1024, local_window_points=8192),
    )
    world = synthetic.make_world(
        num_frames=n_frames, cam=cfg.camera, seed=4, speed=1.0,
        yaw_rate=2.0 * np.pi / 200.0, corridor_half_width=7.0,
    )
    gt_centers = np.stack(
        [-p[:3, :3].T @ p[:3, 3] for p in world.poses.astype(np.float64)]
    )

    shipped = system_mod._shipped_vocabulary
    if not use_shipped:
        system_mod._shipped_vocabulary = lambda: None  # force online training
    try:
        sys_ = SlamSystem(cfg, sync_every=2)
        events = []  # (n_cands, n_gt_pos, gt_available)
        pair_dists = []  # GT distance of every retrieved candidate pair

        def record_detection(kf, candidates):
            arena = sys_.arena
            fid_q = int(arena.kf_frame_id[kf])
            cq = gt_centers[fid_q]
            pos = 0
            for c in candidates:
                fid_c = int(arena.kf_frame_id[c])
                d = float(np.linalg.norm(gt_centers[fid_c] - cq))
                pair_dists.append(d)
                if d < gt_radius and fid_q - fid_c > 50:
                    pos += 1
            # was a GT positive available in the database at all?
            avail = False
            if sys_.loop_closer is not None:
                for c in sys_.loop_closer.db.frames:
                    fid_c = int(arena.kf_frame_id[c])
                    if (arena.kf_valid[c]
                            and np.linalg.norm(gt_centers[fid_c] - cq) < gt_radius
                            and fid_q - fid_c > 50):
                        avail = True
                        break
            events.append((len(candidates), pos, avail))

        ran = {"hooked": False}

        def hook_detect():
            lc = sys_.loop_closer
            if lc is None or ran["hooked"]:
                return
            ran["hooked"] = True
            orig = lc._detect

            def patched(kf, bow):
                out = orig(kf, bow)
                record_detection(kf, out)
                return out

            lc._detect = patched

        for f in range(n_frames):
            l, r = world.stereo_pair(f)
            sys_.track_stereo(l, r, world.timestamps[f])
            hook_detect()
        stats = sys_.shutdown()
        est = sys_.frame_poses()
        gt = world.poses[[r.frame_id for r in sys_.tracker.records]]
        ate = trajectory.ate_rmse(est, gt, align="se3")
        n_cand = sum(e[0] for e in events)
        n_pos = sum(e[1] for e in events)
        n_avail = sum(1 for e in events if e[2])
        n_hit = sum(1 for e in events if e[2] and e[1] > 0)
        return {
            "vocabulary": "shipped-100k" if use_shipped else "online-10k",
            "words": sys_.vocab.num_words if sys_.vocab else 0,
            "keyframes": stats["keyframes"],
            "loops_closed": stats["loops_closed"],
            "ate_m": round(float(ate), 3),
            "candidates": n_cand,
            "gt_positive": n_pos,
            "precision": round(n_pos / n_cand, 3) if n_cand else None,
            "revisit_kfs_with_gt": n_avail,
            "revisit_recall": round(n_hit / n_avail, 3) if n_avail else None,
            "cand_gt_dist_m": {
                "p10": round(float(np.percentile(pair_dists, 10)), 1),
                "p50": round(float(np.percentile(pair_dists, 50)), 1),
                "p90": round(float(np.percentile(pair_dists, 90)), 1),
            } if pair_dists else None,
            "precision_at": {
                str(r): round(
                    sum(1 for d in pair_dists if d < r) / len(pair_dists), 3
                )
                for r in (6, 10, 15, 25)
            } if pair_dists else None,
        }
    finally:
        system_mod._shipped_vocabulary = shipped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=270)
    ap.add_argument("--gt-radius", type=float, default=6.0)
    args = ap.parse_args()

    os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")
    import jax

    jax.config.update("jax_platform_name", "cpu")

    for use_shipped in (True, False):
        print(json.dumps(run_one(use_shipped, args.frames, args.gt_radius)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
