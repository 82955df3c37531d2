#!/usr/bin/env python
"""Diagnose the bench-workload tracking collapse (VERDICT r2 Weak #1).

Runs the EXACT bench world through the tracker with per-frame metric capture,
printing one line per frame: inliers, matches, keyframe events, block size.
Modes:
  --frames N        number of frames (default 150)
  --sync K          sync_every (default 1 for max observability)
  --depth D         pipeline depth (default 1)
  --oracle          replace the motion-model prediction with ground truth pose
                    (isolates matching capacity from prediction error)
  --system          drive the full SlamSystem instead of the bare tracker
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--sync", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--system", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--hw", type=float, default=10.0, help="corridor half width")
    args = ap.parse_args()
    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.config import SlamConfig
    from slam_framework_tpu.io import synthetic, trajectory

    cfg = SlamConfig()
    world = synthetic.make_world(
        num_frames=args.frames, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
        corridor_half_width=args.hw,
    )

    if args.system:
        from slam_framework_tpu.system import SlamSystem

        system = SlamSystem(cfg)
        tracker = system.tracker
        tracker.sync_every = args.sync
        tracker.pipeline_depth = args.depth
        track = lambda l, r, t: system.track_stereo(l, r, t)
    else:
        from slam_framework_tpu.pipeline.tracker import StereoTracker

        tracker = StereoTracker(cfg, sync_every=args.sync, pipeline_depth=args.depth)
        track = tracker.track

    if args.oracle:
        # monkey-patch: prediction = GT pose of the frame being tracked
        _orig_track_core = tracker._track_core
        gt = jnp.asarray(world.poses)

        # note: inside the scan we don't know the frame id; oracle mode forces
        # sync_every=1 so the dispatch order gives it to us via closure
        assert args.sync == 1, "--oracle requires --sync 1"
        state = {"f": 0}

        def patched(st, fd, block):
            f = state["f"]
            st = st._replace(
                pose=gt[max(f - 1, 0)],
                velocity=gt[f] @ jnp.linalg.inv(gt[max(f - 1, 0)]),
            )
            return _orig_track_core(st, fd, block)

        tracker._track_core = patched
        tracker._jit_chunk = jax.jit(tracker._chunk)

        _orig_dispatch = tracker._dispatch

        def dispatch_and_count():
            _orig_dispatch()
            state["f"] += 1

        tracker._dispatch = dispatch_and_count

    for f in range(args.frames):
        l, r = world.stereo_pair(f)
        track(l, r, world.timestamps[f])
    tracker.flush()
    if args.system:
        system = None

    # dump per-frame metrics, with drift vs ground truth where tracked
    gt_cw = world.poses
    drift = {}
    prev = {}
    for r in tracker.records:
        if r.pose is not None and r.frame_id < len(gt_cw):
            Tcw = r.pose.astype(np.float64)
            Tgt = gt_cw[r.frame_id].astype(np.float64)
            E = Tcw @ np.linalg.inv(Tgt)
            ang = np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
            # per-frame STEP error in the previous camera frame: est relative
            # motion vs GT relative motion, split fwd(z)/lat(x)/vert(y)
            step = None
            if (r.frame_id - 1) in prev:
                Tp = prev[r.frame_id - 1]
                rel_est = Tcw @ np.linalg.inv(Tp)
                rel_gt = Tgt @ np.linalg.inv(gt_cw[r.frame_id - 1].astype(np.float64))
                # camera centers of the step, in the prev est camera frame
                c_est = -rel_est[:3, :3].T @ rel_est[:3, 3]
                c_gt = -rel_gt[:3, :3].T @ rel_gt[:3, 3]
                d = c_est - c_gt
                rang = rel_est[:3, :3] @ rel_gt[:3, :3].T
                rerr = np.degrees(np.arccos(np.clip((np.trace(rang) - 1) / 2, -1, 1)))
                step = (round(float(d[2]), 4), round(float(d[0]), 4),
                        round(float(d[1]), 4), round(float(rerr), 4))
            prev[r.frame_id] = Tcw
            drift[r.frame_id] = (round(float(ang), 2),
                                 round(float(np.linalg.norm(E[:3, 3])), 2), step)
    for e in tracker.metrics.records:
        if e.get("frame_id") in drift:
            d = drift[e["frame_id"]]
            e = dict(e, rot_err_deg=d[0], trans_err_m=d[1])
            if d[2] is not None:
                e["step_fwd_lat_vert_rot"] = d[2]
        print(json.dumps(e, default=str))

    est = tracker.trajectory_poses()
    gt_poses = world.poses[: len(est)]
    ate = trajectory.ate_rmse(est, gt_poses, align="se3")
    lost = sum(1 for r in tracker.records if r.lost)
    print(json.dumps({
        "summary": True, "frames": args.frames, "lost_frames": lost,
        "keyframes": int(tracker.arena.n_valid_kfs), "ate_m": round(float(ate), 3),
    }))


if __name__ == "__main__":
    main()
