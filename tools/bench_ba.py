#!/usr/bin/env python
"""Bundle-adjustment stress benchmark: local-BA iterations/s at map scale.

BASELINE.md config 4: "Large local-BA stress: 500-keyframe / 100k-landmark window,
distributed Schur BA on 1 host". The reference's counterpart metric is g2o's LM
iteration rate in Optimizer::LocalBundleAdjustment (optimizer.cpp:413-716, 5+10
iterations per keyframe on CPU); here the whole solve is one jitted XLA program
with Schur-complement reduction (optim/global_ba.py) optionally sharded over a
device mesh with psum reduction of the camera system (parallel/dist_ba.py).

Usage:
  python tools/bench_ba.py                   # 500 KF / 100k pts, single device
  python tools/bench_ba.py --devices 8       # sharded over 8 devices
  python tools/bench_ba.py --kfs 64 --pts 8192 --cpu   # small smoke on CPU

Prints one JSON line per run:
  {"metric": "local_ba_lm_iters_per_sec", "value": ..., "unit": "iter/s", ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_problem(n_cams: int, n_pts: int, obs_per_pt: int, seed: int = 0,
                 noise_pose: float = 0.02, noise_pt: float = 0.05):
    """Synthetic forward-motion BA problem (KITTI-like geometry), vectorized.

    Each landmark is anchored in one camera's frustum and observed by a window
    of neighboring cameras; poses/points are perturbed so LM does real work."""
    import jax.numpy as jnp

    from slam_framework_tpu.geometry.projection import Intrinsics
    from slam_framework_tpu.optim.global_ba import GlobalBAProblem, _next_pow2

    K = Intrinsics(fx=718.856, fy=718.856, cx=607.19, cy=185.22, bf=386.14)
    W, H = 1241, 376
    rng = np.random.default_rng(seed)

    # ground-truth trajectory: forward motion with gentle yaw
    poses_gt = np.tile(np.eye(4, dtype=np.float64), (n_cams, 1, 1))
    yaw = np.cumsum(rng.normal(0.0, 0.002, n_cams))
    cx_ = np.cumsum(0.8 * np.sin(yaw))
    cz_ = np.cumsum(0.8 * np.cos(yaw))
    for i in range(n_cams):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([cx_[i], 0.0, cz_[i]])
        poses_gt[i, :3, :3] = Rwc.T
        poses_gt[i, :3, 3] = -Rwc.T @ center

    # landmarks: anchored in a random camera's frustum
    anchor = rng.integers(0, n_cams, n_pts)
    z = rng.uniform(5.0, 40.0, n_pts)
    u = rng.uniform(40, W - 40, n_pts)
    v = rng.uniform(40, H - 40, n_pts)
    xc = (u - K.cx) * z / K.fx
    yc = (v - K.cy) * z / K.fy
    Ta = poses_gt[anchor]
    Rcw = Ta[:, :3, :3]
    tcw = Ta[:, :3, 3]
    pc = np.stack([xc, yc, z], 1)
    pts_gt = np.einsum("nji,nj->ni", Rcw, pc - tcw)

    # observations: window of cameras around the anchor
    half = obs_per_pt  # candidates; in-frustum filter trims to ~obs_per_pt
    offs = np.arange(-half, half + 1)
    cam_cand = np.clip(anchor[:, None] + offs[None, :], 0, n_cams - 1)  # (P, 2h+1)
    Tc = poses_gt[cam_cand]                                             # (P, 2h+1, 4, 4)
    pcs = np.einsum("poij,pj->poi", Tc[:, :, :3, :3], pts_gt) + Tc[:, :, :3, 3]
    zs = pcs[:, :, 2]
    us = K.fx * pcs[:, :, 0] / np.maximum(zs, 1e-6) + K.cx
    vs = K.fy * pcs[:, :, 1] / np.maximum(zs, 1e-6) + K.cy
    urs = us - K.bf / np.maximum(zs, 1e-6)
    ok = (zs > 1.0) & (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    # dedupe the clipped duplicates at sequence ends
    dup = np.zeros_like(ok)
    dup[:, 1:] = cam_cand[:, 1:] == cam_cand[:, :-1]
    ok &= ~dup
    # keep at most obs_per_pt per point (closest to anchor first)
    order = np.argsort(np.abs(offs))
    ok_sorted = ok[:, order]
    keep_rank = np.cumsum(ok_sorted, axis=1)
    ok_sorted &= keep_rank <= obs_per_pt
    ok = np.zeros_like(ok)
    ok[:, order] = ok_sorted

    pi, oi = np.nonzero(ok)
    m = len(pi)
    cam_i = cam_cand[pi, oi].astype(np.int32)
    uv_i = np.stack([us[pi, oi], vs[pi, oi]], 1).astype(np.float32)
    uv_i += rng.normal(0, 0.4, uv_i.shape).astype(np.float32)  # pixel noise
    ur_i = urs[pi, oi].astype(np.float32)

    # at least two observations per point (drop single-obs points)
    counts = np.bincount(pi, minlength=n_pts)
    good_pt = counts[pi] >= 2
    pi, cam_i, uv_i, ur_i = pi[good_pt], cam_i[good_pt], uv_i[good_pt], ur_i[good_pt]
    m = len(pi)

    C = _next_pow2(max(n_cams, 2))
    P = _next_pow2(max(n_pts, 2))
    M = _next_pow2(max(m, 2))
    O = _next_pow2(max(int(np.bincount(pi, minlength=n_pts).max()), 2))

    obs_cam = np.zeros(M, np.int32); obs_cam[:m] = cam_i
    obs_pt = np.zeros(M, np.int32); obs_pt[:m] = pi
    obs_uv = np.zeros((M, 2), np.float32); obs_uv[:m] = uv_i
    obs_ur = np.full(M, -1.0, np.float32); obs_ur[:m] = ur_i
    obs_w = np.ones(M, np.float32)
    obs_mask = np.zeros(M, bool); obs_mask[:m] = True

    # per-point slots (vectorized rank-within-point; pi is point-sorted)
    rank = np.arange(m) - np.concatenate([[0], np.cumsum(np.bincount(pi, minlength=n_pts))])[pi]
    pt_slots = np.full((P, O), -1, np.int32)
    pt_slots[pi, rank] = np.arange(m, dtype=np.int32)

    # per-camera slots
    order_c = np.argsort(cam_i, kind="stable")
    counts_c = np.bincount(cam_i, minlength=n_cams)
    Oc = _next_pow2(max(int(counts_c.max()), 2))
    cam_slots = np.full((C, Oc), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts_c)])
    for c in range(n_cams):
        s, e = starts[c], starts[c + 1]
        cam_slots[c, : e - s] = order_c[s:e]

    # perturbed initial state
    poses0 = poses_gt.copy()
    poses0[1:, :3, 3] += rng.normal(0, noise_pose, (n_cams - 1, 3))
    pts0 = pts_gt + rng.normal(0, noise_pt, pts_gt.shape)

    cam_pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_pose[:n_cams] = poses0.astype(np.float32)
    cam_fixed = np.zeros(C, bool); cam_fixed[0] = True; cam_fixed[n_cams:] = True
    cam_mask = np.zeros(C, bool); cam_mask[:n_cams] = True
    pt_pos = np.zeros((P, 3), np.float32); pt_pos[:n_pts] = pts0.astype(np.float32)
    pt_mask = np.zeros(P, bool); pt_mask[:n_pts] = True

    prob = GlobalBAProblem(
        cam_pose=jnp.asarray(cam_pose), cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.asarray(cam_mask), pt_pos=jnp.asarray(pt_pos),
        pt_mask=jnp.asarray(pt_mask), obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt), obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur), obs_inv_sigma2=jnp.asarray(obs_w),
        obs_mask=jnp.asarray(obs_mask), pt_obs_slots=jnp.asarray(pt_slots),
        cam_obs_slots=jnp.asarray(cam_slots),
    )
    return prob, K, poses_gt, pts_gt, m


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=500)
    ap.add_argument("--pts", type=int, default=100_000)
    ap.add_argument("--obs-per-pt", type=int, default=6)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--iters", type=int, nargs=2, default=(5, 10),
                    help="LM iterations (first, second) — the reference local-BA schedule")
    ap.add_argument("--cg-iters", type=int, default=40)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--sweep", action="store_true",
                    help="run at 1,2,4,...,--devices and report scaling efficiency")
    args = ap.parse_args()

    if args.cpu and args.devices > 1:
        # must land before the CPU client initializes (it is lazy, so setting it
        # here works even if jax was already imported)
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from slam_framework_tpu.optim import global_ba
    from slam_framework_tpu.parallel import dist_ba

    prob, K, poses_gt, pts_gt, m = make_problem(args.kfs, args.pts, args.obs_per_pt)
    n_lm = args.iters[0] + args.iters[1]

    def bench_at(n_devices: int, owner_keyed: bool = False) -> dict:
        if n_devices > 1:
            from jax.sharding import Mesh

            devs = jax.devices()[:n_devices]
            assert len(devs) == n_devices, f"only {len(devs)} devices available"
            mesh = Mesh(np.array(devs), ("ba",))
            owner = None
            if owner_keyed:
                # map-block (covisibility-segment) deal: contiguous point
                # ranges per shard, the layout the live system's sharded GBA
                # uses (parallel/map_shard.py + loop_closer)
                n_live = int(np.asarray(prob.pt_mask).sum())
                owner = (np.arange(n_live, dtype=np.int64) * n_devices) // max(n_live, 1)
            sharded = dist_ba.shard_problem(prob, n_devices, owner=owner)

            def run():
                return dist_ba.optimize_global_sharded(
                    sharded, mesh, K, iters_first=args.iters[0],
                    iters_second=args.iters[1], cg_iters=args.cg_iters,
                )
        else:
            def run():
                return global_ba.optimize_global(
                    prob, K=K, iters_first=args.iters[0], iters_second=args.iters[1],
                    cg_iters=args.cg_iters,
                )

        res = run()  # compile + warm
        jax.block_until_ready(res.cam_pose)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            res = run()
            jax.block_until_ready(res.cam_pose)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))

        # solution quality: camera translation error vs ground truth
        new_cam = np.asarray(jax.device_get(res.cam_pose))[: args.kfs].astype(np.float64)
        err = np.linalg.norm(
            np.einsum("nji,nj->ni", new_cam[:, :3, :3], -new_cam[:, :3, 3])
            - np.einsum("nji,nj->ni", poses_gt[:, :3, :3], -poses_gt[:, :3, 3]),
            axis=1,
        )
        out = {
            "metric": "local_ba_lm_iters_per_sec",
            "value": round(n_lm / dt, 2),
            "unit": "iter/s",
            "config": {
                "kfs": args.kfs, "pts": args.pts, "obs": m,
                "devices": n_devices, "lm_iters": n_lm, "cg_iters": args.cg_iters,
                "layout": "owner_keyed" if owner_keyed else "round_robin",
            },
            "wall_s": round(dt, 3),
            "obs_iters_per_sec": round(m * n_lm / dt, 0),
            "cam_err_rmse_m": round(float(np.sqrt((err ** 2).mean())), 4),
            "chi2": float(jax.device_get(res.total_chi2)),
        }
        print(json.dumps(out))
        return out

    if args.sweep:
        results = []
        d = 1
        while d <= args.devices:
            results.append(bench_at(d))
            d *= 2
        base = results[0]["value"]
        for r in results[1:]:
            nd = r["config"]["devices"]
            eff = r["value"] / (base * nd)
            print(json.dumps({
                "metric": "ba_scaling_efficiency", "devices": nd,
                "value": round(eff, 3), "unit": "fraction_of_linear",
            }))
        # the live system's owner-keyed (map-block) layout at full width:
        # same math, segment-contiguous deal (VERDICT r4 item 4)
        if args.devices > 1:
            r = bench_at(args.devices, owner_keyed=True)
            print(json.dumps({
                "metric": "ba_map_shard_vs_roundrobin", "devices": args.devices,
                "value": round(r["value"] / results[-1]["value"], 3),
                "unit": "throughput_ratio",
            }))
    else:
        bench_at(args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
