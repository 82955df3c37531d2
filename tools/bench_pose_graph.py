#!/usr/bin/env python
"""Sim3 pose-graph scaling bench: GN iterations/s vs mesh width.

Reference counterpart: Optimizer::OptimizeEssentialGraph
(src/optimizer/optimizer.cpp:718-960) — g2o LM over spanning-tree/covisibility/
loop edges, single-threaded. Here the edge-sharded SPMD program
(parallel/dist_pose_graph.py) is swept over a device mesh; the per-CG-iteration
collective is one psum of a (V, 7) array.

Problem: a drifted circle trajectory at city scale — V vertices, odometry
edges k->k+1, covisibility edges k->k+2 and k->k+3 (the >=100-shared-points
edges of the reference), and 4 long-range loop edges; exact GT relatives.

Usage:
  python tools/bench_pose_graph.py --vertices 4096 --devices 8 --cpu --sweep
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_problem(V: int, seed: int = 0, drift_rot: float = 0.005,
                  drift_trans: float = 0.05, drift_scale: float = 0.005):
    import jax.numpy as jnp

    from slam_framework_tpu.geometry import se3
    from slam_framework_tpu.optim import pose_graph

    rng = np.random.default_rng(seed)
    # ground-truth circle
    th = np.linspace(0, 2 * np.pi, V, endpoint=False)
    R_y = np.stack([
        np.stack([np.cos(th), np.zeros_like(th), np.sin(th)], -1),
        np.stack([np.zeros_like(th), np.ones_like(th), np.zeros_like(th)], -1),
        np.stack([-np.sin(th), np.zeros_like(th), np.cos(th)], -1),
    ], -2)
    centers = np.stack([100 * np.cos(th), np.zeros_like(th), 100 * np.sin(th)], -1)
    gt = np.tile(np.eye(4, dtype=np.float64), (V, 1, 1))
    gt[:, :3, :3] = R_y
    gt[:, :3, 3] = -np.einsum("nij,nj->ni", R_y, centers)

    # drifted estimates (accumulated noisy odometry), vectorized via cumulative compose
    est = np.empty_like(gt)
    est[0] = gt[0]
    xi = np.concatenate([
        rng.normal(0, drift_rot, (V, 3)), rng.normal(0, drift_trans, (V, 3))
    ], -1).astype(np.float32)
    noise = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    for k in range(1, V):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        est[k] = noise[k] @ rel @ est[k - 1]
    sgn = np.exp(rng.normal(0, drift_scale, V)).astype(np.float32)
    sgn[0] = 1.0

    # edges: odometry + covisibility (+2, +3) + 4 loop edges
    ei, ej = [], []
    for d in (1, 2, 3):
        ei.append(np.arange(V - d))
        ej.append(np.arange(d, V))
    for l in range(4):
        a = (l * V) // 8
        ei.append([a])
        ej.append([(a + V // 2) % V])
    e_i = np.concatenate(ei).astype(np.int32)
    e_j = np.concatenate(ej).astype(np.int32)
    E = len(e_i)
    rel = gt[e_j] @ np.linalg.inv(gt[e_i])
    prob = pose_graph.PoseGraphProblem(
        v_R=jnp.asarray(est[:, :3, :3].astype(np.float32)),
        v_t=jnp.asarray(est[:, :3, 3].astype(np.float32)),
        v_s=jnp.asarray(sgn),
        v_fixed=jnp.zeros(V, bool).at[0].set(True),
        v_mask=jnp.ones(V, bool),
        e_i=jnp.asarray(e_i),
        e_j=jnp.asarray(e_j),
        e_R=jnp.asarray(rel[:, :3, :3].astype(np.float32)),
        e_t=jnp.asarray(rel[:, :3, 3].astype(np.float32)),
        e_s=jnp.ones(E, jnp.float32),
        e_mask=jnp.ones(E, bool),
        e_weight=jnp.ones(E, jnp.float32),
    )
    return prob, gt, E


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=4096)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cg-iters", type=int, default=60)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    if args.cpu and args.devices > 1:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from jax.sharding import Mesh

    from slam_framework_tpu.optim import pose_graph
    from slam_framework_tpu.parallel import dist_pose_graph

    prob, gt, E = build_problem(args.vertices)

    def bench_at(n_devices: int) -> dict:
        if n_devices > 1:
            devs = jax.devices()[:n_devices]
            mesh = Mesh(np.array(devs), ("pg",))
            sharded = dist_pose_graph.shard_problem(prob, n_devices)

            def run():
                return dist_pose_graph.optimize_sharded(
                    sharded, mesh, iters=args.iters, cg_iters=args.cg_iters)
        else:
            def run():
                return pose_graph.optimize(
                    prob, iters=args.iters, cg_iters=args.cg_iters)

        res = run()
        jax.block_until_ready(res.v_t)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            res = run()
            jax.block_until_ready(res.v_t)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        # quality: camera-center error vs GT after gauge alignment at vertex 0
        R, t, s = jax.device_get([res.v_R, res.v_t, res.v_s])
        centers = -np.einsum("nji,nj->ni", R, t / s[:, None])
        gt_centers = -np.einsum("nji,nj->ni", gt[:, :3, :3], gt[:, :3, 3])
        err = np.linalg.norm(centers - gt_centers, axis=1)
        out = {
            "metric": "pose_graph_gn_iters_per_sec",
            "value": round(args.iters / dt, 2),
            "unit": "iter/s",
            "config": {"vertices": args.vertices, "edges": E,
                       "devices": n_devices, "gn_iters": args.iters,
                       "cg_iters": args.cg_iters},
            "wall_s": round(dt, 3),
            "vertex_err_rmse_m": round(float(np.sqrt((err ** 2).mean())), 4),
            "final_cost": float(jax.device_get(res.final_cost)),
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
            print(json.dumps({
                "metric": "pose_graph_scaling_efficiency", "devices": nd,
                "value": round(r["value"] / (base * nd), 3),
                "unit": "fraction_of_linear",
            }))
    else:
        bench_at(args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
