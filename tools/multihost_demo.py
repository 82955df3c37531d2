#!/usr/bin/env python
"""Multi-PROCESS (multi-host) validation of the distributed optimizers.

Spawns N real OS processes, each owning `--local-devices` virtual CPU devices,
linked by `jax.distributed` (coordination service + Gloo collectives) — the
same runtime layout as N accelerator hosts, with the network replaced by
localhost TCP. Every process runs the SAME shard_map programs from
`parallel/dist_ba.py` and `parallel/dist_pose_graph.py` over the GLOBAL mesh;
process 0 checks the distributed results against the single-device optimizers
and prints one JSON line.

Usage:
  python tools/multihost_demo.py [--processes 2] [--local-devices 2] [--port 19765]
  python tools/multihost_demo.py --worker K ...   (internal: one spawned rank)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_ba_problem(n_cams=6, n_pts=48):
    """Small synthetic BA problem, identical on every process (fixed seed)."""
    import jax.numpy as jnp

    from slam_framework_tpu.geometry.projection import Intrinsics
    from slam_framework_tpu.optim import global_ba

    K = Intrinsics(fx=100.0, fy=100.0, cx=64.0, cy=32.0, bf=50.0)
    rng = np.random.default_rng(7)
    pts = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(6, 12, n_pts)], 1
    ).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    poses[:, 0, 3] = 0.2 * np.arange(n_cams)
    obs = []
    for c in range(n_cams):
        pc = pts @ poses[c, :3, :3].T + poses[c, :3, 3]
        uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx, K.fy * pc[:, 1] / pc[:, 2] + K.cy], 1)
        for p in range(n_pts):
            obs.append((c, p, uv[p, 0], uv[p, 1], uv[p, 0] - K.bf / pc[p, 2]))
    obs = np.array(obs, np.float64)
    m = len(obs)
    M = 1 << (m - 1).bit_length()
    O = 16
    obs_cam = np.zeros(M, np.int32); obs_cam[:m] = obs[:, 0]
    obs_pt = np.zeros(M, np.int32); obs_pt[:m] = obs[:, 1]
    obs_uv = np.zeros((M, 2), np.float32); obs_uv[:m] = obs[:, 2:4]
    obs_ur = np.full(M, -1.0, np.float32); obs_ur[:m] = obs[:, 4]
    obs_mask = np.zeros(M, bool); obs_mask[:m] = True
    pt_slots = np.full((n_pts, O), -1, np.int32)
    fill = np.zeros(n_pts, np.int32)
    cam_counts = np.bincount(obs_cam[:m], minlength=n_cams)
    Oc = 1 << (int(cam_counts.max()) - 1).bit_length()
    cam_slots = np.full((n_cams, Oc), -1, np.int32)
    cfill = np.zeros(n_cams, np.int32)
    for i in range(m):
        p, c = obs_pt[i], obs_cam[i]
        if fill[p] < O:
            pt_slots[p, fill[p]] = i; fill[p] += 1
        cam_slots[c, cfill[c]] = i; cfill[c] += 1
    noisy = poses.copy()
    noisy[1:, :3, 3] += rng.normal(0, 0.02, (n_cams - 1, 3)).astype(np.float32)
    prob = global_ba.GlobalBAProblem(
        cam_pose=jnp.asarray(noisy),
        cam_fixed=jnp.asarray(np.arange(n_cams) == 0),
        cam_mask=jnp.ones(n_cams, bool),
        pt_pos=jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        pt_mask=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv), obs_ur=jnp.asarray(obs_ur),
        obs_inv_sigma2=jnp.ones(M, jnp.float32),
        obs_mask=jnp.asarray(obs_mask),
        pt_obs_slots=jnp.asarray(pt_slots),
        cam_obs_slots=jnp.asarray(cam_slots),
    )
    return prob, K


def build_pg_problem(nv=16):
    """Ring Sim3 pose graph with drifted vertices, identical on every process."""
    import jax.numpy as jnp

    from slam_framework_tpu.optim.pose_graph import PoseGraphProblem

    rng = np.random.default_rng(11)
    ang = 2.0 * np.pi * np.arange(nv) / nv
    gt = np.tile(np.eye(4, dtype=np.float32), (nv, 1, 1))
    gt[:, 0, 3] = 3.0 * np.cos(ang)
    gt[:, 2, 3] = 3.0 * np.sin(ang)
    est = gt.copy()
    est[1:, :3, 3] += rng.normal(0, 0.05, (nv - 1, 3)).astype(np.float32)
    e_i = np.arange(nv, dtype=np.int32)
    e_j = (e_i + 1) % nv
    eR = np.zeros((nv, 3, 3), np.float32)
    et = np.zeros((nv, 3), np.float32)
    for k in range(nv):
        Sji = gt[e_j[k]] @ np.linalg.inv(gt[e_i[k]])
        eR[k] = Sji[:3, :3]
        et[k] = Sji[:3, 3]
    return PoseGraphProblem(
        v_R=jnp.asarray(est[:, :3, :3]), v_t=jnp.asarray(est[:, :3, 3]),
        v_s=jnp.ones(nv, jnp.float32),
        v_fixed=jnp.asarray(np.arange(nv) == 0), v_mask=jnp.ones(nv, bool),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_R=jnp.asarray(eR), e_t=jnp.asarray(et), e_s=jnp.ones(nv, jnp.float32),
        e_mask=jnp.ones(nv, bool), e_weight=jnp.ones(nv, jnp.float32),
    )


def run_worker(args) -> int:
    from slam_framework_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.processes,
        process_id=args.worker,
        local_device_count=args.local_devices,
    )
    import jax
    from jax.sharding import Mesh

    from slam_framework_tpu.optim import global_ba, pose_graph
    from slam_framework_tpu.parallel import dist_ba, dist_pose_graph

    n_total = args.processes * args.local_devices
    devs = jax.devices()
    assert len(devs) == n_total, (len(devs), n_total)
    pid = jax.process_index()

    # --- distributed BA over the global mesh ---
    prob, K = build_ba_problem()
    mesh = Mesh(np.array(devs), ("ba",))
    sharded = dist_ba.shard_problem(prob, n_total)
    res = dist_ba.optimize_global_sharded(
        sharded, mesh, K, iters_first=2, iters_second=3, cg_iters=25
    )
    cam_mh = multihost.replicated_get(res.cam_pose)
    chi2_mh = float(multihost.replicated_get(res.total_chi2))

    # --- map-block sharded BA: owner-keyed (covisibility-segment) deal over
    # the SAME process-spanning mesh (parallel/map_shard.py, SURVEY §5.8) ---
    from slam_framework_tpu.parallel import map_shard

    n_live = int(np.asarray(prob.pt_mask).sum())
    owner = (np.arange(n_live) * n_total) // n_live  # contiguous segment blocks
    sharded_seg = dist_ba.shard_problem(prob, n_total, owner=owner)
    res_seg = dist_ba.optimize_global_sharded(
        sharded_seg, mesh, K, iters_first=2, iters_second=3, cg_iters=25
    )
    cam_seg = multihost.replicated_get(res_seg.cam_pose)

    # --- cross-process point migration (ONE all_to_all over the mesh) ---
    rngm = np.random.default_rng(5)
    R, F = 16, 4
    rows = rngm.normal(size=(n_total * R, F)).astype(np.float32)
    rmask = rngm.random(n_total * R) < 0.6
    new_owner = rngm.integers(0, n_total, n_total * R).astype(np.int32)
    # capacity covers the worst destination load (overflow is exercised by
    # tests/test_map_shard.py; here we verify exact delivery)
    assert np.bincount(new_owner[rmask], minlength=n_total).max() <= R
    out_rows, out_mask = map_shard.migrate_points(mesh, rows, rmask, new_owner)
    # every process verifies ITS OWN destination blocks (rows/mask/new_owner are
    # identical host arrays on all processes); any mismatch fails the worker
    local_blocks = [i for i, d in enumerate(mesh.devices.flat)
                    if d.process_index == pid]
    for li, d in enumerate(local_blocks):
        got = out_rows[li * R:(li + 1) * R][out_mask[li * R:(li + 1) * R]]
        want = rows[rmask & (new_owner == d)]
        assert len(got) == len(want), (d, len(got), len(want))
        o_g = np.lexsort(got.T[::-1])
        o_w = np.lexsort(want.T[::-1])
        assert np.allclose(got[o_g], want[o_w]), f"block {d} rows diverged"

    # --- distributed Sim3 pose graph over the same process set ---
    pg_prob = build_pg_problem()
    pg_mesh = Mesh(np.array(devs), ("pg",))
    pg_sharded = dist_pose_graph.shard_problem(pg_prob, n_total)
    pg_res = dist_pose_graph.optimize_sharded(pg_sharded, pg_mesh, iters=8, cg_iters=30)
    vt_mh = multihost.replicated_get(pg_res.v_t)

    if pid == 0:
        # single-device references on this process's local device
        res1 = global_ba.optimize_global(prob, K=K, iters_first=2, iters_second=3, cg_iters=25)
        cam_1 = np.asarray(jax.device_get(res1.cam_pose))
        pg1 = pose_graph.optimize(pg_prob, iters=8, cg_iters=30)
        vt_1 = np.asarray(jax.device_get(pg1.v_t))
        out = {
            "processes": args.processes,
            "local_devices": args.local_devices,
            "global_devices": n_total,
            "ba_cam_max_err_m": float(np.abs(cam_mh[:, :3, 3] - cam_1[:, :3, 3]).max()),
            "ba_chi2": chi2_mh,
            "segba_cam_max_err_m": float(np.abs(cam_seg[:, :3, 3] - cam_1[:, :3, 3]).max()),
            "migrate_ok": True,  # per-process block verification above raises on mismatch
            "pg_vt_max_err_m": float(np.abs(vt_mh - vt_1).max()),
            "ok": bool(
                np.allclose(cam_mh, cam_1, atol=1e-3)
                and np.allclose(cam_seg, cam_1, atol=1e-3)
                and np.allclose(vt_mh, vt_1, atol=1e-3)
            ),
        }
        print("MULTIHOST_RESULT " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--port", type=int, default=19765)
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        return run_worker(args)

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--processes", str(args.processes),
             "--local-devices", str(args.local_devices), "--port", str(args.port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(args.processes)
    ]
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        rc |= p.returncode
        for line in out.splitlines():
            if line.startswith("MULTIHOST_RESULT"):
                print(line[len("MULTIHOST_RESULT "):])
        if p.returncode:
            sys.stderr.write(f"--- worker {i} failed (rc {p.returncode}) ---\n{out[-2000:]}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
