"""Distributed Schur-complement bundle adjustment over a device mesh.

The multi-chip configuration mandated by SURVEY.md §5.8 / BASELINE.md: the reference
has no distributed backend (its "communication fabric" is mutexes inside one
process); this design shards the BA problem's landmark/observation tensors
across a 1-D mesh and reduces the camera system across devices:

  - partition: points are block-assigned to devices TOGETHER WITH all their
    observations (a point's normal-equation block and Schur contribution are then
    device-local — no cross-device gather in the inner loop);
  - cameras are replicated: the (C, 6) CG state and (C, 6, 6) preconditioner are
    identical on every device, maintained by psum-ing the per-shard partial
    reductions (optim/global_ba.py's `axis_name` hooks — 5 psums per LM iteration
    plus 1 per CG iteration, each <= C*27 floats: the all-reduce of the *reduced*
    camera system, never the raw observations);
  - the whole optimizer runs inside one jax.shard_map: XLA sees a single SPMD
    program and schedules the collectives (NCCL on GPUs).

Scaling model: per-device work is O(M/D) per CG iteration; the psum payload is
O(C). With M >> C·D (true for 100k-landmark maps) efficiency stays near-linear.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.optim import global_ba
from slam_framework_tpu.optim.global_ba import GlobalBAProblem, GlobalBAResult, _next_pow2
from slam_framework_tpu.parallel import multihost


def point_layout(n_live: int, n_shards: int, owner=None):
    """Shard layout of live points: returns (s_of, lp_of, P_s) — shard id and
    local slot per live-point rank, and the (pow2) per-shard capacity.

    owner=None: round-robin deal (rank r -> shard r % D, slot r // D).
    owner=(n_live,) int array: OWNER-KEYED deal (map-block sharding — each point
    lands on the shard owning its covisibility segment, parallel/map_shard.py);
    slots are assigned in rank order within each shard."""
    D = n_shards
    ranks = np.arange(n_live, dtype=np.int64)
    if owner is None:
        s_of = ranks % D
        lp_of = ranks // D
        P_s = _next_pow2(max(int(np.ceil(n_live / D)) if n_live else 1, 1))
    else:
        s_of = np.asarray(owner, np.int64)
        # cumcount within each shard, in rank order
        order = np.argsort(s_of, kind="stable")
        so = s_of[order]
        new = np.r_[True, so[1:] != so[:-1]] if n_live else np.zeros(0, bool)
        idx = np.arange(n_live, dtype=np.int64)
        start = np.maximum.accumulate(np.where(new, idx, 0)) if n_live else idx
        lp_sorted = idx - start
        lp_of = np.empty(n_live, np.int64)
        lp_of[order] = lp_sorted
        counts = np.bincount(s_of, minlength=D) if n_live else np.zeros(D, np.int64)
        P_s = _next_pow2(max(int(counts.max()) if n_live else 1, 1))
    return s_of, lp_of, P_s


def shard_problem(prob: GlobalBAProblem, n_shards: int,
                  owner: Optional[np.ndarray] = None) -> GlobalBAProblem:
    """Repartition a (host-built) problem into n_shards device blocks.

    By default points are dealt round-robin to shards (balances obs counts for
    maps whose density varies along the trajectory); pass `owner` (per-LIVE-
    point shard ids, rank order) for map-block sharding keyed by covisibility
    segment. Each point carries its observations. Output arrays are the
    concatenation of equal-size shard blocks, ready to be device_put with a
    ('ba',)-sharded NamedSharding on axis 0.
    """
    pt_mask = np.asarray(prob.pt_mask)
    obs_mask = np.asarray(prob.obs_mask)
    obs_cam = np.asarray(prob.obs_cam)
    pt_slots = np.asarray(prob.pt_obs_slots)
    C = prob.cam_pose.shape[0]
    O = pt_slots.shape[1]
    D = n_shards

    # Fully vectorized repartition (the per-observation Python loop cost minutes
    # of host time at the 100k-landmark stress config). Point at live-rank r is
    # owned by shard s_of[r] at local index lp_of[r]; its observations keep
    # their slot order and are laid out point-major within the shard.
    pids = np.nonzero(pt_mask)[0]
    Np = len(pids)
    ranks = np.arange(Np, dtype=np.int64)
    s_of, lp_of, P_s = point_layout(Np, D, owner)

    slots = pt_slots[pids]                                   # (Np, O)
    valid = (slots >= 0) & obs_mask[np.maximum(slots, 0)]
    flat_sel = valid.reshape(-1)
    e_rank = np.broadcast_to(ranks[:, None], (Np, O)).reshape(-1)[flat_sel]
    e_o = slots.reshape(-1)[flat_sel]                        # source obs index
    e_s = s_of[e_rank]
    # stable sort by shard keeps (point-rank, slot) order within each shard
    order = np.argsort(e_s, kind="stable")
    e_rank, e_o, e_s = e_rank[order], e_o[order], e_s[order]
    e_lp = lp_of[e_rank]
    shard_counts = np.bincount(e_s, minlength=D)
    M_s = _next_pow2(max(int(shard_counts.max()) if len(e_s) else 1, 1))
    starts = np.concatenate([[0], np.cumsum(shard_counts)[:-1]])
    mi = (np.arange(len(e_s), dtype=np.int64)
          - np.repeat(starts, shard_counts))                 # local obs index

    s_pt_pos = np.zeros((D * P_s, 3), np.float32)
    s_pt_mask = np.zeros(D * P_s, bool)
    s_obs_cam = np.zeros(D * M_s, np.int32)
    s_obs_pt = np.zeros(D * M_s, np.int32)
    s_obs_uv = np.zeros((D * M_s, 2), np.float32)
    s_obs_ur = np.full(D * M_s, -1.0, np.float32)
    s_obs_w = np.ones(D * M_s, np.float32)
    s_obs_mask = np.zeros(D * M_s, bool)
    s_pt_slots = np.full((D * P_s, O), -1, np.int32)

    pt_pos = np.asarray(prob.pt_pos)
    obs_uv = np.asarray(prob.obs_uv)
    obs_ur = np.asarray(prob.obs_ur)
    obs_w = np.asarray(prob.obs_inv_sigma2)

    s_pt_pos[s_of * P_s + lp_of] = pt_pos[pids]
    s_pt_mask[s_of * P_s + lp_of] = True

    gm = e_s * M_s + mi
    camv = obs_cam[e_o]
    s_obs_cam[gm] = camv
    s_obs_pt[gm] = e_lp
    s_obs_uv[gm] = obs_uv[e_o]
    s_obs_ur[gm] = obs_ur[e_o]
    s_obs_w[gm] = obs_w[e_o]
    s_obs_mask[gm] = True

    # per-point slot lists: entries of one point are contiguous, so the slot
    # rank is mi minus the point's first mi
    if len(e_s):
        idx = np.arange(len(e_s), dtype=np.int64)
        new_pt = np.r_[True, e_rank[1:] != e_rank[:-1]]
        start_idx = np.maximum.accumulate(np.where(new_pt, idx, 0))
        j = mi - mi[start_idx]
        s_pt_slots[e_s * P_s + e_lp, j] = mi

        # per-(shard, cam) slot lists: cumcount within group, mi order preserved
        gkey = e_s * C + camv
        ord2 = np.argsort(gkey, kind="stable")
        gk2 = gkey[ord2]
        new2 = np.r_[True, gk2[1:] != gk2[:-1]]
        start2 = np.maximum.accumulate(
            np.where(new2, np.arange(len(gk2), dtype=np.int64), 0)
        )
        fc = np.arange(len(gk2), dtype=np.int64) - start2
        Oc_s = _next_pow2(int(fc.max()) + 1 if len(fc) else 1)
        s_cam_slots = np.full((D, C, Oc_s), -1, np.int32)
        s_cam_slots[e_s[ord2], camv[ord2], fc] = mi[ord2]
    else:
        s_cam_slots = np.full((D, C, 1), -1, np.int32)

    return GlobalBAProblem(
        cam_pose=prob.cam_pose,
        cam_fixed=prob.cam_fixed,
        cam_mask=prob.cam_mask,
        pt_pos=jnp.asarray(s_pt_pos),
        pt_mask=jnp.asarray(s_pt_mask),
        obs_cam=jnp.asarray(s_obs_cam),
        obs_pt=jnp.asarray(s_obs_pt),
        obs_uv=jnp.asarray(s_obs_uv),
        obs_ur=jnp.asarray(s_obs_ur),
        obs_inv_sigma2=jnp.asarray(s_obs_w),
        obs_mask=jnp.asarray(s_obs_mask),
        pt_obs_slots=jnp.asarray(s_pt_slots),
        cam_obs_slots=jnp.asarray(s_cam_slots),
    )


def optimize_global_sharded(
    sharded: GlobalBAProblem,
    mesh: Mesh,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    cg_iters: int = 60,
) -> GlobalBAResult:
    """Run optimize_global as one SPMD program over mesh axis 'ba'.

    `sharded` must come from shard_problem with n_shards == mesh size. Camera
    outputs are replicated; point/obs outputs are shard-concatenated like the
    inputs.
    """
    axis = mesh.axis_names[0]
    shard = P(axis)
    repl = P()
    in_specs = GlobalBAProblem(
        cam_pose=repl, cam_fixed=repl, cam_mask=repl,
        pt_pos=shard, pt_mask=shard,
        obs_cam=shard, obs_pt=shard, obs_uv=shard, obs_ur=shard,
        obs_inv_sigma2=shard, obs_mask=shard,
        pt_obs_slots=shard, cam_obs_slots=shard,
    )
    out_specs = GlobalBAResult(
        cam_pose=repl, pt_pos=shard, obs_inlier=shard, chi2=shard, total_chi2=repl,
    )

    def body(p: GlobalBAProblem) -> GlobalBAResult:
        # inside shard_map, the leading axis block of cam_obs_slots is (1, C, Oc)
        p = p._replace(cam_obs_slots=p.cam_obs_slots[0])
        return global_ba.optimize_global(
            p, K=K, iters_first=iters_first, iters_second=iters_second,
            cg_iters=cg_iters, axis_name=axis,
        )

    fn = jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs)
    )
    if multihost.is_multiprocess(mesh):
        # the mesh spans processes: inputs must be GLOBAL arrays (each process
        # contributes its addressable shards); jit auto-placement only handles
        # process-local devices
        sharded = GlobalBAProblem(*[
            multihost.place(a, NamedSharding(mesh, spec))
            for a, spec in zip(sharded, in_specs)
        ])
    return fn(sharded)


def run_global_ba_dist(arena, cfg, K: Intrinsics, mesh: Mesh,
                       iters: Tuple[int, int] = (5, 10)) -> dict:
    """Full-map distributed BA + write-back: build, shard, solve over the mesh."""
    prob, cams, pids = global_ba.build_global_problem(arena, cfg)
    n = mesh.devices.size
    sharded = shard_problem(prob, n)
    res = optimize_global_sharded(sharded, mesh, K, iters_first=iters[0], iters_second=iters[1])
    new_cam, new_pt, fixed = jax.device_get(
        [res.cam_pose, res.pt_pos, prob.cam_fixed]
    )
    cams_arr = np.asarray(cams, np.int64)
    free = ~np.asarray(fixed)[: len(cams_arr)]
    arena.kf_pose[cams_arr[free]] = np.asarray(new_cam)[: len(cams_arr)][free]
    # un-shard point positions: round-robin layout over `pids`
    P_s = new_pt.shape[0] // n
    s_of, lp_of, _ = point_layout(len(pids), n)
    arena.pt_pos[np.asarray(pids, np.int64)] = np.asarray(new_pt)[
        s_of * P_s + lp_of
    ]
    return {
        "cams": len(cams),
        "points": len(pids),
        "devices": n,
        "chi2": float(jax.device_get(res.total_chi2)),
    }
