"""DCN map-block sharding: partition the map by covisibility segment across
host slices, run global BA with boundary-only cross-slice reduction, migrate
point ownership off the per-frame path.

SURVEY.md §5.8 mandates keyframe/map-point block sharding as a first-class
distributed component (the reference's only "fabric" is in-process mutexes,
src/data/map.h:38). This module implements that design:

  1. Partition unit = covisibility block: keyframes are split into contiguous
     trajectory segments balanced by observation count (covisibility is
     temporally local except at loops), each segment owned by one host slice;
     a point lives with the slice owning the MOST of its observations.
  2. Global BA over the partition reuses optim/global_ba.optimize_global inside
     one shard_map over the 'host' mesh axis: every point's normal-equation
     block and Schur contribution are slice-local by construction (its
     observations ride with it); the only cross-slice traffic is the psum of
     the reduced camera system — O(C·27 f32) per LM iteration, sized for DCN —
     and that reduction is exactly the boundary coupling: a segment-interior
     point contributes zeros to every other slice's camera rows.
  3. Migration: after a loop closure fuses geometry across segments, ownership
     is recomputed and point rows move between slices via ONE all_to_all
     program (jax.lax.all_to_all inside shard_map), scheduled where the async
     GBA merge already runs — never on the per-frame path.

The same program runs single-process over virtual devices (tests) and
multi-process over jax.distributed (parallel/multihost.py; the multihost test
drives it across 2 OS processes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.optim import global_ba
from slam_framework_tpu.parallel import dist_ba, multihost


@dataclasses.dataclass
class MapPartition:
    """Covisibility-segment partition of the arena."""

    n_segments: int
    seg_of_kf: np.ndarray     # (num_kfs,) int32 — segment per keyframe slot (-1 invalid)
    owner_of_pt: np.ndarray   # (num_pts,) int32 — owning segment per point (-1 invalid)
    boundary_pt: np.ndarray   # (num_pts,) bool — observed from >= 2 segments

    def stats(self) -> dict:
        live = self.owner_of_pt >= 0
        per_seg = np.bincount(self.owner_of_pt[live], minlength=self.n_segments)
        return {
            "segments": self.n_segments,
            "points_per_segment": per_seg.tolist(),
            "boundary_points": int(self.boundary_pt.sum()),
            "boundary_frac": float(self.boundary_pt.sum() / max(live.sum(), 1)),
        }


def partition_arena(arena, n_segments: int) -> MapPartition:
    """Split keyframes into contiguous id segments balanced by observation load;
    assign each point to the segment holding most of its observations."""
    kfs = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
    pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
    seg_of_kf = np.full(arena.num_kfs, -1, np.int32)
    owner = np.full(arena.num_pts, -1, np.int32)
    boundary = np.zeros(arena.num_pts, bool)
    if len(kfs) == 0:
        return MapPartition(n_segments, seg_of_kf, owner, boundary)

    # load per keyframe = number of live observations anchored at it
    obs_kf = arena.pt_obs_kf[pids]                     # (Np, O)
    live_obs = obs_kf >= 0
    load = np.bincount(obs_kf[live_obs], minlength=arena.num_kfs)[kfs]
    # contiguous split at balanced cumulative load (keyframe ids are insertion-
    # ordered, so contiguous id ranges == trajectory segments)
    cum = np.cumsum(load)
    total = cum[-1] if len(cum) else 0
    cuts = np.searchsorted(cum, total * (np.arange(1, n_segments) / n_segments))
    seg_ids = np.zeros(len(kfs), np.int32)
    for c in cuts:
        seg_ids[c:] += 1
    seg_ids = np.minimum(seg_ids, n_segments - 1)
    seg_of_kf[kfs] = seg_ids

    # point owner = argmax over per-segment observation counts
    seg_of_obs = np.where(live_obs, seg_of_kf[np.maximum(obs_kf, 0)], -1)  # (Np, O)
    counts = np.zeros((len(pids), n_segments), np.int32)
    rows = np.broadcast_to(np.arange(len(pids))[:, None], seg_of_obs.shape)
    sel = seg_of_obs >= 0
    np.add.at(counts, (rows[sel], seg_of_obs[sel]), 1)
    owner[pids] = np.argmax(counts, axis=1).astype(np.int32)
    boundary[pids] = (counts > 0).sum(axis=1) >= 2
    return MapPartition(n_segments, seg_of_kf, owner, boundary)


def run_global_ba_map_sharded(
    arena, cfg, K: Intrinsics, mesh: Mesh,
    partition: Optional[MapPartition] = None,
    iters: Tuple[int, int] = (5, 10),
) -> dict:
    """Full-map BA with the SEGMENT-OWNED point layout: build, shard by owner,
    solve as one SPMD program over the mesh, write back. Matches the single-
    device optimizer's solution (sharding changes layout, not math)."""
    n = mesh.devices.size
    if partition is None:
        partition = partition_arena(arena, n)
    prob, cams, pids = global_ba.build_global_problem(arena, cfg)
    owner = partition.owner_of_pt[np.asarray(pids, np.int64)]
    # segments map 1:1 onto mesh slots when n == n_segments; otherwise fold
    owner = owner % n
    sharded = dist_ba.shard_problem(prob, n, owner=owner)
    res = dist_ba.optimize_global_sharded(
        sharded, mesh, K, iters_first=iters[0], iters_second=iters[1]
    )
    new_cam, new_pt, fixed = jax.device_get([res.cam_pose, res.pt_pos, prob.cam_fixed])
    cams_arr = np.asarray(cams, np.int64)
    free = ~np.asarray(fixed)[: len(cams_arr)]
    arena.kf_pose[cams_arr[free]] = np.asarray(new_cam)[: len(cams_arr)][free]
    P_s = new_pt.shape[0] // n
    s_of, lp_of, _ = dist_ba.point_layout(len(pids), n, owner)
    arena.pt_pos[np.asarray(pids, np.int64)] = np.asarray(new_pt)[s_of * P_s + lp_of]
    out = {
        "cams": len(cams), "points": len(pids), "devices": n,
        "chi2": float(jax.device_get(res.total_chi2)),
    }
    out.update(partition.stats())
    return out


# --------------------------------------------------------------------- migration


def migrate_points(
    mesh: Mesh,
    rows: np.ndarray,        # (D * R, F) f32 — per-slice point rows (R slots each)
    row_mask: np.ndarray,    # (D * R,) bool — live rows
    new_owner: np.ndarray,   # (D * R,) int32 — destination slice per row
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-deal point rows to their new owning slices with ONE all_to_all.

    Returns (rows', mask') in the same (D * R, F) layout, where each slice's
    block now holds exactly the rows whose new_owner is that slice (order:
    source-slice-major). Capacity R must cover the worst destination load —
    overflow rows are dropped with their mask cleared (callers size R with
    headroom; the bench partition keeps ownership churn at loop seams only).

    This is the off-critical-path ownership transfer of step 4 above: a
    point row is ~100 B; a loop-closure migration of 10k points moves ~1 MB
    between devices in one collective.
    """
    D = mesh.devices.size
    R = rows.shape[0] // D
    F = rows.shape[1]
    axis = mesh.axis_names[0]

    def body(rows_blk, mask_blk, owner_blk):
        # rows_blk: (R, F) this slice's rows; build (D, R, F) send buckets.
        # Dead/overflow rows are routed to OUT-OF-BOUNDS scatter indices, which
        # XLA drops — no conflicting writes against live rows.
        dest = jnp.where(mask_blk, owner_blk, D)  # dead rows -> OOB bucket
        # local slot within each destination bucket = cumcount of same-dest rows
        one = (dest[None, :] == jnp.arange(D)[:, None]).astype(jnp.int32)  # (D, R)
        slot = jnp.cumsum(one, axis=1) - 1                                  # (D, R)
        s_idx = slot[jnp.clip(dest, 0, D - 1), jnp.arange(R)]
        s_idx = jnp.where(mask_blk, s_idx, R)     # dead rows -> OOB slot
        slot_in_bucket = jnp.zeros((D, R, F), rows_blk.dtype).at[
            dest, s_idx
        ].set(rows_blk)
        bucket_mask = jnp.zeros((D, R), bool).at[dest, s_idx].set(
            jnp.ones(R, bool)
        )
        # exchange buckets: after all_to_all, axis 0 indexes SOURCE slice
        got_rows = jax.lax.all_to_all(
            slot_in_bucket, axis, split_axis=0, concat_axis=0
        )                                                                   # (D, R, F)
        got_mask = jax.lax.all_to_all(
            bucket_mask, axis, split_axis=0, concat_axis=0
        )                                                                   # (D, R)
        # compact source-major into this slice's R slots
        flat_rows = got_rows.reshape(D * R, F)
        flat_mask = got_mask.reshape(D * R)
        pos = jnp.cumsum(flat_mask.astype(jnp.int32)) - 1
        idx = jnp.where(flat_mask, pos, D * R)    # dead -> OOB, dropped
        out_rows = jnp.zeros((R, F), rows_blk.dtype).at[idx].set(flat_rows)
        out_mask = jnp.zeros(R, bool).at[idx].set(flat_mask)
        return out_rows, out_mask

    spec = P(axis)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec),
    ))
    put = multihost.place if multihost.is_multiprocess(mesh) else jax.device_put
    ns = NamedSharding(mesh, spec)
    r, m = fn(
        put(np.asarray(rows, np.float32), ns),
        put(np.asarray(row_mask, bool), ns),
        put(np.asarray(new_owner, np.int32), ns),
    )
    if multihost.is_multiprocess(mesh):
        return multihost.shard_get(r, mesh), multihost.shard_get(m, mesh)
    return np.asarray(jax.device_get(r)), np.asarray(jax.device_get(m))
