"""Global bundle adjustment: matrix-free Schur-complement CG over the whole map.

Replacement for Optimizer::GlobalBundleAdjustemnt/BundleAdjustment
(reference: src/optimizer/optimizer.cpp:18-207) and the loop-closing follow-up GBA
(src/core/loop_closer.cpp:73-172). The reference builds a g2o sparse system over all
keyframes/points; here the reduced camera system is never materialized:

  - residual/Jacobian assembly is identical to local BA (optim/local_ba.py) — one
    batched pass over the observation COO table;
  - the Schur complement S = Hcc - W Hpp^-1 W^T is applied matrix-free inside
    block-Jacobi-preconditioned CG: each matvec is two gathers over the per-point
    observation slots and one gather over the per-camera observation slots, so cost
    is O(M) per CG iteration regardless of camera count (local BA's explicit
    (C,C,6,6) Schur tensor is O(P·C^2) to build — fine at C=32, hopeless at C=1024);
  - per-camera reductions (Hcc blocks, gradients, scatter of the second Schur term)
    use a fixed-fanout slot table cam_obs_slots (C, Oc), the camera-side analogue of
    pt_obs_slots: gathers instead of scatters, which serialize on collisions.

This is also the shape the distributed configs shard: cameras/points/observations are
flat tensors, so a mesh partition of the obs table + psum of the (C,6) CG vectors is
the multi-chip path (parallel/dist_ba.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.geometry import se3
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.optim import reproj
from slam_framework_tpu.optim.local_ba import (
    _chi2_scalars,
    _inv3x3,
    _project_scalars,
)
from slam_framework_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from slam_framework_tpu.utils.precision import einsum as _einsum


class GlobalBAProblem(NamedTuple):
    """Fixed-shape global-BA problem. Duck-types BAProblem's obs fields so the
    residual assembly helpers are shared."""

    cam_pose: jnp.ndarray        # (C, 4, 4) Tcw
    cam_fixed: jnp.ndarray       # (C,) bool
    cam_mask: jnp.ndarray        # (C,) bool
    pt_pos: jnp.ndarray          # (P, 3)
    pt_mask: jnp.ndarray         # (P,) bool
    obs_cam: jnp.ndarray         # (M,) int32
    obs_pt: jnp.ndarray          # (M,) int32
    obs_uv: jnp.ndarray          # (M, 2)
    obs_ur: jnp.ndarray          # (M,)
    obs_inv_sigma2: jnp.ndarray  # (M,)
    obs_mask: jnp.ndarray        # (M,) bool
    pt_obs_slots: jnp.ndarray    # (P, O) int32 — obs ids per point (-1 pad)
    cam_obs_slots: jnp.ndarray   # (C, Oc) int32 — obs ids per camera (-1 pad)


class GlobalBAResult(NamedTuple):
    cam_pose: jnp.ndarray
    pt_pos: jnp.ndarray
    obs_inlier: jnp.ndarray
    chi2: jnp.ndarray
    total_chi2: jnp.ndarray


def _gather_sum(data: jnp.ndarray, slots: jnp.ndarray, chunk: int = 256) -> jnp.ndarray:
    """sum_{s in slots[c]} data[s] -> (C, D). Chunked over the slot axis so the
    gathered intermediate stays small; slots are -1-padded."""
    C, Oc = slots.shape
    D = data.shape[-1]
    chunk = min(chunk, Oc)
    n_chunks = -(-Oc // chunk)
    pad = n_chunks * chunk - Oc
    if pad:
        slots = jnp.concatenate([slots, jnp.full((C, pad), -1, slots.dtype)], axis=1)
    slots_r = jnp.transpose(slots.reshape(C, n_chunks, chunk), (1, 0, 2))

    def body(acc, sl):
        has = (sl >= 0)[..., None]
        vals = data[jnp.maximum(sl, 0)] * has
        return acc + jnp.sum(vals, axis=1), None

    # carry zero derived from data: under shard_map the carry must share data's
    # device-varying type or scan rejects the body (constants are unvaried)
    zero = jnp.zeros((C, D), data.dtype) + 0.0 * jnp.sum(data[:1])
    acc, _ = jax.lax.scan(body, zero, slots_r)
    return acc


def _pcg_cam(hvp, b, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the (C, 6) camera system."""

    def prec(r):
        return _einsum("cij,cj->ci", Minv, r)

    def dot(a, b_):
        return jnp.sum(a * b_)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = prec(r0)

    def body(i, st):
        x, r, z, p, rz = st
        Ap = hvp(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        return (x, r, z, z + beta * p, rz_new)

    x, *_ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, z0, dot(r0, z0)))
    return x


def _inv6x6_psd(M: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.inv(M + 1e-5 * jnp.eye(6, dtype=M.dtype))


_TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]
_TRIU3 = [(i, j) for i in range(3) for j in range(i, 3)]


@functools.partial(
    jax.jit, static_argnames=("K", "iters_first", "iters_second", "cg_iters", "axis_name")
)
def optimize_global(
    prob: GlobalBAProblem,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    cg_iters: int = 60,
    lam0: float = 1e-4,
    axis_name: str | None = None,
) -> GlobalBAResult:
    """When axis_name is set, the problem's point/observation tensors are device
    shards inside a shard_map over that mesh axis: every camera-space reduction is
    followed by a psum across devices — the distributed Schur BA of SURVEY.md §5.8. The
    camera state stays replicated; each device owns a block of points + their
    observations (built by parallel/dist_ba.py)."""

    def _allred(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    C = prob.cam_pose.shape[0]
    P = prob.pt_pos.shape[0]
    is_stereo = prob.obs_ur >= 0.0
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    free = (~prob.cam_fixed) & prob.cam_mask
    free_f = free.astype(jnp.float32)[:, None]

    slots = prob.pt_obs_slots
    has_po = slots >= 0
    safe_po = jnp.maximum(slots, 0)

    def lm_iters(cam_pose, pt_pos, active, n_iters):
        def body(carry, _):
            cam_pose, pt_pos, lam = carry
            x, y, z, r_u, r_v, r_ur, R_cols = _project_scalars(cam_pose, pt_pos, prob, K)
            chi2 = _chi2_scalars(r_u, r_v, r_ur, z, prob, is_stereo)
            w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2
            # behind-camera/grazing observations: clamped 1/z makes residuals AND
            # Jacobian rows astronomical (H ~ J^2/|r| unbounded even under Huber)
            # — zero-weight them like optim/pose_opt.py
            w_uv = w * active.astype(jnp.float32) * (z > 1e-2).astype(jnp.float32)
            w_ur = w_uv * is_stereo.astype(jnp.float32)

            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            pu, pv, pur = reproj.point_rows(x, y, z, R_cols, K)

            # --- per-obs normal-equation scalars ---
            cam_cols = [
                w_uv * (du[i] * du[j] + dv[i] * dv[j]) + w_ur * dur[i] * dur[j]
                for (i, j) in _TRIU6
            ] + [
                w_uv * (du[i] * r_u + dv[i] * r_v) + w_ur * dur[i] * r_ur
                for i in range(6)
            ]
            cam_stacked = jnp.stack(cam_cols, axis=-1)  # (M, 27)
            per_cam = _allred(_gather_sum(cam_stacked, prob.cam_obs_slots))  # (C, 27)
            Hcc = jnp.zeros((C, 6, 6))
            for n_, (i, j) in enumerate(_TRIU6):
                Hcc = Hcc.at[:, i, j].set(per_cam[:, n_])
                if i != j:
                    Hcc = Hcc.at[:, j, i].set(per_cam[:, n_])
            bc = per_cam[:, 21:27]

            pt_cols = [
                w_uv * (pu[i] * pu[j] + pv[i] * pv[j]) + w_ur * pur[i] * pur[j]
                for (i, j) in _TRIU3
            ] + [
                w_uv * (pu[i] * r_u + pv[i] * r_v) + w_ur * pur[i] * r_ur
                for i in range(3)
            ]
            pt_stacked = jnp.stack(pt_cols, axis=-1)  # (M, 9)
            per_pt = jnp.sum(pt_stacked[safe_po] * has_po[..., None], axis=1)  # (P, 9)
            Hpp = jnp.zeros((P, 3, 3))
            for n_, (i, j) in enumerate(_TRIU3):
                Hpp = Hpp.at[:, i, j].set(per_pt[:, n_])
                if i != j:
                    Hpp = Hpp.at[:, j, i].set(per_pt[:, n_])
            bp = per_pt[:, 6:9]

            # coupling W (M, 6, 3)
            W = jnp.stack(
                [
                    jnp.stack(
                        [
                            w_uv * (du[i] * pu[j] + dv[i] * pv[j]) + w_ur * dur[i] * pur[j]
                            for j in range(3)
                        ],
                        axis=-1,
                    )
                    for i in range(6)
                ],
                axis=-2,
            )

            Hpp_inv = _inv3x3(Hpp + (lam + 1e-8) * jnp.eye(3)[None])
            Hcc_d = Hcc + lam * Hcc * jnp.eye(6)[None] + 1e-8 * jnp.eye(6)[None]

            # --- matrix-free Schur matvec ---
            Hpi_of_obs = Hpp_inv[prob.obs_pt]           # (M,3,3)

            def schur_mv(v):
                v = v * free_f
                # a_p = sum_obs(p) W^T v[cam]
                u_m = _einsum("mij,mi->mj", W, v[prob.obs_cam])  # (M,3)
                a_p = jnp.sum(u_m[safe_po] * has_po[..., None], axis=1)  # (P,3)
                b_p = _einsum("pij,pj->pi", Hpp_inv, a_p)
                q_m = _einsum("mij,mj->mi", W, b_p[prob.obs_pt])  # (M,6)
                sub = _allred(_gather_sum(q_m, prob.cam_obs_slots))  # (C,6)
                out = _einsum("cij,cj->ci", Hcc_d, v) - sub
                return out * free_f + (1.0 - free_f) * v

            # rhs = bc - U Hpp^-1 bp
            q_rhs = _einsum("mij,mj->mi", W, _einsum("mij,mj->mi", Hpi_of_obs, bp[prob.obs_pt]))
            rhs = (bc - _allred(_gather_sum(q_rhs, prob.cam_obs_slots))) * free_f

            # block-Jacobi preconditioner: diag(S) ~= Hcc_d - sum_obs W Hpp^-1 W^T
            diag_sub_m = _einsum("mij,mjk,mlk->mil", W, Hpi_of_obs, W).reshape(-1, 36)
            S_diag = Hcc_d - _allred(_gather_sum(diag_sub_m, prob.cam_obs_slots)).reshape(C, 6, 6)
            Minv = _inv6x6_psd(S_diag)

            dxc = -_pcg_cam(schur_mv, rhs, Minv, cg_iters) * free_f
            # back-substitute points
            u_m = _einsum("mij,mi->mj", W, dxc[prob.obs_cam])
            sum_Wt = jnp.sum(u_m[safe_po] * has_po[..., None], axis=1)
            dxp = -_einsum("pij,pj->pi", Hpp_inv, bp + sum_Wt) * prob.pt_mask[:, None]

            new_cam = se3.compose(se3.se3_exp(dxc), cam_pose)
            new_cam = jnp.where(free[:, None, None], new_cam, cam_pose)
            new_pt = pt_pos + dxp

            _, _, z2, ru2, rv2, rur2, _ = _project_scalars(new_cam, new_pt, prob, K)
            chi2_new = _chi2_scalars(ru2, rv2, rur2, z2, prob, is_stereo)
            # in-front-only acceptance (see optim/local_ba.py): clamp artifacts
            # from behind-camera observations must not veto good steps
            cmp_ok = active & (z > 1e-2) & (z2 > 1e-2)
            err_old = _allred(jnp.sum(jnp.where(cmp_ok, jnp.minimum(chi2, 1e6), 0.0)))
            err_new = _allred(jnp.sum(jnp.where(cmp_ok, jnp.minimum(chi2_new, 1e6), 0.0)))
            improved = err_new < err_old
            cam_pose = jnp.where(improved, new_cam, cam_pose)
            pt_pos = jnp.where(improved, new_pt, pt_pos)
            lam = jnp.clip(jnp.where(improved, lam * 0.5, lam * 5.0), 1e-8, 1e5)
            return (cam_pose, pt_pos, lam), None

        (cam_pose, pt_pos, _), _ = jax.lax.scan(
            body, (cam_pose, pt_pos, jnp.float32(lam0)), None, length=n_iters
        )
        return cam_pose, pt_pos

    active0 = prob.obs_mask
    cam_pose, pt_pos = lm_iters(prob.cam_pose, prob.pt_pos, active0, iters_first)
    _, _, z, ru, rv, rur, _ = _project_scalars(cam_pose, pt_pos, prob, K)
    chi2 = _chi2_scalars(ru, rv, rur, z, prob, is_stereo)
    active1 = active0 & (chi2 <= delta2)
    cam_pose, pt_pos = lm_iters(cam_pose, pt_pos, active1, iters_second)
    _, _, z, ru, rv, rur, _ = _project_scalars(cam_pose, pt_pos, prob, K)
    chi2 = _chi2_scalars(ru, rv, rur, z, prob, is_stereo)
    inlier = prob.obs_mask & (chi2 <= delta2)
    total = _allred(jnp.sum(jnp.where(inlier, chi2, 0.0)))
    return GlobalBAResult(
        cam_pose=se3.reorthonormalize(cam_pose), pt_pos=pt_pos,
        obs_inlier=inlier, chi2=chi2, total_chi2=total
    )


# ---------------------------------------------------------------------- arena glue

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_global_problem(
    arena,
    cfg,
    fix_kfs: Optional[list] = None,
    max_obs_per_point: int = 16,
) -> Tuple[GlobalBAProblem, np.ndarray, np.ndarray]:
    """Assemble the full-map BA problem from the arena (optimizer.cpp:18-45 builds
    the same from the pointer graph). Returns (problem, cam_ids, point_ids)."""
    n_kfs = arena.num_kfs
    cams = np.nonzero(arena.kf_valid[:n_kfs])[0]
    pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
    C = _next_pow2(max(len(cams), 2))
    P = _next_pow2(max(len(pids), 2))
    O = max_obs_per_point
    inv_sf2 = 1.0 / (cfg.orb.scale_factor ** (2.0 * np.arange(cfg.orb.num_levels)))

    kf_to_cam = np.full(n_kfs, -1, np.int32)
    kf_to_cam[cams] = np.arange(len(cams), dtype=np.int32)

    obs_kf_tab = arena.pt_obs_kf[pids][:, :O]
    obs_ft_tab = arena.pt_obs_feat[pids][:, :O]
    valid_tab = obs_kf_tab >= 0
    cam_tab = np.where(valid_tab, kf_to_cam[np.maximum(obs_kf_tab, 0)], -1)
    valid_tab &= cam_tab >= 0

    flat_sel = np.nonzero(valid_tab.reshape(-1))[0]
    m = len(flat_sel)
    M = _next_pow2(max(m, 2))
    pi_flat = (flat_sel // O).astype(np.int32)
    kf_flat = obs_kf_tab.reshape(-1)[flat_sel]
    ft_flat = obs_ft_tab.reshape(-1)[flat_sel]

    obs_cam = np.zeros(M, np.int32)
    obs_pt = np.zeros(M, np.int32)
    obs_uv = np.zeros((M, 2), np.float32)
    obs_ur = np.full(M, -1.0, np.float32)
    obs_w = np.ones(M, np.float32)
    obs_mask = np.zeros(M, bool)
    obs_cam[:m] = cam_tab.reshape(-1)[flat_sel]
    obs_pt[:m] = pi_flat
    obs_uv[:m] = arena.kf_xy[kf_flat, ft_flat]
    obs_ur[:m] = arena.kf_ur[kf_flat, ft_flat]
    obs_w[:m] = inv_sf2[np.clip(arena.kf_octave[kf_flat, ft_flat], 0, cfg.orb.num_levels - 1)]
    obs_mask[:m] = True

    rank = (np.cumsum(valid_tab, axis=1) - 1).reshape(-1)[flat_sel]
    pt_slots = np.full((P, O), -1, np.int32)
    pt_slots[pi_flat, rank] = np.arange(m, dtype=np.int32)

    # camera-side slots
    order = np.argsort(obs_cam[:m], kind="stable")
    sorted_cam = obs_cam[:m][order]
    counts = np.bincount(sorted_cam, minlength=C)
    Oc = _next_pow2(max(int(counts.max()) if m else 1, 1))
    cam_slots = np.full((C, Oc), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(len(cams)):
        s, e = starts[c], starts[c + 1]
        cam_slots[c, : e - s] = order[s:e]

    cam_pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_pose[: len(cams)] = arena.kf_pose[cams]
    cam_mask = np.zeros(C, bool)
    cam_mask[: len(cams)] = True
    cam_fixed = np.ones(C, bool)
    fix_set = set(int(f) for f in (fix_kfs if fix_kfs is not None else [int(cams[0])]))
    for i, c in enumerate(cams):
        cam_fixed[i] = int(c) in fix_set

    pt_pos = np.zeros((P, 3), np.float32)
    pt_pos[: len(pids)] = arena.pt_pos[pids]
    pt_mask = np.zeros(P, bool)
    pt_mask[: len(pids)] = True

    prob = GlobalBAProblem(
        cam_pose=jnp.asarray(cam_pose),
        cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.asarray(cam_mask),
        pt_pos=jnp.asarray(pt_pos),
        pt_mask=jnp.asarray(pt_mask),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur),
        obs_inv_sigma2=jnp.asarray(obs_w),
        obs_mask=jnp.asarray(obs_mask),
        pt_obs_slots=jnp.asarray(pt_slots),
        cam_obs_slots=jnp.asarray(cam_slots),
    )
    return prob, cams, pids


def run_global_ba(arena, cfg, K: Intrinsics, iters: Tuple[int, int] = (5, 10)) -> dict:
    """Full-map BA + write-back (GlobalBundleAdjustemnt, optimizer.cpp:18-31; the
    loop-closer variant fixes keyframe 0 and runs 10 iterations)."""
    prob, cams, pids = build_global_problem(arena, cfg)
    res = optimize_global(prob, K=K, iters_first=iters[0], iters_second=iters[1])
    new_cam, new_pt, inlier = jax.device_get([res.cam_pose, res.pt_pos, res.obs_inlier])
    fixed = np.asarray(jax.device_get(prob.cam_fixed))
    for i, c in enumerate(cams):
        if not fixed[i]:
            arena.kf_pose[c] = new_cam[i]
    arena.pt_pos[pids] = new_pt[: len(pids)]
    return {
        "cams": len(cams),
        "points": len(pids),
        "obs": int(np.asarray(jax.device_get(prob.obs_mask)).sum()),
        "chi2": float(jax.device_get(res.total_chi2)),
    }
