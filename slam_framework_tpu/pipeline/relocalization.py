"""Relocalization: BoW candidates → batched PnP RANSAC → motion-only BA.

Replacement for Tracker::Relocalization (reference:
src/core/tracker.cpp:826-991): on tracking loss, query the keyframe database for
BoW candidates (keyframe_database.cpp:179-299), match the lost frame's descriptors
against each candidate's map points (SearchByBoW, orb_matcher.cpp:133-262), solve
EPnP-RANSAC (pnp_solver.cpp — here batched-hypothesis DLT resection), refine with
motion-only BA, and accept at >= 50 inliers (tracker.cpp:977).

The reference round-robins 5 RANSAC iterations per candidate across a while-loop;
the batched formulation runs all hypotheses of a candidate at once, so candidates are
simply tried best-score-first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.map.arena import MapArena
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.optim import pose_opt
from slam_framework_tpu.solvers import pnp
from slam_framework_tpu.utils import progcache
from slam_framework_tpu.utils.precision import einsum as _einsum


def _guided_match(
    R, t, pts_w, pt_desc, pt_mask, f_xy, f_desc, f_valid,
    *, K: Intrinsics, width: int, height: int, window: float, max_dist: int,
):
    """SearchByProjection against a candidate KF's local points with a pose prior
    (reference: orb_matcher.cpp:1455-1582, called from tracker.cpp:944 with
    window=10, ORBdist=100): project world points through Tcw, gate frame features
    by a pixel window, Hamming-match, dedup per frame feature."""
    pc = _einsum("ni,ji->nj", pts_w, R) + t[None, :]
    z = jnp.where(pc[:, 2] > 1e-6, pc[:, 2], 1e-6)
    uv = jnp.stack([K.fx * pc[:, 0] / z + K.cx, K.fy * pc[:, 1] / z + K.cy], axis=-1)
    ok = pt_mask & (pc[:, 2] > 0.05)
    ok &= (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    gate = matcher.window_gate(uv, f_xy, jnp.full(uv.shape[0], window)) & (
        ok[:, None] & f_valid[None, :]
    )
    ham = hamming.hamming_matrix(pt_desc, f_desc)
    res = matcher.gated_match(ham, gate, max_dist=max_dist)
    res = matcher.resolve_duplicate_columns(res, f_xy.shape[0])
    return res.idx, res.valid


class RelocResult(NamedTuple):
    pose: np.ndarray        # (4,4) Tcw
    kf: int                 # matched keyframe
    feat_idx: np.ndarray    # frame feature indices with point associations
    point_ids: np.ndarray   # matching arena point ids
    n_inliers: int


class Relocalizer:
    MIN_BOW_MATCHES = 15    # tracker.cpp:905

    @property
    def MIN_ACCEPT(self) -> int:
        """Reloc accept bar: the reference's 50 inliers (tracker.cpp:977) is
        calibrated to its 2000-feature frames; at lower feature budgets the
        same pose quality yields proportionally fewer inliers (measured: a
        CORRECT post-blackout pose converges to ~39 inliers at 800 features
        while wrong-candidate poses stay <= 10), so the bar scales with the
        budget, floored well above the wrong-pose consensus."""
        return max(25, round(50 * self.cfg.orb.num_features / 2000))

    def __init__(self, cfg: SlamConfig, arena: MapArena, K: Intrinsics, place_rec):
        """place_rec: the LoopCloser (owns vocabulary, database, match kernels)."""
        self.cfg = cfg
        self.arena = arena
        self.K = K
        self.place_rec = place_rec
        # diagnostic prints for reloc tuning (set directly from tools/tests;
        # policy knobs live in SlamConfig, debug toggles on the instance)
        self._debug = False
        self._key = jax.random.PRNGKey(11)
        fp = ("Relocalizer", progcache.config_fingerprint(cfg))
        _sj = progcache.shared_jit
        self._jit_pnp = _sj(fp + ("pnp",), lambda: jax.jit(
            functools.partial(pnp.solve_pnp_ransac, K=K, min_inliers=10)
        ))
        # min_inliers=6: the RANSAC result only SEEDS the pose — the motion-only
        # BA + the >= 50-inlier accept bar (tracker.cpp:977) do the real
        # arbitration, so a strict consensus gate here only costs recoveries
        # (measured: 7-inlier Horn seeds relocalize correctly after a blackout)
        self._jit_pnp3d = _sj(fp + ("pnp3d",), lambda: jax.jit(
            functools.partial(pnp.solve_pnp3d_ransac, K=K, min_inliers=6)
        ))
        self._jit_pose_opt = _sj(fp + ("pose_opt",), lambda: jax.jit(
            functools.partial(pose_opt.optimize_pose, K=K)
        ))
        self._jit_guided = _sj(fp + ("guided",), lambda: jax.jit(
            functools.partial(
                _guided_match, K=K, width=cfg.camera.width, height=cfg.camera.height,
                window=10.0, max_dist=100,
            )
        ))
        self._jit_bow_match = _sj(fp + ("bow_match",),
                                  lambda: jax.jit(self._bow_match))
        self._inv_sf2 = 1.0 / (
            cfg.orb.scale_factor ** (2.0 * np.arange(cfg.orb.num_levels))
        )

    @staticmethod
    def _bow_match(desc_f, valid_f, desc_k, mask_k):
        """SearchByBoW(KF, Frame) for relocalization (orb_matcher.cpp:133-262).
        The reference runs ratio 0.75; RANSAC-PnP + the guided-projection retry do
        the outlier rejection here, so a softer 0.9 ratio keeps more hypotheses —
        strictness that matters for loop closing (false-positive loops corrupt the
        map) only costs relocalization attempts."""
        ham = hamming.hamming_matrix(desc_f, desc_k)
        gate = valid_f[:, None] & mask_k[None, :]
        res = matcher.gated_match(ham, gate, max_dist=50, nn_ratio=0.9, mutual=True)
        return res.idx, res.valid

    def try_relocalize(self, fd_host: dict) -> Optional[RelocResult]:
        """fd_host: numpy feature block of the lost frame
        {xy (N,2), desc (N,8) u32, valid (N,), octave (N,), u_right (N,)}."""
        pr = self.place_rec
        if pr is None or pr.vocab is None:
            return None
        pr.ensure_bow_current()  # the freshest keyframe must be retrievable
        arena = self.arena
        N = fd_host["desc"].shape[0]

        word, _, weight = jax.device_get(
            pr._jit_bow(
                pr._tables, jnp.asarray(fd_host["desc"]), jnp.asarray(fd_host["valid"])
            )
        )[0:3]
        from slam_framework_tpu.bow.database import BowFrame

        bow = BowFrame(word, weight)
        from slam_framework_tpu.pipeline.loop_closer import _CovisMap

        candidates = pr.db.detect_relocalization_candidates(
            bow,
            covisibility_groups=_CovisMap(
                arena, self.cfg.mapping.covisibility_edge_min
            ),
        )
        if not candidates:
            if self._debug:
                print("[reloc] no BoW candidates")
            return None
        # best BoW score first (the reference round-robins; scores order the tries)
        candidates = sorted(
            candidates, key=lambda c: -bow.score(pr.db.frames[c])
        )[:5]
        if self._debug:
            print(f"[reloc] candidates={candidates}")

        desc_f = jnp.asarray(fd_host["desc"])
        valid_f = jnp.asarray(fd_host["valid"])
        for cand in candidates:
            pid_c = arena.kf_point_idx[cand]
            mask_c = (pid_c >= 0) & arena.kf_feat_valid[cand]
            mask_c &= np.where(pid_c >= 0, arena.pt_valid[np.maximum(pid_c, 0)], False)
            idx, valid = jax.device_get(
                self._jit_bow_match(
                    desc_f, valid_f, jnp.asarray(arena.kf_desc[cand]), jnp.asarray(mask_c)
                )
            )
            rows = np.nonzero(valid)[0]
            if len(rows) < self.MIN_BOW_MATCHES:
                if self._debug:
                    print(f"[reloc] cand {cand}: only {len(rows)} BoW matches")
                continue
            pids = pid_c[idx[rows]]

            pts_w = np.zeros((N, 3), np.float32)
            uv = np.zeros((N, 2), np.float32)
            inv_s2 = np.ones(N, np.float32)
            mask = np.zeros(N, bool)
            n = len(rows)
            pts_w[:n] = arena.pt_pos[pids]
            uv[:n] = fd_host["xy"][rows]
            inv_s2[:n] = self._inv_sf2[
                np.clip(fd_host["octave"][rows], 0, self.cfg.orb.num_levels - 1)
            ]
            mask[:n] = True

            # stereo/RGB-D path: back-project frame keypoints through their
            # stereo depth and solve 3D-3D Horn RANSAC — planar-safe where the
            # 2D DLT resection degenerates on corridor geometry (pnp.py:
            # solve_pnp3d_ransac docstring). Mono frames (no u_right) fall
            # through to the 2D solver.
            ur_rows = fd_host["u_right"][rows]
            disp = uv[:n, 0] - ur_rows
            has_d = (ur_rows > 0) & (disp > 0.1)
            self._key, sub = jax.random.split(self._key)
            if int(has_d.sum()) >= 10:
                bf = self.K.bf
                z = np.where(has_d, bf / np.maximum(disp, 0.1), 0.0)
                pts_c = np.zeros((N, 3), np.float32)
                pts_c[:n, 0] = (uv[:n, 0] - self.K.cx) * z / self.K.fx
                pts_c[:n, 1] = (uv[:n, 1] - self.K.cy) * z / self.K.fy
                pts_c[:n, 2] = z
                mask3 = np.zeros(N, bool)
                mask3[:n] = has_d
                res = self._jit_pnp3d(
                    jnp.asarray(pts_w), jnp.asarray(pts_c), jnp.asarray(uv),
                    jnp.asarray(inv_s2), jnp.asarray(mask3), key=sub,
                )
            else:
                res = self._jit_pnp(
                    jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(inv_s2),
                    jnp.asarray(mask), key=sub,
                )
            ok = bool(jax.device_get(res.ok))
            if not ok:
                if self._debug:
                    print(f"[reloc] cand {cand}: {len(rows)} matches "
                          f"({int(has_d.sum())} w/depth), PnP failed "
                          f"n_inl={int(jax.device_get(res.n_inliers))}")
                # weak consensus is still a pose HYPOTHESIS: the guided
                # projection widens the match set against the candidate's
                # local map and the >= 50-inlier bar arbitrates — a wrong
                # hypothesis cannot pass it (tracker.cpp:930-975's spirit:
                # keep trying while any pose candidate remains)
                if int(jax.device_get(res.n_inliers)) >= 3:
                    got = self._guided_retry(
                        cand, np.asarray(jax.device_get(res.pose), np.float32),
                        fd_host,
                    )
                    if got is not None:
                        return got
                continue

            # Motion-only BA over the FULL match set (stereo rows where available),
            # seeded by the RANSAC pose. pose_opt reclassifies inliers from
            # obs.mask every round (reference: PoseOptimization gets every match,
            # outliers reclaimable, optimizer.cpp:365-401), so gating the mask by
            # the RANSAC consensus would only starve it.
            ur = np.full(N, -1.0, np.float32)
            ur[:n] = fd_host["u_right"][rows]
            obs = pose_opt.PoseObs(
                points_w=jnp.asarray(pts_w),
                uv=jnp.asarray(uv),
                ur=jnp.asarray(ur),
                inv_sigma2=jnp.asarray(inv_s2),
                mask=jnp.asarray(mask),
            )
            opt = self._jit_pose_opt(res.pose, obs)
            pose, inliers, n_inl = jax.device_get(
                [opt.pose, opt.inliers, opt.num_inliers]
            )
            if self._debug:
                print(f"[reloc] cand {cand}: {len(rows)} matches, pose-opt "
                      f"inliers {int(n_inl)} (accept >= {self.MIN_ACCEPT})")
            if int(n_inl) >= self.MIN_ACCEPT:
                keep = inliers[:n]
                return RelocResult(
                    pose=np.asarray(pose, np.float32),
                    kf=int(cand),
                    feat_idx=rows[keep],
                    point_ids=pids[keep].astype(np.int32),
                    n_inliers=int(n_inl),
                )
            # Guided-projection retry (tracker.cpp:930-975): the BoW match set
            # was too small, but a pose hypothesis holds — project the
            # candidate's local map through it and re-optimize over the widened
            # match set. When the motion-only BA itself diverged (a majority-
            # outlier BoW set drags it off before chi2 can reclassify), retry
            # from the RANSAC pose instead — the widened projection-gated set
            # is what rescues it, and the >= 50-inlier bar still arbitrates.
            if int(n_inl) >= self.MIN_RETRY:
                got = self._guided_retry(cand, np.asarray(pose, np.float32), fd_host)
            else:
                got = self._guided_retry(
                    cand, np.asarray(jax.device_get(res.pose), np.float32), fd_host
                )
            if got is not None:
                return got
        return None

    MIN_RETRY = 10              # tracker.cpp:940 (nGood > 10 gates the retry)

    def _guided_retry(
        self, cand: int, pose: np.ndarray, fd_host: dict
    ) -> Optional[RelocResult]:
        pr = self.place_rec
        pts_l, desc_l, ids_l = pr._local_points_of(cand)
        idx_dev, valid_dev = self._jit_guided(
            jnp.asarray(pose[:3, :3]), jnp.asarray(pose[:3, 3]),
            jnp.asarray(pts_l), jnp.asarray(desc_l), jnp.asarray(ids_l >= 0),
            jnp.asarray(fd_host["xy"]), jnp.asarray(fd_host["desc"]),
            jnp.asarray(fd_host["valid"]),
        )
        idx, valid = jax.device_get([idx_dev, valid_dev])
        slots = np.nonzero(valid)[0]          # point slots with a frame match
        if len(slots) < self.MIN_ACCEPT:
            return None
        feats = idx[slots]                    # matched frame feature per slot
        P = pts_l.shape[0]
        uv = np.zeros((P, 2), np.float32)
        ur = np.full(P, -1.0, np.float32)
        inv_s2 = np.ones(P, np.float32)
        mask = np.zeros(P, bool)
        uv[slots] = fd_host["xy"][feats]
        ur[slots] = fd_host["u_right"][feats]
        inv_s2[slots] = self._inv_sf2[
            np.clip(fd_host["octave"][feats], 0, self.cfg.orb.num_levels - 1)
        ]
        mask[slots] = True
        obs = pose_opt.PoseObs(
            points_w=jnp.asarray(pts_l), uv=jnp.asarray(uv), ur=jnp.asarray(ur),
            inv_sigma2=jnp.asarray(inv_s2), mask=jnp.asarray(mask),
        )
        opt = self._jit_pose_opt(jnp.asarray(pose), obs)
        pose2, inliers, n_inl = jax.device_get([opt.pose, opt.inliers, opt.num_inliers])
        if int(n_inl) < self.MIN_ACCEPT:
            return None
        keep = np.nonzero(inliers)[0]
        return RelocResult(
            pose=np.asarray(pose2, np.float32),
            kf=int(cand),
            feat_idx=idx[keep],
            point_ids=ids_l[keep].astype(np.int32),
            n_inliers=int(n_inl),
        )
