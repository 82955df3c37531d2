"""Monocular tracking stage: two-view bootstrap + scale-normalized tracking.

Replacement for the reference's monocular path:
MonocularInitialization (src/core/tracker.cpp:297-364), CreateInitialMapMonocular
(:366-460), SearchForInitialization (src/orb_features/orb_matcher.cpp:264-382) and
the mono keyframe policy (:1271-1278 — ref-ratio 0.9, no stereo close-point logic).

Reuses the whole stereo tracking machine (pipeline/tracker.py): the device chunk
program is identical — with no stereo head, u_right/depth are -1 so every residual
downstream degrades to the 2-dof mono form, and keyframe creation spawns no
depth-points (the local mapper's batched triangulation supplies new landmarks,
pipeline/mapping_ops.py). Map scale is fixed by normalizing the initial map's median
depth to 1 (tracker.cpp:417-438) and is observable only up to gauge — trajectories
are evaluated Sim3-aligned (io/trajectory.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.map.arena import MapArena
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.pipeline.frame import MonoFrontend
from slam_framework_tpu.utils import progcache
from slam_framework_tpu.pipeline.tracker import (
    DeviceTrackState,
    FrameRecord,
    StereoTracker,
    TrackingState,
)
from slam_framework_tpu.solvers import initializer


class _MonoChunkFrontend:
    """Adapts MonoFrontend to the (left, right) signature of the chunk program —
    the second image is ignored (the tracker feeds the same image twice)."""

    def __init__(self, cfg: SlamConfig):
        self.inner = MonoFrontend(cfg)
        self.K = self.inner.K

    def _process(self, left, right):
        return self.inner._process(left)

    def __call__(self, left, right=None):
        return self.inner(left)


class MonoTracker(StereoTracker):
    MIN_INIT_MATCHES = 100      # tracker.cpp:310,331
    INIT_WINDOW_PX = 100.0      # SearchForInitialization window (tracker.cpp:308)
    MAX_KFS_PER_CHUNK = 2       # mono needs rapid keyframe insertion after
                                # bootstrap (the reference inserts per-frame;
                                # our chunked sync caps cadence)

    def __init__(self, cfg: SlamConfig, arena: Optional[MapArena] = None, sync_every: int = 4):
        assert cfg.sensor == "monocular"
        super().__init__(cfg, arena, sync_every=sync_every)
        self._init_ref: Optional[dict] = None
        self._key = jax.random.PRNGKey(3)
        # The reference extracts 2x features while monocular-uninitialized
        # (tracker.cpp:84-90) — bootstrap needs match density the steady-state
        # budget can't provide on sparse scenes. Only this separate init-path
        # extractor is doubled; the chunk program keeps its fixed 1x shapes.
        self._init_frontend = MonoFrontend(cfg, feature_multiplier=2)
        fpm = ("MonoTracker", progcache.config_fingerprint(cfg))
        self._jit_init_match = progcache.shared_jit(
            fpm + ("init_match",), lambda: jax.jit(self._init_match)
        )
        self._jit_two_view = progcache.shared_jit(
            fpm + ("two_view",),
            lambda: jax.jit(
                functools.partial(initializer.initialize_two_view, K=self.K)
            ),
        )

    # StereoTracker.__init__ picks the frontend by sensor:
    # (patched in pipeline/tracker.py to call _make_frontend)
    def _make_frontend(self):
        return _MonoChunkFrontend(self.cfg)

    def _current_sync(self) -> int:
        """Short dispatch interval until the map matures: a 2-view bootstrap map
        (~150 points) loses tracking within 4 frames without keyframe refresh
        (measured inlier decay 95 -> 26 over one 4-frame chunk)."""
        return min(2, self.sync_every) if self.arena.n_valid_kfs < 8 else self.sync_every

    def track_image(self, img: np.ndarray, timestamp: float):
        """Single-image entry; feeds the chunk program's 2-slot image layout."""
        return self.track(img, img, timestamp)

    # ------------------------------------------------------------------ init

    def _init_match(self, ref_xy, ref_desc, ref_valid, ref_angle, cur):
        """SearchForInitialization (orb_matcher.cpp:264-382): window search around
        the reference feature positions + ratio + rotation-consistency."""
        ham = hamming.hamming_matrix(ref_desc, cur.desc)
        gate = (
            matcher.window_gate(
                ref_xy, cur.xy, jnp.full(ref_xy.shape[0], self.INIT_WINDOW_PX)
            )
            & ref_valid[:, None]
            & cur.valid[None, :]
        )
        res = matcher.gated_match(ham, gate, max_dist=50, nn_ratio=0.9, mutual=True)
        res = matcher.rotation_consistency(ref_angle, cur.angle, res)
        res = matcher.resolve_duplicate_columns(res, cur.xy.shape[0])
        return res.idx, res.valid

    def _initialize(self, left, right, timestamp) -> bool:
        fd = self._init_frontend(jnp.asarray(left))  # 2x features (tracker.cpp:84-90)
        host = jax.device_get(
            {
                "xy": fd.xy, "desc": fd.desc, "valid": fd.valid,
                "octave": fd.octave, "angle": fd.angle,
            }
        )
        n_feats = int(host["valid"].sum())
        if self._init_ref is None:
            if n_feats > self.MIN_INIT_FEATURES // 5:  # reference: >100 (tracker.cpp:301)
                self._init_ref = {**host, "frame_id": self.frame_id, "ts": timestamp}
            return False
        ref = self._init_ref
        idx_d, val_d = self._jit_init_match(
            jnp.asarray(ref["xy"]), jnp.asarray(ref["desc"]),
            jnp.asarray(ref["valid"]), jnp.asarray(ref["angle"]), fd,
        )
        idx, valid = jax.device_get([idx_d, val_d])
        rows = np.nonzero(valid)[0]
        if len(rows) < self.MIN_INIT_MATCHES:
            self._init_ref = {**host, "frame_id": self.frame_id, "ts": timestamp}
            return False

        N = ref["xy"].shape[0]
        uv1 = np.zeros((N, 2), np.float32)
        uv2 = np.zeros((N, 2), np.float32)
        m = np.zeros(N, bool)
        uv1[: len(rows)] = ref["xy"][rows]
        uv2[: len(rows)] = host["xy"][idx[rows]]
        m[: len(rows)] = True
        self._key, sub = jax.random.split(self._key)
        res = self._jit_two_view(
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(m), key=sub
        )
        ok = bool(jax.device_get(res.ok))
        if not ok:
            # ambiguous motion / too little parallax — both the E path and the
            # planar Faugeras H path (initializer._decompose_H) rejected the pair;
            # keep trying with a fresh reference frame like the reference
            return False
        R, t, pts, good = jax.device_get([res.R, res.t, res.points, res.good])
        return self._create_initial_map(
            ref, host, rows, idx, R, t, pts, good, timestamp
        )

    @staticmethod
    def _compact_init_features(ref, cur, rows, idx, n_cap):
        """Compact 2x-budget init feature sets to the arena's per-KF row capacity:
        matched pairs first (preserved 1:1), then the strongest remaining valid
        features. Returns remapped (ref, cur, rows, idx) with rows = arange(n_m)
        and idx[rows] = arange(n_m)."""
        n_m = len(rows)
        ref_rest = np.setdiff1d(np.nonzero(ref["valid"])[0], rows)[: n_cap - n_m]
        ref_keep = np.concatenate([rows, ref_rest])
        cur_matched = idx[rows]
        cur_rest = np.setdiff1d(np.nonzero(cur["valid"])[0], cur_matched)[: n_cap - n_m]
        cur_keep = np.concatenate([cur_matched, cur_rest])

        def pad_to(d, keep):
            out = {}
            for k, v in d.items():
                if isinstance(v, np.ndarray) and v.shape[:1] == d["valid"].shape:
                    row = v[keep]
                    if len(row) < n_cap:
                        pad = np.zeros((n_cap - len(row),) + row.shape[1:], row.dtype)
                        row = np.concatenate([row, pad])
                    out[k] = row
                else:
                    out[k] = v
            return out

        ref2 = pad_to(ref, ref_keep)
        cur2 = pad_to(cur, cur_keep)
        if len(ref_keep) < n_cap:
            ref2["valid"][len(ref_keep):] = False
        if len(cur_keep) < n_cap:
            cur2["valid"][len(cur_keep):] = False
        new_rows = np.arange(n_m)
        new_idx = np.full(n_cap, -1, np.int64)
        new_idx[:n_m] = np.arange(n_m)
        return ref2, cur2, new_rows, new_idx

    def _create_initial_map(self, ref, cur, rows, idx, R, t, pts, good, timestamp) -> bool:
        """CreateInitialMapMonocular (tracker.cpp:366-460): two keyframes, the
        triangulated points, 20-iteration global BA, median-depth normalization."""
        from slam_framework_tpu.optim import global_ba

        arena = self.arena
        cfg = self.cfg
        n_cap = arena.kf_xy.shape[1]
        if ref["xy"].shape[0] > n_cap:
            # 2x init extraction (tracker.cpp:84-90) -> compact to arena capacity;
            # pts/good stay aligned (they are indexed by match slot, and matched
            # pairs keep their order at the front)
            ref, cur, rows, idx = self._compact_init_features(ref, cur, rows, idx, n_cap)
        N = ref["xy"].shape[0]
        pose1 = np.eye(4, dtype=np.float32)
        pose2 = np.eye(4, dtype=np.float32)
        pose2[:3, :3] = R
        pose2[:3, 3] = t

        kf1 = arena.add_keyframe(
            pose1, ref["frame_id"], ref["ts"], ref["xy"],
            np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
            ref["octave"].astype(np.int16), ref["angle"], ref["desc"], ref["valid"],
            np.full(N, -1, np.int32),
        )
        kf2 = arena.add_keyframe(
            pose2, self.frame_id, timestamp, cur["xy"],
            np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
            cur["octave"].astype(np.int16), cur["angle"], cur["desc"], cur["valid"],
            np.full(N, -1, np.int32),
        )
        sf = cfg.orb.scale_factor
        point_ids2 = np.full(N, -1, np.int32)
        match_slot = np.zeros(N, np.int32)  # compact match index per ref feature
        match_slot[rows] = np.arange(len(rows))
        for f1 in rows:
            slot = match_slot[f1]
            if not good[slot]:
                continue
            f2 = int(idx[f1])
            pos = pts[slot]
            dist = float(np.linalg.norm(pos))
            if dist < 1e-6:
                continue
            octv = float(cur["octave"][f2])
            max_dist = dist * (sf**octv)
            pid = arena.add_point(
                pos.astype(np.float32), cur["desc"][f2], kf2,
                (pos / dist).astype(np.float32),
                max_dist / (sf ** (cfg.orb.num_levels - 1)), max_dist,
            )
            arena.associate(kf1, int(f1), pid)
            arena.associate(kf2, f2, pid)
            point_ids2[f2] = pid
        n_pts = arena.n_valid_pts
        if n_pts < self.MIN_INIT_MATCHES // 2:
            self._wipe_init(kf1, kf2)
            return False

        # 20-iteration full BA over the 2-view map (tracker.cpp:414)
        global_ba.run_global_ba(arena, cfg, self.K, iters=(0, 20))

        # median-depth normalization (tracker.cpp:417-438)
        pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
        z1 = arena.pt_pos[pids] @ arena.kf_pose[kf1][:3, :3].T[:, 2] + arena.kf_pose[kf1][2, 3]
        med = float(np.median(z1))
        if med <= 0 or arena.n_valid_pts < self.MIN_INIT_MATCHES // 2:
            self._wipe_init(kf1, kf2)
            return False
        inv_med = 1.0 / med
        arena.pt_pos[pids] *= inv_med
        for k in (kf1, kf2):
            arena.kf_pose[k][:3, 3] *= inv_med

        # seed the device tracking state from the CURRENT frame
        self.ref_kf = kf2
        self.local_mapper.note_new_points(pids, kf2)
        self._rebuild_block()
        slot = self._ids_to_slots(point_ids2)
        # per-frame velocity from the init baseline: exp(log(T_2<-1) / gap)
        from slam_framework_tpu.geometry import se3 as _se3

        gap = max(int(self.frame_id - ref["frame_id"]), 1)
        T21 = arena.kf_pose[kf2] @ np.linalg.inv(arena.kf_pose[kf1])
        xi = np.asarray(jax.device_get(_se3.se3_log(jnp.asarray(T21)))) / gap
        vel0 = np.asarray(jax.device_get(_se3.se3_exp(jnp.asarray(xi)))).astype(np.float32)
        self._dstate = DeviceTrackState(
            pose=jnp.asarray(arena.kf_pose[kf2]),
            velocity=jnp.asarray(vel0),
            desc=jnp.asarray(cur["desc"]),
            octave=jnp.asarray(cur["octave"].astype(np.int32)),
            angle=jnp.asarray(cur["angle"]),
            pt_pos=jnp.asarray(self._block_pos_for_slots(slot)),
            pt_mask=jnp.asarray(slot >= 0),
            assoc_slot=jnp.asarray(slot),
        )
        eye = np.eye(4, dtype=np.float64)
        self.records.append(
            FrameRecord(ref["frame_id"], ref["ts"], np.eye(4, dtype=np.float32), False,
                        kf1, eye)
        )
        self.records.append(
            FrameRecord(self.frame_id, timestamp, arena.kf_pose[kf2].copy(), False,
                        kf2, eye)
        )
        self.ref_kf_tracked = int((point_ids2 >= 0).sum())
        self.last_kf_frame_id = self.frame_id
        self._init_ref = None
        if self.on_new_keyframe:
            self.on_new_keyframe(kf1)
            self.on_new_keyframe(kf2)
        return True

    def _wipe_init(self, kf1: int, kf2: int) -> None:
        """Failed bootstrap (median depth <= 0 / too few points, tracker.cpp:420-424):
        clear the partial map, keep trying with a fresh reference."""
        arena = self.arena
        for pid in range(arena.num_pts):
            if arena.pt_valid[pid]:
                arena.erase_point(pid)
        arena.erase_keyframe(kf1)
        arena.erase_keyframe(kf2)
        arena.num_kfs = 0
        arena.num_pts = 0
        self._init_ref = None

    # ------------------------------------------------------------------ keyframe policy

    def _need_new_keyframe(self, fid: int, s: np.ndarray) -> bool:
        """Mono variant (tracker.cpp:1271-1278): ref-ratio 0.9, no close-point
        logic (no stereo head)."""
        cfg = self.cfg
        n_inliers = int(s[17])
        if n_inliers < 15:
            return False
        frames_since = fid - self.last_kf_frame_id
        under_ratio = n_inliers < self._ref_kf_tracked_strong() * 0.9
        overdue = frames_since >= cfg.max_frames_between_kfs
        return overdue or (
            under_ratio
            and frames_since >= max(cfg.min_frames_between_kfs, 1)
            and n_inliers > 15
        )
