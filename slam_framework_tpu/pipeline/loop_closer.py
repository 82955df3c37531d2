"""Loop-closing stage: BoW detection → Sim3 verification → correction + pose graph.

Replacement for the LoopCloser thread (reference: src/core/loop_closer.{h,cpp}):
DetectLoop with covisibility-consistency voting (:194-297), ComputeSim3 (:299-469),
CorrectLoop — Sim3 propagation to the covisible group, fuse, essential-graph
optimization (:501-695) — and the follow-up global BA hook (:73-172).

Architecture: the stage is host-sequenced (it runs per keyframe, ~1 Hz) but every
heavy step is one batched device program — descriptor matching as a matmul
(matching.hamming), batched-hypothesis Horn Sim3 RANSAC (solvers.sim3solver),
guided Sim3 projection-matching, and the Sim3 pose graph (optim.pose_graph) with
matrix-free CG. The reference's thread/queue/mutex protocol disappears: sequencing
is explicit, and the transient global-BA thread becomes an explicit call the caller
can schedule.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.bow import vocabulary as bow_vocab
from slam_framework_tpu.bow.database import BowFrame, KeyframeDatabase
from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.geometry.projection import Intrinsics
from slam_framework_tpu.map.arena import MapArena
from slam_framework_tpu.matching import hamming, matcher
from slam_framework_tpu.optim import pose_graph
from slam_framework_tpu.pipeline import track_ops
from slam_framework_tpu.solvers import sim3solver
from slam_framework_tpu.utils import progcache
from slam_framework_tpu.utils.precision import einsum as _einsum


# ----------------------------------------------------------------- host Sim3 helpers
# Tiny numpy Sim3 ops for the host-side correction bookkeeping (the device-side
# counterparts live in geometry/sim3.py; these avoid a device round-trip per op).

def np_sim3(R: np.ndarray, t: np.ndarray, s: float):
    return {"R": np.asarray(R, np.float64), "t": np.asarray(t, np.float64), "s": float(s)}


def np_sim3_from_se3(T: np.ndarray):
    return np_sim3(T[:3, :3], T[:3, 3], 1.0)


def np_sim3_compose(A, B):
    return np_sim3(A["R"] @ B["R"], A["s"] * (A["R"] @ B["t"]) + A["t"], A["s"] * B["s"])


def np_sim3_inverse(S):
    Rt = S["R"].T
    return np_sim3(Rt, -(Rt @ S["t"]) / S["s"], 1.0 / S["s"])


def np_sim3_apply(S, pts: np.ndarray) -> np.ndarray:
    return S["s"] * (pts @ S["R"].T) + S["t"]


def np_sim3_to_se3(S) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = S["R"]
    T[:3, 3] = S["t"] / S["s"]
    return T


class LoopCandidate(NamedTuple):
    kf: int
    Scl: dict              # host Sim3: loop-KF camera frame -> current camera frame
    n_inliers: int


class _CovisMap:
    """Lazy covisibility-group lookup for KeyframeDatabase voting."""

    def __init__(self, arena: MapArena, min_shared: int):
        self.arena = arena
        self.min_shared = min_shared

    def get(self, kf, default=None):
        ids = self.arena.covisible_keyframes(int(kf), min_shared=self.min_shared)
        return [int(kf)] + [int(i) for i in ids]


class LoopCloser:
    """Per-keyframe loop detection and correction over the array map."""

    def __init__(
        self,
        cfg: SlamConfig,
        arena: MapArena,
        K: Intrinsics,
        vocab: Optional[bow_vocab.Vocabulary] = None,
        kf_store=None,
        mesh=None,
    ):
        self.cfg = cfg
        self.arena = arena
        self.K = K
        self.vocab = vocab
        # Device mesh for the post-loop global BA (SURVEY.md §2.3 / §5.8: the
        # reference WIRES its concurrency into the system at construction —
        # slam_system.cpp:49-82 launches the threads, loop_closer.cpp:685-690
        # spawns the GBA worker; here the system hands the loop closer the mesh
        # and the GBA runs as a sharded SPMD program over it, with point
        # ownership migrated between covisibility segments after each merge).
        self.mesh = mesh
        self.partition = None  # live map partition (parallel/map_shard.py)
        # Device-resident keyframe feature store (pipeline/kf_store.py): BoW,
        # descriptor matching and Sim3-guided programs gather kf features by
        # INDEX instead of re-uploading ~130 KB of desc/xy per call
        self.kf_store = kf_store
        self.db = KeyframeDatabase(vocab.num_words if vocab else 0)
        self.bow_frames: dict[int, BowFrame] = {}
        self.consistent_groups: List[Tuple[set, int]] = []
        self.last_loop_kf = -(10**9)
        # Sim3-failure cooldown (host-side gate, no reference analogue needed:
        # its async LoopClosing thread re-attempts for free, while here every
        # attempt costs a mapper drain + several host-device round trips on the
        # critical path).
        # A failed candidate's covisibility group is suppressed for
        # cfg.loop.sim3_fail_cooldown keyframes.
        self._sim3_failed: List[Tuple[set, int]] = []  # (group, failed_at_kf)
        self.n_sim3_attempts = 0
        self.loop_edges: List[Tuple[int, int, dict]] = []  # (kf_a, kf_b, S_ab host Sim3)
        self.n_loops_closed = 0
        self.last_report: dict = {}
        self.cap_clips: dict = {}
        self._gba_pending = None   # in-flight async global BA (see apply_pending_gba)
        self._bow_pending = None   # (kf, word_dev, weight_dev) awaiting harvest
        self._jit_gba = None
        self._key = jax.random.PRNGKey(7)
        self._tables = vocab.device_tables() if vocab else None

        fix_scale = cfg.sensor in ("stereo", "rgbd")
        # shared across same-config instances (utils/progcache.py; see tracker)
        fp = ("LoopCloser", progcache.config_fingerprint(cfg),
              vocab.num_words if vocab else 0)
        _sj = progcache.shared_jit
        self._jit_sim3 = _sj(fp + ("sim3",), lambda: jax.jit(
            functools.partial(
                sim3solver.solve_sim3_ransac,
                K=K,
                fix_scale=fix_scale,
                min_inliers=cfg.loop.sim3_min_inliers,
            )
        ))
        self._jit_match = _sj(fp + ("match",),
                              lambda: jax.jit(self._match_descriptors))
        self._jit_guided = _sj(fp + ("guided",),
                               lambda: jax.jit(self._guided_projection_match))
        self._jit_sbs = _sj(fp + ("sbs",), lambda: jax.jit(self._search_by_sim3))
        # Store-indexed variants: ship two int32 indices instead of the feature
        # blocks (the store rows were written device-side at keyframe creation)
        self._jit_match_store = _sj(fp + ("match_store",), lambda: jax.jit(
            lambda descs, ic, il, mc, ml: self._match_descriptors(
                descs[ic], mc, descs[il], ml
            )
        ))
        self._jit_match_store_batch = _sj(fp + ("match_store_batch",), lambda: jax.jit(
            lambda descs, ic, ils, mc, mls: jax.vmap(
                lambda il, ml: self._match_descriptors(descs[ic], mc, descs[il], ml)
            )(ils, mls)
        ))
        self._jit_guided_store = _sj(fp + ("guided_store",), lambda: jax.jit(
            lambda R, t, s, pts, pdesc, pmask, packs, descs, i, fvalid:
            self._guided_projection_match(
                R, t, s, pts, pdesc, pmask, packs[i, :, 0:2], descs[i], fvalid
            )
        ))
        self._jit_sbs_store = _sj(fp + ("sbs_store",), lambda: jax.jit(
            lambda R, t, s, p_c, m_c, maxd_c, p_l, m_l, maxd_l, packs, descs, ic, il:
            self._search_by_sim3(
                R, t, s,
                p_c, m_c, descs[ic], packs[ic, :, 0:2],
                packs[ic, :, 4].astype(jnp.int32), maxd_c,
                p_l, m_l, descs[il], packs[il, :, 0:2],
                packs[il, :, 4].astype(jnp.int32), maxd_l,
            )
        ))
        self._jit_refine = _sj(fp + ("refine",), lambda: jax.jit(
            functools.partial(
                sim3solver.refine_sim3, K=K, fix_scale=fix_scale,
            )
        ))
        if vocab:
            self._jit_bow = _sj(fp + ("bow",), lambda: jax.jit(
                functools.partial(
                    bow_vocab.transform,
                    depth=vocab.depth,
                    k=vocab.k,
                )
            ))
            self._jit_bow_store = _sj(fp + ("bow_store",), lambda: jax.jit(
                lambda tables, descs, i, valid: bow_vocab.transform(
                    tables, descs[i], valid, depth=vocab.depth, k=vocab.k
                )
            ))

    # ------------------------------------------------------------------ device programs

    @staticmethod
    def _match_descriptors(desc_a, mask_a, desc_b, mask_b):
        """SearchByBoW(KF, KF) equivalent (orb_matcher.cpp:499-632): mutual best
        Hamming match under TH_LOW with 0.75 nn-ratio. The reference prunes the
        search by shared vocabulary nodes purely for CPU speed; a matmul computes
        the full matrix faster than the pruned gather."""
        ham = hamming.hamming_matrix(desc_a, desc_b)
        gate = mask_a[:, None] & mask_b[None, :]
        res = matcher.gated_match(ham, gate, max_dist=50, nn_ratio=0.75, mutual=True)
        return res.idx, res.valid

    def _guided_projection_match(
        self, S_R, S_t, S_s, pts_w, pt_desc, pt_mask, kf_xy, kf_desc, kf_valid
    ):
        """SearchByProjection(Scw) (orb_matcher.cpp:384-497): project world points
        through a Sim3 world->cam, window-gate against keyframe features, Hamming
        match (TH_LOW), per-feature dedup."""
        K = self.K
        pc = S_s * _einsum("ni,ji->nj", pts_w, S_R) + S_t[None, :]
        z = jnp.where(pc[:, 2] > 1e-6, pc[:, 2], 1e-6)
        uv = jnp.stack([K.fx * pc[:, 0] / z + K.cx, K.fy * pc[:, 1] / z + K.cy], axis=-1)
        in_front = pc[:, 2] > 0.05
        W, H = self.cfg.camera.width, self.cfg.camera.height
        in_img = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        ok = pt_mask & in_front & in_img
        gate = matcher.window_gate(uv, kf_xy, jnp.full(uv.shape[0], 10.0)) & (
            ok[:, None] & kf_valid[None, :]
        )
        ham = hamming.hamming_matrix(pt_desc, kf_desc)
        res = matcher.gated_match(ham, gate, max_dist=50)
        res = matcher.resolve_duplicate_columns(res, kf_xy.shape[0])
        return res.idx, res.valid

    def _search_by_sim3(
        self, S_R, S_t, S_s,
        p_c, mask_c, desc_c, xy_c, oct_c, maxd_c,
        p_l, mask_l, desc_l, xy_l, oct_l, maxd_l,
    ):
        """SearchBySim3 (orb_matcher.cpp:1081-1310): widen the Sim3 correspondence
        set by MUTUAL Sim3-guided projection between the two keyframes — loop-KF
        points projected into the current image and vice versa; a pair is accepted
        only when both directions agree (the reference's check-agreement loop,
        :1288-1300). All feature-slot aligned, one fixed-shape device program.

        p_c/p_l: (N,3) map points in each keyframe's OWN camera frame; masks mark
        features with a (valid, not already matched) point. Returns per-current-
        feature loop-feature index (-1 none)."""
        cfg = self.cfg
        sf = cfg.orb.scale_factor
        K = self.K
        W, H = cfg.camera.width, cfg.camera.height

        def half(R, t, s, pts, m_pts, maxd, xy_t, desc_p, desc_t, m_t, oct_t):
            p = s * _einsum("ni,ji->nj", pts, R) + t[None, :]
            z = jnp.where(p[:, 2] > 1e-6, p[:, 2], 1e-6)
            uv = jnp.stack([K.fx * p[:, 0] / z + K.cx, K.fy * p[:, 1] / z + K.cy], -1)
            dist = jnp.linalg.norm(p, axis=-1)
            lvl = track_ops.predict_scale(
                dist, maxd, cfg.orb.num_levels, log_sf=float(np.log(sf))
            )
            radius = 7.5 * sf ** lvl.astype(jnp.float32)   # orb_matcher.cpp:1161
            gate = (
                matcher.window_gate(uv, xy_t, radius)
                & (m_pts & (p[:, 2] > 0.0))[:, None]
                & m_t[None, :]
                & (uv[:, 0] >= 0)[:, None] & (uv[:, 0] < W)[:, None]
                & (uv[:, 1] >= 0)[:, None] & (uv[:, 1] < H)[:, None]
                # kpLevel in [predicted-1, predicted] (orb_matcher.cpp:1153,1253)
                & (oct_t[None, :] >= lvl[:, None] - 1) & (oct_t[None, :] <= lvl[:, None])
            )
            ham = hamming.hamming_matrix(desc_p, desc_t)
            res = matcher.gated_match(ham, gate, max_dist=100)  # TH_HIGH
            return jnp.where(res.valid, res.idx, -1)

        Rt = S_R.T
        # loop -> current (through Scl), current -> loop (through Scl^-1)
        m_lc = half(S_R, S_t, S_s, p_l, mask_l, maxd_l, xy_c, desc_l, desc_c, mask_c, oct_c)
        m_cl = half(Rt, -_einsum("ij,j->i", Rt, S_t) / S_s, 1.0 / S_s, p_c, mask_c, maxd_c,
                    xy_l, desc_c, desc_l, mask_l, oct_l)
        # agreement: current feature i -> loop feature j and j -> i
        j = m_cl
        back = jnp.where(j >= 0, m_lc[jnp.maximum(j, 0)], -2)
        agreed = back == jnp.arange(p_c.shape[0], dtype=back.dtype)
        return jnp.where(agreed, j, -1)

    # ------------------------------------------------------------------ BoW bookkeeping

    def compute_bow(self, kf: int) -> BowFrame:
        """DBoW2 transform of a keyframe's descriptors (keyframe.cpp:127-137)."""
        arena = self.arena
        valid = jnp.asarray(arena.kf_feat_valid[kf])
        if self.kf_store is not None:
            self.kf_store.ensure([kf], arena)
            word, _, weight = self._jit_bow_store(
                self._tables, self.kf_store.descs, jnp.int32(kf), valid
            )
        else:
            word, _, weight = self._jit_bow(
                self._tables, jnp.asarray(arena.kf_desc[kf]), valid
            )
        word, weight = jax.device_get([word, weight])
        return BowFrame(word, weight)

    # ------------------------------------------------------------------ main entry

    def has_pending_gba(self) -> bool:
        return self._gba_pending is not None

    def _dispatch_bow(self, kf: int) -> None:
        """Async BoW transform dispatch — the device_get is deferred to the
        NEXT keyframe (harvest), so the tracker's critical path never blocks on
        the place-recognition fetch. The reference gets the same decoupling from
        its LoopClosing thread's keyframe queue (loop_closer.cpp:61-85)."""
        arena = self.arena
        valid = jnp.asarray(arena.kf_feat_valid[kf])
        if self.kf_store is not None:
            self.kf_store.ensure([kf], arena)
            word, _, weight = self._jit_bow_store(
                self._tables, self.kf_store.descs, jnp.int32(kf), valid
            )
        else:
            word, _, weight = self._jit_bow(
                self._tables, jnp.asarray(arena.kf_desc[kf]), valid
            )
        self._bow_pending = (kf, word, weight)

    def aux_templates(self):
        """(shape, dtype) of the aux arrays when absent — lets the tracker pad
        its fixed-slot payload so the packed-fetch program keeps one compiled
        signature whether or not a BoW transform is in flight."""
        node_weight, node_word = self._tables[2], self._tables[3]
        Fn = self.arena.kf_desc.shape[1]
        return [((Fn,), np.dtype(node_word.dtype)), ((Fn,), np.dtype(node_weight.dtype))]

    def aux_handles(self):
        """Device arrays of the in-flight BoW transform, or None — the tracker
        folds these into its consolidated drain fetch (tracker.aux_fetch), so
        _harvest_bow never blocks behind the in-flight chunk."""
        if self._bow_pending is None:
            return None
        _, word_d, weight_d = self._bow_pending
        if isinstance(word_d, np.ndarray):
            return None  # already delivered
        return [word_d, weight_d]

    def aux_deliver(self, fetched) -> None:
        if self._bow_pending is None:
            return
        kf, _, _ = self._bow_pending
        self._bow_pending = (kf, np.asarray(fetched[0]), np.asarray(fetched[1]))

    def ensure_bow_current(self) -> None:
        """Land the in-flight BoW into the place-recognition database NOW.

        Called by the relocalizer before candidate retrieval: when tracking is
        lost right after a keyframe, that keyframe's BoW is still awaiting its
        harvest (which normally happens at the NEXT keyframe — that never
        comes while lost), so the closest — usually best — reloc candidate
        would be invisible (measured: a 3-frame blackout relocalized against
        a keyframe 8 m back while the 4 m-back one sat unharvested). Loop
        DETECTION for this keyframe is skipped — relocalization needs the
        database row, not the detection pass."""
        prev = self._harvest_bow()
        if prev is not None:
            self.db.add(prev[0], prev[1])

    def _harvest_bow(self):
        if self._bow_pending is None:
            return None
        kf, word_d, weight_d = self._bow_pending
        self._bow_pending = None
        if not self.arena.kf_valid[kf]:
            return None  # culled while in flight
        if isinstance(word_d, np.ndarray):  # delivered via the drain fetch
            word, weight = word_d, weight_d
        else:
            word, weight = jax.device_get([word_d, weight_d])
        bow = BowFrame(word, weight)
        self.bow_frames[kf] = bow
        return kf, bow

    def _detect_and_close(self, kf: int, bow: BowFrame, pre_close=None) -> bool:
        candidates = self._detect(kf, bow)
        self.db.add(kf, bow)
        if not candidates:
            return False
        # First pass WITHOUT draining the mapper: Sim3 RANSAC + guided
        # acceptance tolerate one-local-BA of pose/point staleness (mm-cm
        # against the RANSAC's own noise), and on the bench ~50 consistent
        # candidate sets FAIL here per closed loop — each pre_close() costs a
        # blocking fetch of the in-flight BA/tri/fuse pendings (~100-300 ms).
        # Only a PASSING candidate pays the drain, and is then re-verified +
        # corrected on settled state (the reference's CorrectLoop stops the
        # mapper only after ComputeSim3 accepts — loop_closer.cpp:501-524).
        self.n_sim3_attempts += 1
        cand = self._compute_sim3(kf, candidates)
        if cand is not None and pre_close is not None:
            pre_close()  # settle the map, then re-verify on it
            cand = self._compute_sim3(kf, [cand.kf])
        if cand is None:
            # start the failure cooldown for every attempted candidate group
            arena = self.arena
            for c in candidates:
                grp = set(
                    int(i) for i in arena.covisible_keyframes(
                        c, min_shared=self.cfg.mapping.covisibility_edge_min
                    )
                ) | {c}
                self._sim3_failed.append((grp, kf))
            return False
        self._correct_loop(kf, cand)
        self.n_loops_closed += 1
        self.last_loop_kf = kf
        return True

    def process_keyframe(self, kf: int, pre_close=None) -> bool:
        """One step of the loop-closing stage: harvest the PREVIOUS keyframe's
        in-flight BoW and run detection/Sim3/correction for it, then dispatch
        this keyframe's BoW. Detection therefore runs one keyframe late — the
        same bounded lag as the reference's LoopClosing thread consuming its
        keyframe queue (loop_closer.cpp:61-85, 194-297). Returns True if a
        loop was closed (map poses/points were rewritten).

        pre_close: called once, right before Sim3 computation, only when
        detection produced consistent candidates — the caller uses it to drain
        in-flight mapper work (Sim3/correction need settled poses; detection is
        appearance-only and does not)."""
        if self.vocab is None:
            return False
        closed = False
        prev = self._harvest_bow()
        if prev is not None:
            closed = self._detect_and_close(prev[0], prev[1], pre_close=pre_close)
        self._dispatch_bow(kf)
        return closed

    def flush(self, pre_close=None) -> bool:
        """Drain the in-flight BoW (end of sequence / before exports): run the
        deferred detection for the final keyframe."""
        prev = self._harvest_bow()
        if prev is None:
            return False
        return self._detect_and_close(prev[0], prev[1], pre_close=pre_close)

    # ------------------------------------------------------------------ detection

    def _detect(self, kf: int, bow: BowFrame) -> List[int]:
        """DetectLoop (loop_closer.cpp:194-297): BoW candidates below the covisible
        score floor + temporal-consistency voting across keyframes."""
        cfg = self.cfg
        if kf < self.last_loop_kf + cfg.loop.min_kf_gap or kf < cfg.loop.min_kf_gap:
            return []
        arena = self.arena
        covis = arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min)
        min_score = 1.0
        for c in covis:
            other = self.bow_frames.get(int(c))
            if other is not None:
                min_score = min(min_score, bow.score(other))
        connected = set(int(c) for c in covis) | {kf}
        raw = self.db.detect_loop_candidates(
            bow,
            min_score,
            connected,
            covisibility_groups=_CovisMap(arena, cfg.mapping.covisibility_edge_min),
        )
        if not raw:
            self.consistent_groups = []
            return []
        # consistency voting (loop_closer.cpp:244-296): a candidate's covisibility
        # group must overlap a group seen in N consecutive keyframes
        enough: List[int] = []
        new_groups: List[Tuple[set, int]] = []
        for cand in raw:
            group = set(
                int(i)
                for i in arena.covisible_keyframes(cand, min_shared=cfg.mapping.covisibility_edge_min)
            ) | {cand}
            best_count = 0
            for prev_set, prev_count in self.consistent_groups:
                if group & prev_set:
                    best_count = max(best_count, prev_count + 1)
            new_groups.append((group, best_count))
            if best_count >= cfg.loop.consistency_threshold:
                enough.append(cand)
        self.consistent_groups = new_groups
        # failure cooldown: suppress candidates whose group overlaps one that
        # just failed Sim3 (each attempt drains the mapper + several fetches; a
        # genuine loop's overlap only grows, so a short cooldown merely delays
        # acceptance by <= cooldown keyframes)
        cd = cfg.loop.sim3_fail_cooldown
        if cd > 0 and self._sim3_failed and enough:
            self._sim3_failed = [
                (g, at) for (g, at) in self._sim3_failed if kf - at <= cd
            ]
            cand_group = dict(zip(raw, new_groups))
            kept = []
            for cand in enough:
                grp = cand_group[cand][0]
                if any(grp & g for (g, at) in self._sim3_failed):
                    continue
                kept.append(cand)
            enough = kept
        return enough

    # ------------------------------------------------------------------ Sim3

    def _compute_sim3(self, kf: int, candidates: List[int]) -> Optional[LoopCandidate]:
        """ComputeSim3 (loop_closer.cpp:299-469): descriptor matches -> batched Horn
        RANSAC -> guided-projection acceptance against the loop KF's local points."""
        arena = self.arena
        cfg = self.cfg
        sf2 = cfg.orb.scale_factor ** 2

        desc_c = None if self.kf_store is not None else jnp.asarray(arena.kf_desc[kf])
        pid_c = arena.kf_point_idx[kf]
        mask_c_np = (pid_c >= 0) & arena.kf_feat_valid[kf]
        mask_c_np &= np.where(pid_c >= 0, arena.pt_valid[np.maximum(pid_c, 0)], False)
        mask_c = jnp.asarray(mask_c_np)
        T_cw = arena.kf_pose[kf].astype(np.float64)

        # Descriptor matching for ALL candidates in one batched program + one
        # fetch (the common bench case is several BoW-plausible candidates that
        # all die here; per-candidate dispatch+fetch paid the host-device
        # round trip C times over)
        cand_masks = {}
        for cand in candidates:
            pid_l = arena.kf_point_idx[cand]
            m = (pid_l >= 0) & arena.kf_feat_valid[cand]
            m &= np.where(pid_l >= 0, arena.pt_valid[np.maximum(pid_l, 0)], False)
            cand_masks[cand] = m
        if self.kf_store is not None and len(candidates) > 1:
            self.kf_store.ensure([kf] + list(candidates), arena)
            # pad the candidate lane to a FIXED width so one compiled program
            # covers every candidate count (a (C,)-shaped program per count
            # cost a fresh compile each; pads carry all-False masks)
            C_pad = 8 * int(np.ceil(len(candidates) / 8))
            ids_pad = np.zeros(C_pad, np.int32)
            ids_pad[: len(candidates)] = np.asarray(candidates, np.int32)
            mls_np = np.zeros((C_pad,) + cand_masks[candidates[0]].shape, bool)
            for i, c in enumerate(candidates):
                mls_np[i] = cand_masks[c]
            idx_b, valid_b = jax.device_get(self._jit_match_store_batch(
                self.kf_store.descs, jnp.int32(kf), jnp.asarray(ids_pad),
                mask_c, jnp.asarray(mls_np)
            ))
            match_of = {c: (idx_b[i], valid_b[i]) for i, c in enumerate(candidates)}
        else:
            match_of = None

        for cand in candidates:
            mask_l_np = cand_masks[cand]
            pid_l = arena.kf_point_idx[cand]
            if match_of is not None:
                idx, valid = match_of[cand]
            elif self.kf_store is not None:
                self.kf_store.ensure([kf, cand], arena)
                idx_dev, valid_dev = self._jit_match_store(
                    self.kf_store.descs, jnp.int32(kf), jnp.int32(cand),
                    mask_c, jnp.asarray(mask_l_np),
                )
                idx, valid = jax.device_get([idx_dev, valid_dev])
            else:
                idx_dev, valid_dev = self._jit_match(
                    desc_c, mask_c, jnp.asarray(arena.kf_desc[cand]),
                    jnp.asarray(mask_l_np),
                )
                idx, valid = jax.device_get([idx_dev, valid_dev])
            rows = np.nonzero(valid)[0]
            if len(rows) < cfg.loop.sim3_min_inliers:
                continue
            cols = idx[rows]
            # 3D points in each camera frame
            T_lw = arena.kf_pose[cand].astype(np.float64)
            p_c_w = arena.pt_pos[pid_c[rows]]
            p_l_w = arena.pt_pos[pid_l[cols]]
            p_c = (p_c_w @ T_cw[:3, :3].T) + T_cw[:3, 3]
            p_l = (p_l_w @ T_lw[:3, :3].T) + T_lw[:3, 3]
            N = arena.kf_desc.shape[1]
            pts1 = np.zeros((N, 3), np.float32)
            pts2 = np.zeros((N, 3), np.float32)
            uv1 = np.zeros((N, 2), np.float32)
            uv2 = np.zeros((N, 2), np.float32)
            s2_1 = np.ones(N, np.float32)
            s2_2 = np.ones(N, np.float32)
            m = np.zeros(N, bool)
            n = len(rows)
            pts1[:n] = p_c
            pts2[:n] = p_l
            uv1[:n] = arena.kf_xy[kf, rows]
            uv2[:n] = arena.kf_xy[cand, cols]
            s2_1[:n] = sf2 ** arena.kf_octave[kf, rows].astype(np.float32)
            s2_2[:n] = sf2 ** arena.kf_octave[cand, cols].astype(np.float32)
            m[:n] = True
            self._key, sub = jax.random.split(self._key)
            res = self._jit_sim3(
                jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(uv1), jnp.asarray(uv2),
                jnp.asarray(s2_1), jnp.asarray(s2_2), jnp.asarray(m), key=sub,
            )
            ok, n_inl = jax.device_get([res.ok, res.n_inliers])
            if not bool(ok):
                continue
            R, t, s = jax.device_get([res.R, res.t, res.s])

            # --- SearchBySim3 widening (loop_closer.cpp:414-438): mutual
            # Sim3-guided projection between the two keyframes recovers
            # correspondences BoW missed, then the Sim3 is re-refined on the
            # widened set (OptimizeSim3, accept >= 20). Rescues borderline
            # loops that are BoW-weak but geometry-strong. ---
            maxd_c = np.where(mask_c_np, arena.pt_max_dist[np.maximum(pid_c, 0)], 0.0)
            maxd_l = np.where(mask_l_np, arena.pt_max_dist[np.maximum(pid_l, 0)], 0.0)
            pc_cam = (arena.pt_pos[np.maximum(pid_c, 0)] @ T_cw[:3, :3].T) + T_cw[:3, 3]
            pl_cam = (arena.pt_pos[np.maximum(pid_l, 0)] @ T_lw[:3, :3].T) + T_lw[:3, 3]
            bow_of_c = np.full(len(pid_c), -1, np.int32)
            bow_of_c[rows] = cols
            bow_l = np.zeros(len(pid_l), bool)
            bow_l[cols] = True  # vbAlreadyMatched2 (orb_matcher.cpp:1118-1124)
            if self.kf_store is not None:
                sbs = jax.device_get(self._jit_sbs_store(
                    jnp.asarray(np.float32(R)), jnp.asarray(np.float32(t)),
                    jnp.asarray(np.float32(s)),
                    jnp.asarray(pc_cam.astype(np.float32)),
                    jnp.asarray(mask_c_np & (bow_of_c < 0)),
                    jnp.asarray(maxd_c.astype(np.float32)),
                    jnp.asarray(pl_cam.astype(np.float32)),
                    jnp.asarray(mask_l_np & ~bow_l),
                    jnp.asarray(maxd_l.astype(np.float32)),
                    self.kf_store.packs, self.kf_store.descs,
                    jnp.int32(kf), jnp.int32(cand),
                ))
            else:
                sbs = jax.device_get(self._jit_sbs(
                    jnp.asarray(np.float32(R)), jnp.asarray(np.float32(t)),
                    jnp.asarray(np.float32(s)),
                    jnp.asarray(pc_cam.astype(np.float32)),
                    jnp.asarray(mask_c_np & (bow_of_c < 0)),
                    desc_c, jnp.asarray(arena.kf_xy[kf]),
                    jnp.asarray(arena.kf_octave[kf].astype(np.int32)),
                    jnp.asarray(maxd_c.astype(np.float32)),
                    jnp.asarray(pl_cam.astype(np.float32)),
                    jnp.asarray(mask_l_np & ~bow_l),
                    jnp.asarray(arena.kf_desc[cand]), jnp.asarray(arena.kf_xy[cand]),
                    jnp.asarray(arena.kf_octave[cand].astype(np.int32)),
                    jnp.asarray(maxd_l.astype(np.float32)),
                ))
            pair_of_c = np.where(bow_of_c >= 0, bow_of_c, sbs)
            rows_w = np.nonzero(pair_of_c >= 0)[0]
            cols_w = pair_of_c[rows_w]
            if len(rows_w) > len(rows):
                # re-refine on the widened correspondence set
                n = len(rows_w)
                pts1w = np.zeros((N, 3), np.float32)
                pts2w = np.zeros((N, 3), np.float32)
                uv1w = np.zeros((N, 2), np.float32)
                uv2w = np.zeros((N, 2), np.float32)
                s2_1w = np.ones(N, np.float32)
                s2_2w = np.ones(N, np.float32)
                mw = np.zeros(N, bool)
                pts1w[:n] = pc_cam[rows_w]
                pts2w[:n] = pl_cam[cols_w]
                uv1w[:n] = arena.kf_xy[kf, rows_w]
                uv2w[:n] = arena.kf_xy[cand, cols_w]
                s2_1w[:n] = sf2 ** arena.kf_octave[kf, rows_w].astype(np.float32)
                s2_2w[:n] = sf2 ** arena.kf_octave[cand, cols_w].astype(np.float32)
                mw[:n] = True
                R2, t2, s2v, _, cnt2 = jax.device_get(self._jit_refine(
                    jnp.asarray(np.float32(R)), jnp.asarray(np.float32(t)),
                    jnp.asarray(np.float32(s)),
                    jnp.asarray(pts1w), jnp.asarray(pts2w),
                    jnp.asarray(uv1w), jnp.asarray(uv2w),
                    jnp.asarray(s2_1w), jnp.asarray(s2_2w), jnp.asarray(mw),
                ))
                if int(cnt2) >= cfg.loop.sim3_min_inliers:
                    R, t, s, n_inl = R2, t2, float(s2v), int(cnt2)
            Scl = np_sim3(R, t, float(s))

            # guided acceptance: project the loop KF's local map through the
            # corrected S_cw into the current KF (loop_closer.cpp:441-468)
            S_lw = np_sim3_from_se3(T_lw.astype(np.float32))
            S_cw_corr = np_sim3_compose(Scl, S_lw)
            loop_pts, loop_desc, _ = self._local_points_of(cand)
            n_total = self._count_guided_matches(kf, S_cw_corr, loop_pts, loop_desc)
            self.last_report = {
                "candidate": int(cand), "sim3_inliers": int(n_inl),
                "guided_matches": int(n_total),
            }
            if n_total >= cfg.loop.accept_total_matches:
                return LoopCandidate(kf=int(cand), Scl=Scl, n_inliers=int(n_inl))
        return None

    def _local_points_of(self, kf: int, cap: int = 4096):
        """World positions + descriptors of kf's and its covisible KFs' points."""
        arena = self.arena
        kfs = [kf] + [
            int(i)
            for i in arena.covisible_keyframes(kf, min_shared=self.cfg.mapping.covisibility_edge_min)
        ]
        pids = arena.kf_point_idx[np.asarray(kfs, np.int64)].reshape(-1)
        pids = np.unique(pids[pids >= 0])
        pids = pids[arena.pt_valid[pids]]
        if len(pids) > cap:
            # cap visibility (VERDICT r2 Weak #6): keep best-observed, count clip
            self.cap_clips["loop_local_points"] = (
                self.cap_clips.get("loop_local_points", 0) + len(pids) - cap
            )
            pids = pids[np.argsort(-arena.pt_obs_count[pids], kind="stable")[:cap]]
        P = cap
        pts = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        ids = np.full(P, -1, np.int32)
        pts[: len(pids)] = arena.pt_pos[pids]
        desc[: len(pids)] = arena.pt_desc[pids]
        ids[: len(pids)] = pids
        return pts, desc, ids

    def _count_guided_matches(self, kf: int, S_cw, pts, desc) -> int:
        arena = self.arena
        mask = jnp.asarray(np.any(pts != 0, axis=1))
        if self.kf_store is not None:
            self.kf_store.ensure([kf], arena)
            idx_dev, valid_dev = self._jit_guided_store(
                jnp.asarray(np.float32(S_cw["R"])), jnp.asarray(np.float32(S_cw["t"])),
                jnp.asarray(np.float32(S_cw["s"])),
                jnp.asarray(pts), jnp.asarray(desc), mask,
                self.kf_store.packs, self.kf_store.descs, jnp.int32(kf),
                jnp.asarray(arena.kf_feat_valid[kf]),
            )
        else:
            idx_dev, valid_dev = self._jit_guided(
                jnp.asarray(np.float32(S_cw["R"])), jnp.asarray(np.float32(S_cw["t"])),
                jnp.asarray(np.float32(S_cw["s"])),
                jnp.asarray(pts), jnp.asarray(desc), mask,
                jnp.asarray(arena.kf_xy[kf]), jnp.asarray(arena.kf_desc[kf]),
                jnp.asarray(arena.kf_feat_valid[kf]),
            )
        return int(jax.device_get(valid_dev).sum())

    # ------------------------------------------------------------------ correction

    def _correct_loop(self, kf: int, cand: LoopCandidate) -> None:
        """CorrectLoop (loop_closer.cpp:501-695): Sim3-propagate the current
        covisible group, fuse loop points, optimize the essential graph, correct
        all map points."""
        arena = self.arena
        cfg = self.cfg
        loop_kf = cand.kf

        # --- snapshot pre-correction poses for edge measurements ---
        n_kfs = arena.num_kfs
        pre_pose = arena.kf_pose[:n_kfs].copy()

        # --- corrected Sim3 for the current group (loop_closer.cpp:537-585) ---
        group = [kf] + [
            int(i)
            for i in arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min)
        ]
        T_cw = pre_pose[kf].astype(np.float64)
        S_lw = np_sim3_from_se3(arena.kf_pose[loop_kf])
        S_cw_corr = np_sim3_compose(cand.Scl, S_lw)
        corrected: dict[int, dict] = {}
        non_corrected: dict[int, dict] = {}
        for i in group:
            T_iw = pre_pose[i].astype(np.float64)
            T_ic = T_iw @ np.linalg.inv(T_cw)
            S_ic = np_sim3_from_se3(T_ic.astype(np.float32))
            corrected[i] = np_sim3_compose(S_ic, S_cw_corr)
            non_corrected[i] = np_sim3_from_se3(pre_pose[i])

        # --- move group points + poses (each point corrected once, via its first
        # observing group member) ---
        moved = set()
        for i in group:
            pids = arena.kf_point_idx[i]
            pids = np.unique(pids[pids >= 0])
            pids = [int(p) for p in pids if arena.pt_valid[p] and p not in moved]
            if pids:
                pids_arr = np.asarray(pids, np.int64)
                S_old = non_corrected[i]
                S_new_inv = np_sim3_inverse(corrected[i])
                p = arena.pt_pos[pids_arr].astype(np.float64)
                arena.pt_pos[pids_arr] = np_sim3_apply(
                    S_new_inv, np_sim3_apply(S_old, p)
                ).astype(np.float32)
                moved.update(pids)
            arena.kf_pose[i] = np_sim3_to_se3(corrected[i])

        # --- snapshot the PRE-fuse covisibility structure: the essential graph's
        # spanning-tree/covisibility edges must reflect the odometry-time graph,
        # not the fresh cross-loop links fusion is about to create ---
        pre_covis = {
            i: arena.covisibility_counts(i).copy()
            for i in range(n_kfs)
            if arena.kf_valid[i]
        }
        pre_connected = {
            i: set(np.nonzero(c >= cfg.mapping.covisibility_edge_min)[0].tolist())
            for i, c in pre_covis.items()
        }

        # --- fuse loop points into the corrected group (SearchAndFuse :471-499) ---
        loop_pts, loop_desc, loop_ids = self._local_points_of(loop_kf)
        mask = jnp.asarray(loop_ids >= 0)
        n_fused = 0
        for i in group:
            S_iw = corrected[i]
            if self.kf_store is not None:
                self.kf_store.ensure([i], arena)
                idx_dev, valid_dev = self._jit_guided_store(
                    jnp.asarray(np.float32(S_iw["R"])), jnp.asarray(np.float32(S_iw["t"])),
                    jnp.asarray(np.float32(S_iw["s"])),
                    jnp.asarray(loop_pts), jnp.asarray(loop_desc), mask,
                    self.kf_store.packs, self.kf_store.descs, jnp.int32(i),
                    jnp.asarray(arena.kf_feat_valid[i]),
                )
            else:
                idx_dev, valid_dev = self._jit_guided(
                    jnp.asarray(np.float32(S_iw["R"])), jnp.asarray(np.float32(S_iw["t"])),
                    jnp.asarray(np.float32(S_iw["s"])),
                    jnp.asarray(loop_pts), jnp.asarray(loop_desc), mask,
                    jnp.asarray(arena.kf_xy[i]), jnp.asarray(arena.kf_desc[i]),
                    jnp.asarray(arena.kf_feat_valid[i]),
                )
            idx, valid = jax.device_get([idx_dev, valid_dev])
            for p_slot in np.nonzero(valid)[0]:
                loop_pid = int(loop_ids[p_slot])
                feat = int(idx[p_slot])
                if loop_pid < 0 or not arena.pt_valid[loop_pid]:
                    continue
                cur_pid = int(arena.kf_point_idx[i, feat])
                if cur_pid >= 0:
                    if arena.pt_valid[cur_pid] and cur_pid != loop_pid:
                        # loop point wins (loop_closer.cpp:492: Replace with pLoopMP)
                        arena.merge_points(loop_pid, cur_pid)
                        n_fused += 1
                else:
                    arena.associate(i, feat, loop_pid)
                    n_fused += 1

        # --- new cross-loop connections created by fusion (CorrectLoop's
        # LoopConnections map, loop_closer.cpp:633-651) ---
        group_set = set(group)
        loop_connections: dict[int, set] = {}
        for i in group:
            now = set(
                np.nonzero(
                    arena.covisibility_counts(i) >= cfg.mapping.covisibility_edge_min
                )[0].tolist()
            )
            loop_connections[i] = now - pre_connected.get(i, set()) - group_set

        # --- loop edge bookkeeping ---
        S_loop_rel = np_sim3_compose(
            corrected[kf], np_sim3_inverse(np_sim3_from_se3(arena.kf_pose[loop_kf]))
        )  # S_c<-l expressed post-correction
        self.loop_edges.append((loop_kf, kf, S_loop_rel))

        # --- essential graph (optimizer.cpp:718-960) ---
        self._optimize_essential_graph(
            kf, loop_kf, pre_pose, corrected, pre_covis, loop_connections
        )

        # --- follow-up global BA (RunGlobalBundleAdjustment, loop_closer.cpp:73-172):
        # ASYNC like the reference's detached thread — dispatched here, tracking
        # continues, and the result is merged at a later keyframe via
        # apply_pending_gba (spanning-tree-style correction for keyframes/points
        # created while it was in flight). A newer loop closure aborts the
        # in-flight result (the reference's stop_global_bundle_adj_ flag).
        if cfg.loop.run_global_ba:
            self._gba_pending = None  # abort any stale in-flight GBA
            self._dispatch_global_ba()
        self.last_report.update({"fused": n_fused, "group": len(group)})

    # ------------------------------------------------------------------ async global BA

    def _dispatch_global_ba(self) -> None:
        from slam_framework_tpu.optim import global_ba

        arena = self.arena
        n_mesh = self.mesh.devices.size if self.mesh is not None else 1
        if n_mesh > 1:
            self._dispatch_global_ba_sharded(n_mesh)
            return
        prob, cams, pids = global_ba.build_global_problem(arena, self.cfg)
        if self._jit_gba is None:
            self._jit_gba = progcache.shared_jit(
                ("LoopCloser", progcache.config_fingerprint(self.cfg), "gba"),
                lambda: jax.jit(
                    functools.partial(
                        global_ba.optimize_global,
                        K=self.K,
                        iters_first=0,
                        iters_second=self.cfg.loop.global_ba_iters,
                    )
                ),
            )
        res = self._jit_gba(prob)
        self._gba_pending = {
            "res": res,
            "cams": np.asarray(cams),
            "pids": np.asarray(pids),
            "n_kfs": arena.num_kfs,
            "n_pts": arena.num_pts,
        }

    def _dispatch_global_ba_sharded(self, n_shards: int) -> None:
        """Post-loop global BA as ONE SPMD program over the system's mesh
        (the live-system integration of parallel/dist_ba + map_shard):
        points are owner-keyed to covisibility segments
        (map_shard.partition_arena), each shard reduces its landmark blocks
        locally, and the camera system psums over the mesh axis. The dispatch
        is as async as the single-device path — results merge later in
        apply_pending_gba, followed by point-ownership migration."""
        from slam_framework_tpu.optim import global_ba
        from slam_framework_tpu.parallel import dist_ba, map_shard

        arena = self.arena
        prob, cams, pids = global_ba.build_global_problem(arena, self.cfg)
        partition = map_shard.partition_arena(arena, n_shards)
        pids_arr = np.asarray(pids, np.int64)
        owner = partition.owner_of_pt[pids_arr] % n_shards
        owner = np.where(owner >= 0, owner, 0)
        sharded = dist_ba.shard_problem(prob, n_shards, owner=owner)
        res = dist_ba.optimize_global_sharded(
            sharded, self.mesh, self.K,
            iters_first=0, iters_second=self.cfg.loop.global_ba_iters,
        )
        self._gba_pending = {
            "res": res,
            "cams": np.asarray(cams),
            "pids": np.asarray(pids),
            "n_kfs": arena.num_kfs,
            "n_pts": arena.num_pts,
            "owner": owner,
            "n_shards": n_shards,
            "partition": partition,
        }

    def apply_pending_gba(self) -> bool:
        """Merge an in-flight global BA into the (possibly grown) map — the
        reference's RunGlobalBundleAdjustment merge step (loop_closer.cpp:87-171):
        keyframes in the problem adopt the GBA pose; keyframes created while it
        ran are corrected through their strongest covisible parent in the problem
        (spanning-tree child update); points in the problem adopt GBA positions;
        younger points are corrected through their first observing keyframe.
        Returns True if a result was applied."""
        pending = self._gba_pending
        if pending is None:
            return False
        self._gba_pending = None
        arena = self.arena
        res = pending["res"]
        new_cam, new_pt, total_chi2 = jax.device_get(
            [res.cam_pose, res.pt_pos, res.total_chi2]
        )
        cams, pids = pending["cams"], pending["pids"]
        if pending.get("owner") is not None:
            # sharded layout: point at live-rank r sits at shard s_of[r], local
            # slot lp_of[r] — reorder back to rank order before the merge
            from slam_framework_tpu.parallel import dist_ba

            n = pending["n_shards"]
            P_s = new_pt.shape[0] // n
            s_of, lp_of, _ = dist_ba.point_layout(
                len(pids), n, pending["owner"]
            )
            new_pt = np.asarray(new_pt)[s_of * P_s + lp_of]
        cam_rank = {int(c): i for i, c in enumerate(cams)}
        n_now = arena.num_kfs

        # 1. post-GBA pose for every live keyframe
        post = {}
        for c, i in cam_rank.items():
            if arena.kf_valid[c]:
                post[c] = new_cam[i].astype(np.float64)
        in_prob = set(post)
        for c in range(n_now):
            if not arena.kf_valid[c] or c in in_prob:
                continue
            counts = arena.covisibility_counts(c)
            parents = [k for k in np.argsort(-counts) if int(k) in in_prob and counts[k] > 0]
            if not parents:
                continue  # disconnected newborn: leave untouched
            parent = int(parents[0])
            T_rel = arena.kf_pose[c].astype(np.float64) @ np.linalg.inv(
                arena.kf_pose[parent].astype(np.float64)
            )
            post[c] = T_rel @ post[parent]

        # 2. points created after dispatch (or outside the problem): correct
        # through their first observing keyframe's current->post transform.
        # (Uses CURRENT poses as 'pre', so run before the pose write-back.)
        # Vectorized — the scalar loop cost 262k Python iterations per merge at
        # arena capacity.
        post_has = np.zeros(n_now, bool)
        post_pose = np.zeros((n_now, 4, 4), np.float64)
        for c, T in post.items():
            if c < n_now:
                post_has[c] = True
                post_pose[c] = T
        in_prob_pid = np.zeros(arena.num_pts, bool)
        in_prob_pid[pids[pids < arena.num_pts]] = True
        sel = np.nonzero(arena.pt_valid[: arena.num_pts] & ~in_prob_pid)[0]
        k_first = arena.pt_obs_kf[sel, 0]
        ok = (k_first >= 0) & (k_first < n_now) & post_has[np.maximum(k_first, 0)]
        sel, k_first = sel[ok], k_first[ok]
        if len(sel):
            T_pre = arena.kf_pose[k_first].astype(np.float64)   # (n,4,4)
            X = arena.pt_pos[sel].astype(np.float64)
            Xc = np.einsum("nij,nj->ni", T_pre[:, :3, :3], X) + T_pre[:, :3, 3]
            Tp = post_pose[k_first]
            Xw = np.einsum("nji,nj->ni", Tp[:, :3, :3], Xc - Tp[:, :3, 3])
            arena.pt_pos[sel] = Xw.astype(np.float32)

        # 3. problem points adopt GBA positions
        alive = arena.pt_valid[pids]
        arena.pt_pos[pids[alive]] = new_pt[: len(pids)][alive]

        # 4. keyframe poses
        for c, T in post.items():
            arena.kf_pose[c] = T.astype(np.float32)
        self.last_report.update(
            {"gba": {"cams": len(cams), "points": len(pids),
                     "chi2": float(total_chi2), "merged_kfs": len(post) - len(in_prob),
                     "devices": pending.get("n_shards", 1)}}
        )
        if pending.get("partition") is not None:
            self._migrate_after_gba(pending)
        return True

    def _migrate_after_gba(self, pending) -> None:
        """Post-merge point-ownership migration (parallel/map_shard.py step 4,
        wired into the live system): loop fusion moved observations
        across covisibility segments, so ownership is recomputed from the
        POST-merge graph and the moved point rows are re-dealt across the mesh
        with ONE all_to_all (map_shard.migrate_points) — scheduled exactly
        where the async GBA merge lands, never on the per-frame path (the
        reference's analogous merge step: loop_closer.cpp:87-171)."""
        from slam_framework_tpu.optim.global_ba import _next_pow2
        from slam_framework_tpu.parallel import map_shard

        arena = self.arena
        n = pending["n_shards"]
        old = pending["partition"]
        new_part = map_shard.partition_arena(arena, n)
        pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
        report = {"points": int(len(pids)), "moved": 0, "migrated_ok": True}
        if len(pids):
            old_tab = old.owner_of_pt
            in_old = pids < len(old_tab)
            old_owner = np.where(
                in_old, old_tab[np.minimum(pids, len(old_tab) - 1)], -1
            )
            new_owner = (new_part.owner_of_pt[pids] % n).astype(np.int32)
            # rows currently live on their old-owner shard; points born after
            # the old partition start on their new owner (nothing to move)
            cur_owner = np.where(old_owner >= 0, old_owner % n, new_owner)
            moved = cur_owner != new_owner
            report["moved"] = int(moved.sum())
            if moved.any():
                # re-deal only the MOVED (pid, pos) rows; capacity covers the
                # worst of the source and destination shard loads
                mv = np.nonzero(moved)[0]
                src, dst = cur_owner[mv], new_owner[mv]
                load = np.maximum(
                    np.bincount(src, minlength=n), np.bincount(dst, minlength=n)
                )
                R = _next_pow2(int(load.max()))
                rows = np.zeros((n * R, 4), np.float32)
                mask = np.zeros(n * R, bool)
                dest = np.zeros(n * R, np.int32)
                order = np.argsort(src, kind="stable")
                so = src[order]
                local = np.arange(len(mv)) - np.searchsorted(so, so)
                gidx = so * R + local
                rows[gidx, 0] = pids[mv][order].astype(np.float32)
                rows[gidx, 1:4] = arena.pt_pos[pids[mv][order]]
                mask[gidx] = True
                dest[gidx] = dst[order]
                rows2, mask2 = map_shard.migrate_points(self.mesh, rows, mask, dest)
                # verify each live row landed on the shard that now owns it
                got = np.nonzero(mask2)[0]
                landed_shard = got // R
                landed_pid = rows2[got, 0].astype(np.int64)
                owner_tab = np.full(arena.num_pts, -1, np.int32)
                owner_tab[pids] = new_owner
                ok = bool(
                    (owner_tab[landed_pid] == landed_shard).all()
                    and mask2.sum() == mask.sum()
                )
                report["migrated_ok"] = ok
        self.partition = new_part
        report.update(new_part.stats())
        self.last_report["migration"] = report

    # ------------------------------------------------------------------ pose graph

    def _optimize_essential_graph(
        self,
        kf: int,
        loop_kf: int,
        pre_pose: np.ndarray,
        corrected: dict,
        pre_covis: dict,
        loop_connections: dict,
    ) -> None:
        arena = self.arena
        cfg = self.cfg
        n_kfs = arena.num_kfs

        # vertex initial values: corrected Sim3 for the group, current poses otherwise
        V = _next_pow2(max(n_kfs, 2))
        v_R = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
        v_t = np.zeros((V, 3), np.float32)
        v_s = np.ones(V, np.float32)
        v_fixed = np.ones(V, bool)
        v_mask = np.zeros(V, bool)
        pre_sim3 = []
        for i in range(n_kfs):
            S = corrected.get(i)
            if S is None:
                S = np_sim3_from_se3(arena.kf_pose[i])
            pre_sim3.append(S)
            v_R[i] = S["R"]
            v_t[i] = S["t"]
            v_s[i] = S["s"]
            valid = bool(arena.kf_valid[i])
            v_mask[i] = valid
            v_fixed[i] = (i == loop_kf) or not valid

        # Edge construction mirrors optimizer.cpp:756-841:
        #   1. NEW cross-loop connections (LoopConnections) — measurements from the
        #      vertex INITIAL Sim3s (corrected group poses vs. untouched loop-side
        #      poses), so these edges are satisfied at init and anchor the group;
        #   2. spanning tree (strongest earlier covisible, PRE-fuse structure) and
        #      covisibility edges >= minFeat — measurements from PRE-correction
        #      poses (NonCorrectedSim3): the preserved odometry;
        #   3. loop edges from previous closures (KeyFrame::GetLoopEdges).
        e_i: List[int] = []
        e_j: List[int] = []
        e_R: List[np.ndarray] = []
        e_t: List[np.ndarray] = []
        e_s: List[float] = []
        e_w: List[float] = []
        seen = set()

        def add_edge(i: int, j: int, S_ji: dict, w: float = 1.0):
            key = (min(i, j), max(i, j))
            if key in seen or i == j:
                return
            seen.add(key)
            e_i.append(i)
            e_j.append(j)
            e_R.append(np.float32(S_ji["R"]))
            e_t.append(np.float32(S_ji["t"]))
            e_s.append(float(S_ji["s"]))
            e_w.append(w)

        def rel_pre(i: int, j: int) -> dict:
            """S_ji from pre-correction poses."""
            T_ji = pre_pose[j].astype(np.float64) @ np.linalg.inv(pre_pose[i].astype(np.float64))
            return np_sim3_from_se3(T_ji.astype(np.float32))

        def rel_init(i: int, j: int) -> dict:
            """S_ji from the vertex initial values (corrected where applicable)."""
            return np_sim3_compose(pre_sim3[j], np_sim3_inverse(pre_sim3[i]))

        # 1. new cross-loop connections (weight gate except the cur<->loop pair)
        min_feat = cfg.loop.essential_graph_min_feat
        for i, partners in loop_connections.items():
            counts_i = arena.covisibility_counts(i)
            for j in partners:
                j = int(j)
                if j >= n_kfs or not arena.kf_valid[j]:
                    continue
                is_main_pair = {i, j} == {kf, loop_kf}
                if not is_main_pair and counts_i[j] < min_feat:
                    continue
                add_edge(i, j, rel_init(i, j))

        # 2. spanning tree + covisibility edges from the pre-fuse structure
        for i in range(1, n_kfs):
            if not arena.kf_valid[i]:
                continue
            counts = pre_covis.get(i)
            if counts is None:
                continue
            earlier = counts[:i]
            if earlier.size and earlier.max() > 0:
                parent = int(np.argmax(earlier))
                add_edge(i, parent, rel_pre(i, parent))
            strong = np.nonzero(counts >= min_feat)[0]
            for j in strong:
                if j < i:
                    add_edge(i, int(j), rel_pre(i, int(j)))

        # 3. previous loop edges (stored with their at-closure relative Sim3)
        for (a, b, S_ab) in self.loop_edges:
            add_edge(a, b, S_ab)

        E = _next_pow2(max(len(e_i), 2))
        pad = E - len(e_i)
        prob = pose_graph.PoseGraphProblem(
            v_R=jnp.asarray(v_R),
            v_t=jnp.asarray(v_t),
            v_s=jnp.asarray(v_s),
            v_fixed=jnp.asarray(v_fixed),
            v_mask=jnp.asarray(v_mask),
            e_i=jnp.asarray(np.asarray(e_i + [0] * pad, np.int32)),
            e_j=jnp.asarray(np.asarray(e_j + [0] * pad, np.int32)),
            e_R=jnp.asarray(
                np.concatenate([np.stack(e_R), np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
                if e_R else np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
            ),
            e_t=jnp.asarray(np.concatenate([np.stack(e_t), np.zeros((pad, 3), np.float32)]) if e_t else np.zeros((E, 3), np.float32)),
            e_s=jnp.asarray(np.asarray(e_s + [1.0] * pad, np.float32)),
            e_mask=jnp.asarray(np.asarray([True] * len(e_i) + [False] * pad)),
            e_weight=jnp.asarray(np.asarray(e_w + [0.0] * pad, np.float32)),
        )
        res = pose_graph.optimize(prob, iters=cfg.loop.essential_graph_iters)
        v_R2, v_t2, v_s2 = jax.device_get([res.v_R, res.v_t, res.v_s])

        # write back poses + correct every point via its reference keyframe
        # (optimizer.cpp:925-958)
        post_sim3 = [np_sim3(v_R2[i], v_t2[i], v_s2[i]) for i in range(n_kfs)]
        n_pts = arena.num_pts
        ref = arena.pt_obs_kf[:n_pts, 0].copy()
        ref = np.where(ref >= 0, ref, arena.pt_first_kf[:n_pts])
        ok = arena.pt_valid[:n_pts] & (ref >= 0) & (ref < n_kfs)
        for r in np.unique(ref[ok]):
            sel = np.nonzero(ok & (ref == r))[0]
            S_old = pre_sim3[int(r)]
            S_new_inv = np_sim3_inverse(post_sim3[int(r)])
            p = arena.pt_pos[sel].astype(np.float64)
            arena.pt_pos[sel] = np_sim3_apply(
                S_new_inv, np_sim3_apply(S_old, p)
            ).astype(np.float32)
        for i in range(n_kfs):
            if arena.kf_valid[i]:
                arena.kf_pose[i] = np_sim3_to_se3(post_sim3[i])


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p
