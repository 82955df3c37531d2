"""Stereo tracking stage: device-resident state machine + lag-batched host sync.

Replacement for the Tracker thread (reference: src/core/tracker.{h,cpp}):
stereo initialization (:249-295), motion-model tracking (:756-824), local-map tracking
(:1136-1174), keyframe decision (:1229-1309) and creation (:1311-1379), trajectory
bookkeeping (:629-642).

Architecture (differs deliberately from the reference's per-frame mutex dance):
the ENTIRE per-frame computation — ORB front-end, stereo matching, motion-model
association + pose optimization, local-map association + pose optimization, velocity
update, keyframe statistics — is ONE jitted device program `_step` whose tracking
state (last pose/velocity/features/point slots) never leaves the device. The host
reads back only a small per-frame summary, fetched in batches of `sync_every` frames
with one consolidated fetch (per-frame blocking reads would put the host-device
round trip on every frame's critical path).

Consequence: keyframe decisions run `sync_every` frames behind the tracked frame —
the same bounded-staleness the reference accepts by running LocalMapping
asynchronously (SURVEY.md §2.3). Map updates re-enter the device as a refreshed
local point block at each keyframe.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.geometry import se3
from slam_framework_tpu.map.arena import MapArena
from slam_framework_tpu.pipeline import track_ops
from slam_framework_tpu.pipeline.frame import FrameData, StereoFrontend
from slam_framework_tpu.pipeline.local_mapper import LocalMapper
from slam_framework_tpu.utils import progcache
from slam_framework_tpu.utils.observability import MetricsLog, StageTimers, trace_span


class TrackingState(enum.Enum):
    """Mirrors src/util/tracking_state.h."""

    SYSTEM_NOT_READY = 0
    NO_IMAGES_YET = 1
    NOT_INITIALIZED = 2
    OK = 3
    LOST = 4


class DeviceTrackState(NamedTuple):
    """Per-frame tracking state that stays on device across frames."""

    pose: jnp.ndarray        # (4,4) Tcw of last tracked frame
    velocity: jnp.ndarray    # (4,4) T_cur_last motion model
    desc: jnp.ndarray        # (N,8) last frame descriptors
    octave: jnp.ndarray      # (N,) int32
    angle: jnp.ndarray       # (N,) f32
    pt_pos: jnp.ndarray      # (N,3) world position of the point tracked by each feature
    pt_mask: jnp.ndarray     # (N,) bool — feature has a map point
    assoc_slot: jnp.ndarray  # (N,) int32 — local-block slot per feature (-1 none)


# summary layout (f32): [0:16]=pose, [16]=n_matches, [17]=n_inliers,
# [18]=n_close_tracked, [19]=n_close_untracked, [20]=n_valid_feats
SUMMARY_LEN = 24


def _pack_payload(arrays):
    """Concat a list of device arrays into ONE uint32 buffer (bitcast, not
    convert), so the drain payload comes back as a single transfer instead of
    one per leaf (jax.device_get maps leaves to separate gets). Whether this
    pays on the H100 is not measured."""
    parts = []
    for a in arrays:
        if a.dtype == jnp.uint32:
            parts.append(a.ravel())
        elif a.dtype == jnp.bool_:
            parts.append(a.astype(jnp.uint32).ravel())
        elif a.dtype in (jnp.float32, jnp.int32):
            parts.append(jax.lax.bitcast_convert_type(a, jnp.uint32).ravel())
        else:  # f64/i64 results never ride the drain; cast defensively
            parts.append(
                jax.lax.bitcast_convert_type(
                    a.astype(jnp.float32), jnp.uint32
                ).ravel()
            )
    return jnp.concatenate([p.reshape(-1) for p in parts])


def _unpack_payload(buf: np.ndarray, handles) -> list:
    """Split the fetched uint32 buffer back into host arrays matching each
    handle's shape/dtype (numpy views — no copies beyond the bool cast)."""
    out = []
    off = 0
    for h in handles:
        n = int(np.prod(h.shape)) if h.ndim else 1
        seg = buf[off: off + n]
        off += n
        dt = h.dtype
        if dt == jnp.uint32:
            arr = seg
        elif dt == jnp.bool_:
            arr = seg.astype(bool)
        elif dt == jnp.int32:
            arr = seg.view(np.int32)
        else:
            arr = seg.view(np.float32)
        out.append(arr.reshape(h.shape) if h.ndim else arr.reshape(())[()])
    return out


class FrameRecord:
    __slots__ = ["frame_id", "timestamp", "pose", "lost", "ref_kf", "rel_pose"]

    def __init__(self, frame_id, timestamp, pose, lost, ref_kf, rel_pose=None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.pose = pose
        self.lost = lost
        self.ref_kf = ref_kf
        self.rel_pose = rel_pose  # Tcr = Tcw @ Trw^-1 at record time (tracker.cpp:629-642)


class StereoTracker:
    @property
    def MIN_INIT_FEATURES(self) -> int:
        """Stereo init needs > 500 features (tracker.cpp:251) — config-surfaced."""
        return self.cfg.tracker.min_init_features

    @property
    def MIN_INIT_STEREO(self) -> int:
        """...and a healthy number of actual stereo depths — config-surfaced."""
        return self.cfg.tracker.min_init_stereo
    MAX_KFS_PER_CHUNK = 1    # keyframe budget per drained chunk

    def __init__(self, cfg: SlamConfig, arena: Optional[MapArena] = None, sync_every: int = 4,
                 pipeline_depth: int = 2):
        self.cfg = cfg
        self.frontend = self._make_frontend()
        self.K = self.frontend.K
        self.arena = arena or MapArena.create(cfg.capacity, cfg.capacity.max_features)
        self.state = TrackingState.NO_IMAGES_YET
        self.sync_every = max(1, sync_every)
        # Chunks allowed in flight before draining. Depth 2 = classic double
        # buffering: while the host fetches + processes chunk i's results
        # (keyframe creation, mapper bookkeeping), the device computes chunk
        # i+1 — neither side idles. Costs one extra chunk of staleness in the
        # keyframe decision / local-block refresh (bounded-staleness design,
        # module docstring). Depth 1 = the round-1 fully-serial behavior.
        self.pipeline_depth = max(1, pipeline_depth)
        # Historical knob: True serialized the chunk boundary after every
        # keyframe so the rebuilt local block entered tracking fresh, at the
        # cost of one unpipelined chunk per keyframe. The pipelined order —
        # fetch -> process-critical -> dispatch(+remap) -> deferred mapper
        # work — provides the SAME block freshness on every chunk (the remap
        # always precedes the next dispatch), so nothing forces depth 1
        # anymore and this flag is vestigial. Kept for A/B-tool compatibility.
        self.serial_after_keyframe = True
        # Keyframe budget per drained chunk scales with chunk length so the
        # keyframe CADENCE is set in frames (the reference's rule,
        # tracker.cpp:1224-1306), not chunks — a budget of 1 at sync_every=8
        # silently halved the map density (A/B: ATE 0.57 vs 0.37 on the
        # 160-frame bench workload).
        self.max_kfs_per_chunk = max(self.MAX_KFS_PER_CHUNK, round(self.sync_every / 4))
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self.last_kf_frame_id = -1
        self.frame_id = 0
        self.records: list[FrameRecord] = []
        self.metrics = MetricsLog()   # structured per-frame/per-keyframe events
        self.timers = StageTimers()   # per-stage wall clocks (SURVEY.md §5.1)
        self.on_new_keyframe = None  # hook: called with kf id after insertion

        self.local_mapper = LocalMapper(cfg, self.arena, self.K, timers=self.timers)
        self.relocalizer = None       # set by SlamSystem once place recognition exists
        self.localization_only = False  # ActivateLocalizationMode (slam_system.h:38)
        self._last_reloc_fid = -(10**9)  # strict-gate window anchor (tracker.cpp:1166)
        self._dstate: Optional[DeviceTrackState] = None
        self._block = None            # device PointBlock for local-map association
        self._block_ids = None        # (P,) np int32 — global point id per block slot
        self._buf = []                # buffered (left, right, frame_id, ts) awaiting dispatch
        self._pending = []            # [(ids, tss, summaries, packs, descs, vis, found, block_ids)]
        self._pending_remap = None    # block ids awaiting device-state remap
        self._deferred = []           # [(kind, fn)] per-keyframe heavy host work
        #   queued during pipelined _process and executed after the next chunk
        #   dispatches (see _run_deferred) so it overlaps device compute
        # Auxiliary fetch sources (e.g. the loop closer's in-flight BoW
        # transform): objects exposing aux_handles() -> list of device arrays
        # (or None) and aux_deliver(host_arrays). Their results ride the
        # consolidated drain fetch instead of blocking mid-_process behind the
        # in-flight chunk.
        self.aux_fetch: list = []
        self._ph_cache: dict = {}  # zero placeholders for fixed-slot payloads
        # jitted programs are SHARED across same-config tracker instances
        # (utils/progcache.py): they close over config-derived state only, and
        # per-instance jax.jit wrappers forced the bench's timed system (and any
        # multi-sequence deployment) to re-load every heavy executable from the
        # persistent cache
        fp = (type(self).__name__, progcache.config_fingerprint(cfg))
        self._jit_chunk = progcache.shared_jit(
            fp + ("chunk",), lambda: jax.jit(self._chunk)
        )
        self._jit_remap = progcache.shared_jit(
            fp + ("remap",), lambda: jax.jit(self._remap_program)
        )
        self._jit_unpack_block = progcache.shared_jit(
            fp + ("unpack_block",),
            lambda: jax.jit(
                lambda packed, desc: track_ops.PointBlock(
                    pos=packed[:, 0:3], desc=desc, normal=packed[:, 3:6],
                    min_dist=packed[:, 6], max_dist=packed[:, 7],
                    mask=packed[:, 8] > 0.5,
                )
            ),
        )

    def _current_sync(self) -> int:
        """Frames per device dispatch; subclasses shorten it while the map is
        young (mono bootstrap cannot survive a long refresh interval)."""
        return self.sync_every

    MATURE_MAP_KFS = 12  # depth-2 pipelining waits for this many keyframes

    def _current_depth(self) -> int:
        """Pipeline depth: serial (1) while the map is young — a bootstrap-age
        map starves under the extra chunk of local-block staleness (measured:
        LOST within 30 frames at depth 2 from cold start). Mature-map chunks
        always pipeline: the fetch->process-critical->dispatch->deferred order
        applies the post-keyframe remap BEFORE the next chunk dispatches, so
        the rebuilt block enters tracking with the serial path's freshness
        while the heavy per-keyframe host work overlaps device compute."""
        if self.arena.n_valid_kfs < self.MATURE_MAP_KFS:
            return 1
        return self.pipeline_depth

    def _make_frontend(self):
        if self.cfg.sensor == "rgbd":
            from slam_framework_tpu.pipeline.frame import RgbdFrontend

            return RgbdFrontend(self.cfg)
        return StereoFrontend(self.cfg)

    # ------------------------------------------------------------------ device program

    def _chunk(self, state: DeviceTrackState, images, block: track_ops.PointBlock):
        """Run `sync_every` tracked frames in ONE device dispatch via lax.scan.

        images: (K, 2, H, W) uint8. Scanning K frames per dispatch amortizes the
        per-execution host overhead over K frames (its size on the H100 is not
        measured).

        Besides per-frame summaries, the scan accumulates per-block-slot
        visible/found counters (MapPoint::IncreaseVisible/IncreaseFound,
        map_point.cpp:234-247 — the reference updates these EVERY frame; without
        them MapPointCulling's found-ratio is meaningless and the map starves).

        Structure: the ORB front-end (pyramid/FAST/BRIEF/stereo) is independent of
        tracking state, so it runs as its own lax.map phase over the K frames
        ahead of the state-carrying tracking scan (which would false-serialize
        frame i+1's extraction behind frame i's pose optimization). lax.map
        (sequential per-frame kernels) was chosen over vmap (one batched
        program) on an earlier accelerator; the choice is not re-measured on
        the H100."""
        P = block.pos.shape[0]
        zeros = jnp.zeros(P, jnp.int32)

        fds = jax.lax.map(lambda img: self.frontend._process(img[0], img[1]), images)

        def body(carry, fd):
            st, vis_acc, found_acc = carry
            st2, summary, pack, desc, vis, found = self._track_core(st, fd, block)
            return (st2, vis_acc + vis, found_acc + found), (summary, pack, desc)

        (state, vis, found), (summaries, packs, descs) = jax.lax.scan(
            body, (state, zeros, zeros), fds
        )
        return state, summaries, packs, descs, vis, found

    def _step_core(self, state: DeviceTrackState, left, right, block: track_ops.PointBlock):
        fd = self.frontend._process(left, right)
        return self._track_core(state, fd, block)

    def _track_core(self, state: DeviceTrackState, fd: FrameData, block: track_ops.PointBlock):
        cfg = self.cfg
        pred = se3.compose(state.velocity, state.pose)

        res1 = track_ops.track_motion(
            fd, pred, state.pt_pos, state.desc, state.octave, state.angle,
            state.pt_mask, K=self.K,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor,
        )
        # carry block slots through the motion association
        ok1 = (res1.assoc >= 0) & res1.inlier
        prior_motion = jnp.where(ok1, state.assoc_slot[jnp.maximum(res1.assoc, 0)], -1)

        # TrackReferenceKeyFrame ladder (tracker.cpp:486-540): when motion-model
        # tracking collapses (velocity jerk — the projection windows miss), fall
        # back to GLOBAL descriptor matching against the local block seeded from
        # the last pose. lax.cond keeps the fallback off the hot path.
        def _motion_path(_):
            return res1.pose, prior_motion

        def _reference_path(_):
            fb = track_ops.track_reference_fallback(fd, state.pose, block, K=self.K)
            prior_fb = jnp.where((fb.assoc >= 0) & fb.inlier, fb.assoc, -1)
            # adopt the fallback only when it locked on BETTER than the motion
            # path (reference requires >= 10 inliers, tracker.cpp:693); a weak
            # motion lock can be a false consensus of window-gated chance
            # matches (measured: a 4 m prediction error on self-similar texture
            # still leaves ~36 chi2-consistent matches), so the arbiter is
            # inlier count, not a fixed accept bar
            good = (fb.n_inliers >= 10) & (fb.n_inliers > res1.n_inliers)
            return (
                jnp.where(good, fb.pose, res1.pose),
                jnp.where(good, prior_fb, prior_motion),
            )

        # Run the fallback ladder whenever the motion lock is WEAK (< 60
        # inliers), not only when it is dead (< 15): both branches of the cond
        # are compiled once, only the taken branch executes, so the global
        # rescue costs nothing on healthy frames (200-350 inliers) and one
        # extra Hamming+pose-opt on weak ones — unlike the reference's CPU
        # ladder (tracker.cpp:486-540), which must choose one path up front.
        pose1, prior = jax.lax.cond(
            res1.n_inliers >= 60, _motion_path, _reference_path, None
        )

        # th=2: the block refreshes one chunk late (bounded staleness), so point
        # positions lag BA refinement by a few frames — the wider window recovers
        # the associations the reference finds with th=1 and a fresh map
        # (measured: 2x radius ~doubles matches on the KITTI-geometry bench)
        res2 = track_ops.track_local_map(
            fd, pose1, prior, block, K=self.K, th=2.0,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor,
            image_wh=(cfg.camera.width, cfg.camera.height),
        )
        ok2 = (res2.assoc >= 0) & res2.inlier
        slot = jnp.where(ok2, res2.assoc, -1)

        vel_full = se3.compose(res2.pose, se3.se3_inverse(state.pose))
        # IIR-smoothed rotation rate (config.py velocity_rotation_smoothing):
        # unbiased on sustained turns, contractive on the chunked-lag feedback
        a = cfg.tracker.velocity_rotation_smoothing
        w_meas = se3.so3_log(vel_full[:3, :3])
        w_prev = se3.so3_log(state.velocity[:3, :3])
        velocity = se3.rt_to_mat(
            se3.so3_exp((1.0 - a) * w_meas + a * w_prev), vel_full[:3, 3]
        )
        new_state = DeviceTrackState(
            pose=res2.pose,
            velocity=velocity,
            desc=fd.desc,
            octave=fd.octave,
            angle=fd.angle,
            pt_pos=block.pos[jnp.maximum(slot, 0)],
            pt_mask=slot >= 0,
            assoc_slot=slot,
        )

        close = (fd.depth > 0) & (fd.depth < cfg.depth_threshold) & fd.valid
        summary = jnp.zeros(SUMMARY_LEN, jnp.float32)
        summary = summary.at[0:16].set(res2.pose.reshape(-1))
        summary = summary.at[16].set(res2.n_matches.astype(jnp.float32))
        summary = summary.at[17].set(res2.n_inliers.astype(jnp.float32))
        summary = summary.at[18].set(jnp.sum((close & (slot >= 0)).astype(jnp.int32)).astype(jnp.float32))
        summary = summary.at[19].set(jnp.sum((close & (slot < 0)).astype(jnp.int32)).astype(jnp.float32))
        summary = summary.at[20].set(jnp.sum(fd.valid.astype(jnp.int32)).astype(jnp.float32))
        summary = summary.at[21].set(jnp.sum(res2.visible.astype(jnp.int32)).astype(jnp.float32))
        summary = summary.at[22].set(res1.n_inliers.astype(jnp.float32))

        # duplicate-suppression: existing block point each unassociated feature
        # re-detects (OrbMatcher::Fuse semantics) — used at keyframe creation
        fuse = track_ops.fuse_candidates(
            fd, res2.pose, slot, block, K=self.K,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor,
            image_wh=(cfg.camera.width, cfg.camera.height),
        )

        # per-frame pack for (rare) keyframe creation: one f32 + one u32 fetch
        pack = jnp.stack(
            [
                fd.xy[:, 0], fd.xy[:, 1], fd.u_right, fd.depth,
                fd.octave.astype(jnp.float32), fd.angle,
                fd.valid.astype(jnp.float32), slot.astype(jnp.float32),
                fuse.astype(jnp.float32),
            ],
            axis=-1,
        )
        # per-slot visible/found increments for this frame
        P = block.pos.shape[0]
        vis = res2.visible.astype(jnp.int32)
        found_idx = jnp.where(ok2, slot, P)  # out-of-range rows dropped
        found = (
            jnp.zeros(P + 1, jnp.int32).at[found_idx].add(1, mode="drop")[:P]
        )
        return new_state, summary, pack, fd.desc, vis, found

    # ------------------------------------------------------------------ main entry

    def track(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        """Feed one stereo pair (or gray+depth in RGB-D mode) from HOST arrays.
        Returns the latest SYNCED pose (lags sync_every frames) or None before
        initialization. Call flush() to drain at end."""
        if self.cfg.sensor == "rgbd":
            # gray (uint8) and depth (float) must share a dtype to stack per chunk
            left = np.asarray(left, np.float32)
            right = np.asarray(right, np.float32)
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            ok = self._initialize(left, right, timestamp)
            self.state = TrackingState.OK if ok else TrackingState.NOT_INITIALIZED
            self.frame_id += 1
            return self.records[-1].pose if ok else None

        if self.state == TrackingState.LOST:
            self._track_lost(left, right, timestamp)
            self.frame_id += 1
            return self.records[-1].pose if self.records else None

        # Upload NOW (async device_put): spreading the per-frame transfers across
        # the inter-frame gaps overlaps them with the in-flight chunk's compute
        # instead of serializing them inside _dispatch.
        pair = jax.device_put(
            jnp.stack([jnp.asarray(left), jnp.asarray(right)])
        )
        return self.track_device(pair, timestamp)

    def track_device(self, pair: jnp.ndarray, timestamp: float) -> Optional[np.ndarray]:
        """Feed one stereo pair already resident on device: (2, H, W) array.

        This is the production ingestion path — a deployment streams sensor
        frames into device memory ahead of compute (prefetch ring), the same way
        the reference's frames sit in host RAM before TrackStereo (the reference
        times tracking with imread outside the clock, main_stereo.cpp:102-130).
        """
        if self.state in (
            TrackingState.NO_IMAGES_YET,
            TrackingState.NOT_INITIALIZED,
            TrackingState.LOST,
        ):
            # init / relocalization paths need host pixels rarely; fetch once
            l, r = np.asarray(pair[0]), np.asarray(pair[1])
            return self.track(l, r, timestamp)

        self._buf.append((pair, None, self.frame_id, timestamp))
        self.frame_id += 1
        if len(self._buf) >= self._current_sync():
            if self._current_depth() > 1 and not self._pending:
                # prime the pipeline: first chunk rides while the next buffers
                with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                    self._dispatch()
            elif self._current_depth() > 1:
                # Fetch -> process-critical -> dispatch -> process-deferred:
                # block on chunk i's results, run the bookkeeping the next
                # chunk DEPENDS on (records, mapper write-backs, keyframe
                # insertion, local-block rebuild — heavy per-keyframe work is
                # queued into self._deferred instead), enqueue chunk i+1 WITH
                # the remap (the block enters tracking with serial-path
                # freshness — pipelining the remap across the boundary was
                # measured to starve tracking, inliers 467->98), then run the
                # deferred mapper work (culling, triangulation/fusion/BA
                # dispatch, stat refresh) while chunk i+1 computes on device.
                with self.timers.time("drain"), trace_span("tracker/fetch"):
                    raw = self._fetch()
                with self.timers.time("process"), trace_span("tracker/process"):
                    self._process(raw, defer=True)
                if self._buf:  # _process clears the buffer on tracking loss
                    with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                        self._dispatch()
                with self.timers.time("process/deferred"), trace_span("tracker/deferred"):
                    self._run_deferred()
            else:
                with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                    self._dispatch()
                while self._pending:
                    with self.timers.time("drain"), trace_span("tracker/drain"):
                        self._drain()
        return self.records[-1].pose if self.records else None

    def flush(self) -> None:
        """Process all buffered/pending frames (end of sequence or map queries).

        Tail frames dispatch ONE AT A TIME through the fixed (1, P) chunk
        shape: stacking the remainder as a (len(buf), P) chunk would compile
        (or cache-load) a distinct heavy program per possible remainder."""
        rest = self._buf
        self._buf = []
        for item in rest:
            self._buf = [item]
            with self.timers.time("dispatch"):
                self._dispatch()
            while self._pending:
                with self.timers.time("drain"):
                    self._drain()
        while self._pending:
            with self.timers.time("drain"):
                self._drain()
        self.local_mapper.finalize()

    def _dispatch(self) -> None:
        if self._pending_remap is not None:
            # deferred from keyframe creation: by now the in-flight chunk has
            # landed, so the state fetch does not stall the pipeline
            with self.timers.time("dispatch/remap"):
                self._remap_device_state(self._pending_remap)
            self._pending_remap = None
        batch = self._buf
        self._buf = []
        with self.timers.time("dispatch/stack"):
            images = jnp.stack([b[0] for b in batch])  # (K,2,H,W), on device
        with self.timers.time("dispatch/enqueue"):
            st, summaries, packs, descs, vis, found = self._jit_chunk(
                self._dstate, images, self._block
            )
        self._dstate = st
        self._pending.append(
            (
                [b[2] for b in batch], [b[3] for b in batch],
                summaries, packs, descs, vis, found, self._block_ids,
            )
        )

    # ------------------------------------------------------------------ host sync

    def _drain(self) -> None:
        self._process(self._fetch())

    def _run_deferred(self) -> None:
        """Execute queued per-keyframe heavy work (see _process defer=True).
        Every keyframe's local BA dispatches; the multi-slot BA pending list
        lands all of them (FIFO) at the next drain fetch."""
        q, self._deferred = self._deferred, []
        for _kind, fn in q:
            fn()

    def _fetch(self):
        """Blocking fetch of the OLDEST in-flight chunk's results — ONE transfer:
        summaries + per-frame packs/descs (so keyframe creation never fetches)
        + the in-flight local-BA / triangulation / fusion results dispatched at
        the previous keyframe. The whole payload is < 1 MB."""
        if self._deferred:
            # safety net for path transitions (pipelined -> flush/serial): the
            # mapper dispatches queued by the previous chunk must exist before
            # this fetch packs their handles
            self._run_deferred()
        fids, tss, summaries_dev, packs_dev, descs_dev, vis_dev, found_dev, block_ids = (
            self._pending.pop(0)
        )
        # packs/descs (the per-frame feature tables, ~140 KB/frame) ride the
        # consolidated fetch even though only keyframe-promoted frames need
        # host copies: this fetch runs against a SETTLED queue (the probe just
        # drained it), whereas fetching per-keyframe inside _create_keyframe
        # blocks behind the just-dispatched next chunk.
        fetch = [summaries_dev, vis_dev, found_dev, packs_dev, descs_dev]
        ba_handles = self.local_mapper.ba_handles()
        tri_handles = self.local_mapper.tri_handles() or []
        fuse_handles = self.local_mapper.fuse_handles() or []
        aux_handles = [src.aux_handles() for src in self.aux_fetch]

        # Fixed-slot composition: absent/short components are padded with
        # cached zero placeholders so the packed-payload program keeps ONE
        # compiled signature per chunk shape (each new signature costs a
        # compile, once per persistent-cache lifetime). The padding costs
        # bytes (~100-350 KB) but no extra transfers.
        cap = self.cfg.capacity
        Fn = self.arena.kf_xy.shape[1]
        Nn = self.cfg.mapping.triangulation_neighbors
        slots = self.max_kfs_per_chunk
        k_ba = 0 if ba_handles is None else len(ba_handles) // 4
        k_tri = len(tri_handles) // 4
        k_fuse = len(fuse_handles)
        pad_ok = k_ba <= slots and k_tri <= slots and k_fuse <= slots
        if pad_ok:
            if ba_handles is not None:
                fetch += ba_handles
            for _ in range(slots - k_ba):
                fetch += (
                    self._ph((cap.ba_cams, 4, 4), np.float32)
                    + self._ph((cap.ba_points, 3), np.float32)
                    + self._ph((cap.ba_obs,), np.bool_)
                    + self._ph((), np.float32)
                )
            fetch += tri_handles
            for _ in range(slots - k_tri):
                fetch += (
                    self._ph((Fn,), np.int32) + self._ph((Fn,), np.int32)
                    + self._ph((Fn, 3), np.float32) + self._ph((Fn,), np.bool_)
                )
            fetch += fuse_handles
            for _ in range(slots - k_fuse):
                fetch += self._ph((Nn, Fn), np.int32)
            for src, h in zip(self.aux_fetch, aux_handles):
                if h:
                    fetch += h
                else:
                    tmpl = getattr(src, "aux_templates", lambda: [])()
                    for shape, dtype in tmpl:
                        fetch += self._ph(tuple(shape), dtype)
        else:  # overfull pendings: variable composition, compiles once
            if ba_handles is not None:
                fetch += ba_handles
            fetch += tri_handles + fuse_handles
            for h in aux_handles:
                if h:
                    fetch += h

        fetched = self._fetch_arrays(fetch)
        summaries, vis, found, packs, descs = fetched[:5]
        rest = fetched[5:]

        def take(n_real: int, n_padded: int):
            nonlocal rest
            vals, rest = rest[:n_real], rest[n_padded:]
            return vals

        if pad_ok:
            ba_data = take(4 * k_ba, 4 * slots)
            tri_data = take(4 * k_tri, 4 * slots)
            fuse_data = take(k_fuse, slots)
            for src, h in zip(self.aux_fetch, aux_handles):
                if h:
                    src.aux_deliver(take(len(h), len(h)))
                else:
                    tmpl = getattr(src, "aux_templates", lambda: [])()
                    take(0, len(tmpl))
        else:
            ba_data = take(4 * k_ba, 4 * k_ba) if ba_handles is not None else None
            tri_data = take(4 * k_tri, 4 * k_tri)
            fuse_data = take(k_fuse, k_fuse)
            for src, h in zip(self.aux_fetch, aux_handles):
                if h:
                    src.aux_deliver(take(len(h), len(h)))
        ba_data = ba_data or None
        tri_data = tri_data or None
        fuse_data = fuse_data or None
        return (fids, tss, summaries, vis, found, packs, descs, block_ids,
                ba_data, tri_data, fuse_data, packs_dev, descs_dev)

    def _ph(self, shape, dtype) -> list:
        """Cached zero placeholder device array for fixed-slot payload padding."""
        key = (shape, np.dtype(dtype).str)
        buf = self._ph_cache.get(key)
        if buf is None:
            buf = jnp.zeros(shape, dtype)
            self._ph_cache[key] = buf
        return [buf]

    def _fetch_arrays(self, handles: list) -> list:
        """Blocking fetch of a list of device arrays as ONE transfer: a tiny
        jitted program bitcast-concats everything into a single uint32 buffer
        (see _pack_payload). Falls back to per-array gets when the handles
        span devices (multi-device mapper offload)."""
        devs = set()
        for h in handles:
            try:
                devs |= h.devices()
            except Exception:
                devs.add(object())  # unknown placement: force fallback
        if len(devs) == 1:
            sig = tuple((tuple(h.shape), str(h.dtype)) for h in handles)
            packer = progcache.shared_jit(
                ("payload_pack", sig), lambda: jax.jit(_pack_payload)
            )
            buf_dev = packer(handles)
            with self.timers.time("drain/queue_wait"):
                # 1-element probe of the packer output (the last-enqueued
                # program by construction): splits device-wait from transfer
                jax.device_get(buf_dev[:1])
            with self.timers.time("drain/device_get"):
                buf = jax.device_get(buf_dev)
            return _unpack_payload(buf, handles)
        with self.timers.time("drain/queue_wait"):
            probes = [jax.tree_util.tree_leaves(handles[0])[-1].ravel()[:1]]
            if len(handles) > 5:
                probes.append(jax.tree_util.tree_leaves(handles[-1])[-1].ravel()[:1])
            jax.device_get(probes)
        with self.timers.time("drain/device_get"):
            return jax.device_get(handles)

    def _process(self, raw, defer: bool = False) -> None:
        """Host-side bookkeeping for one fetched chunk: records, lost detection,
        keyframe decision/creation, visible/found accrual, mapper result landing.

        defer=True (the pipelined path) queues each keyframe's heavy host work
        (point-stat refresh, culling, triangulation/fusion/local-BA dispatch)
        into self._deferred instead of running it inline; the caller runs the
        queue AFTER dispatching the next chunk, so that host work overlaps
        device compute (the reference's separate mapping thread,
        local_mapper.cpp:27-87). Everything the next chunk depends on — BA/tri/
        fuse write-backs, arena insertion, the local-block rebuild + remap —
        still happens here, before the next dispatch."""
        (fids, tss, summaries, vis, found, packs, descs, block_ids,
         ba_data, tri_data, fuse_data, packs_dev, descs_dev) = raw
        made_kf = 0
        # per-frame visible/found accrual (map_point.cpp:234-247) against the
        # block layout the chunk was DISPATCHED with
        live = block_ids >= 0
        pids = block_ids[live]
        ok_pid = self.arena.pt_valid[pids]
        self.arena.pt_n_visible[pids[ok_pid]] += vis[live][ok_pid]
        self.arena.pt_n_found[pids[ok_pid]] += found[live][ok_pid]
        made_kf = False
        for j, (fid, ts) in enumerate(zip(fids, tss)):
            if self.state == TrackingState.LOST:
                # frames after a lost frame were tracked from garbage device state;
                # they are unusable (the reference's caller thread simply stops
                # producing usable poses until relocalization, tracker.cpp:826)
                self.records.append(FrameRecord(fid, ts, None, True, self.ref_kf))
                continue
            s = summaries[j]
            pose = s[0:16].reshape(4, 4).astype(np.float32)
            n_inliers = int(s[17])
            # TrackLocalMap acceptance (tracker.cpp:1166-1174): >= 30 inliers,
            # >= 50 within max_frames_ of a relocalization. Both bars are
            # calibrated to the reference's 2000-feature frames; at lower
            # budgets the same pose quality yields proportionally fewer
            # inliers, so they scale with the budget (exact parity at 2000) —
            # measured at 800 feats: healthy marginal-texture tracking holds
            # 29-50 inliers and the unscaled bars re-lose it.
            nf_scale = self.cfg.orb.num_features / 2000.0
            min_inl = max(
                15, round(self.cfg.tracker.track_local_map_min_inliers * nf_scale)
            )
            if fid - self._last_reloc_fid < self.cfg.max_frames_between_kfs:
                min_inl = max(
                    min_inl,
                    round(
                        self.cfg.tracker.track_local_map_min_inliers_reloc
                        * nf_scale
                    ),
                )
            lost = n_inliers < min_inl
            if lost:
                self.state = TrackingState.LOST
                rec = FrameRecord(fid, ts, None, True, self.ref_kf)
                self.metrics.add(event="frame", frame_id=fid, lost=True,
                                 matches=int(s[16]), inliers=n_inliers)
            else:
                self.state = TrackingState.OK
                rec = FrameRecord(fid, ts, pose, False, self.ref_kf)
                self.metrics.add(event="frame", frame_id=fid,
                                 matches=int(s[16]), inliers=n_inliers,
                                 visible=int(s[21]), motion_inliers=int(s[22]),
                                 close_tracked=int(s[18]), close_new=int(s[19]))
                if (
                    made_kf < self.max_kfs_per_chunk
                    and not self.localization_only
                    and self._need_new_keyframe(fid, s)
                ):
                    self._create_keyframe(
                        fid, ts, pose, packs[j], descs[j], block_ids,
                        ba_data=ba_data, tri_data=tri_data, fuse_data=fuse_data,
                        pack_dev=packs_dev[j], desc_dev=descs_dev[j], defer=defer,
                    )
                    ba_data = tri_data = fuse_data = None  # consumed
                    rec.ref_kf = self.ref_kf
                    made_kf += 1
                rec.rel_pose = self._rel_to_ref(pose, rec.ref_kf)
            self.records.append(rec)
        if fuse_data is not None or tri_data is not None or ba_data is not None:
            # no keyframe this chunk: still land the fetched fuse /
            # triangulation / local-BA results (never let a settled result sit
            # stale across chunks; local_mapper.cpp:27-87 applies each BA
            # before taking the next keyframe). Nothing rebuilds the local
            # block before the next keyframe's critical phase, so on the
            # pipelined path these host write-backs defer past the next
            # dispatch and overlap device compute.
            def _land_pendings(_fd=fuse_data, _td=tri_data, _bd=ba_data) -> None:
                if _fd is not None:
                    self.local_mapper.apply_pending_fuse(prefetched=_fd)
                if _td is not None:
                    self.local_mapper.apply_pending_triangulation(prefetched=_td)
                if _bd is not None:
                    self.local_mapper.flush_ba(prefetched=_bd)

            if defer:
                self._deferred.append(("writeback", _land_pendings))
            else:
                _land_pendings()
        if self.state == TrackingState.LOST:
            # drop buffered/pending work — it descends from the lost state
            for (ids, tss2, *_rest) in self._pending:
                for fid2, ts2 in zip(ids, tss2):
                    self.records.append(FrameRecord(fid2, ts2, None, True, self.ref_kf))
            self._pending = []
            for (_l, _r, fid2, ts2) in self._buf:
                self.records.append(FrameRecord(fid2, ts2, None, True, self.ref_kf))
            self._buf = []

    # ------------------------------------------------------------------ relocalization

    def _track_lost(self, left, right, timestamp) -> None:
        """Relocalization attempt for one frame (Tracker::Relocalization path,
        tracker.cpp:826-991). On success the device state is re-seeded and normal
        chunked tracking resumes."""
        fd = self.frontend(jnp.asarray(left), jnp.asarray(right))
        host = jax.device_get(
            {
                "xy": fd.xy, "desc": fd.desc, "valid": fd.valid,
                "octave": fd.octave, "angle": fd.angle, "u_right": fd.u_right,
            }
        )
        res = self.relocalizer.try_relocalize(host) if self.relocalizer else None
        if res is None:
            self.records.append(
                FrameRecord(self.frame_id, timestamp, None, True, self.ref_kf)
            )
            return
        self.state = TrackingState.OK
        self.ref_kf = res.kf
        self._last_reloc_fid = self.frame_id
        self._pending_remap = None  # state is re-seeded below against the new block
        self._rebuild_block()
        N = host["desc"].shape[0]
        point_ids = np.full(N, -1, np.int32)
        point_ids[res.feat_idx] = res.point_ids
        slot = self._ids_to_slots(point_ids)
        self._dstate = DeviceTrackState(
            pose=jnp.asarray(res.pose),
            velocity=jnp.eye(4, dtype=jnp.float32),
            desc=jnp.asarray(host["desc"]),
            octave=jnp.asarray(host["octave"].astype(np.int32)),
            angle=jnp.asarray(host["angle"]),
            pt_pos=jnp.asarray(self._block_pos_for_slots(slot)),
            pt_mask=jnp.asarray(slot >= 0),
            assoc_slot=jnp.asarray(slot),
        )
        self.records.append(
            FrameRecord(self.frame_id, timestamp, res.pose, False, res.kf,
                        self._rel_to_ref(res.pose, res.kf))
        )
        self.metrics.add(event="frame", frame_id=self.frame_id,
                         matches=res.n_inliers, inliers=res.n_inliers,
                         relocalized=True)

    def _need_new_keyframe(self, fid: int, s: np.ndarray) -> bool:
        """NeedNewKeyFrame (tracker.cpp:1229-1309) from the device summary."""
        cfg = self.cfg
        n_inliers = int(s[17])
        if n_inliers < 15:
            return False
        frames_since = fid - self.last_kf_frame_id
        tracked_close = int(s[18])
        untracked_close = int(s[19])
        need_close = tracked_close < 100 and untracked_close > 70
        ref_ratio = 0.75 if self.arena.n_valid_kfs > 2 else 0.4
        # reference compares against ref-KF map points with >= 3 observations
        # (KeyFrame::TrackedMapPoints, tracker.cpp:1262-1264), not all associations
        ref_strong = self._ref_kf_tracked_strong()
        under_ratio = n_inliers < ref_strong * ref_ratio
        overdue = frames_since >= cfg.max_frames_between_kfs
        decision = overdue or (
            (under_ratio or need_close)
            and frames_since >= max(cfg.min_frames_between_kfs, 1)
            and n_inliers > 15
        )
        if decision:
            self.metrics.add(
                event="kf_decision", frame_id=fid, overdue=overdue,
                under_ratio=under_ratio, need_close=need_close,
                inliers=n_inliers, ref_strong=ref_strong,
                close_tracked=tracked_close, close_new=untracked_close,
            )
        return decision

    # ------------------------------------------------------------------ init / keyframes

    def _initialize(self, left, right, timestamp) -> bool:
        """StereoInitialization (tracker.cpp:249-295): first KF + a point per stereo
        feature; builds the initial device state + local block."""
        fd = self.frontend(jnp.asarray(left), jnp.asarray(right))
        host = jax.device_get(
            {
                "xy": fd.xy, "angle": fd.angle, "octave": fd.octave,
                "desc": fd.desc, "valid": fd.valid, "u_right": fd.u_right,
                "depth": fd.depth,
            }
        )
        has_depth = (host["depth"] > 0) & host["valid"]
        if host["valid"].sum() < self.MIN_INIT_FEATURES or has_depth.sum() < self.MIN_INIT_STEREO:
            return False
        pose = np.eye(4, dtype=np.float32)
        n = len(host["depth"])
        point_ids = np.full(n, -1, np.int32)
        kf = self.arena.add_keyframe(
            pose, self.frame_id, timestamp,
            host["xy"], host["u_right"], host["depth"],
            host["octave"].astype(np.int16), host["angle"], host["desc"],
            host["valid"], point_ids.copy(),
        )
        idx = np.nonzero(has_depth)[0]
        pids = self._create_points_from_stereo(kf, idx, pose, host["xy"], host["depth"], host["octave"], host["desc"])
        point_ids[idx] = pids
        self.local_mapper.note_new_points(pids, kf)
        self.arena.kf_point_idx[kf, :n] = point_ids
        self._rebuild_block()
        slot = self._ids_to_slots(point_ids)
        self._dstate = DeviceTrackState(
            pose=jnp.asarray(pose),
            velocity=jnp.eye(4, dtype=jnp.float32),
            desc=jnp.asarray(host["desc"]),
            octave=jnp.asarray(host["octave"].astype(np.int32)),
            angle=jnp.asarray(host["angle"]),
            pt_pos=jnp.asarray(self._block_pos_for_slots(slot)),
            pt_mask=jnp.asarray(slot >= 0),
            assoc_slot=jnp.asarray(slot),
        )
        rec = FrameRecord(self.frame_id, timestamp, pose, False, kf,
                          np.eye(4, dtype=np.float64))
        self.records.append(rec)
        self.ref_kf = kf
        self.ref_kf_tracked = int(has_depth.sum())
        self.last_kf_frame_id = self.frame_id
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)
        return True

    def _create_points_from_stereo(self, kf, feat_idx, pose, xy, depth, octave, desc) -> np.ndarray:
        """Vectorized point creation from stereo depth (tracker.cpp:262-283)."""
        arena = self.arena
        cfg = self.cfg
        z = depth[feat_idx]
        u = xy[feat_idx, 0]
        v = xy[feat_idx, 1]
        x = (u - self.K.cx) * z / self.K.fx
        y = (v - self.K.cy) * z / self.K.fy
        Twc = np.linalg.inv(pose)
        pos = (Twc[:3, :3] @ np.stack([x, y, z], 0)).T + Twc[:3, 3]
        center = Twc[:3, 3]
        delta = pos - center
        dist = np.linalg.norm(delta, axis=1)
        sf = cfg.orb.scale_factor
        max_dist = dist * (sf ** octave[feat_idx].astype(np.float32))
        min_dist = max_dist / (sf ** (cfg.orb.num_levels - 1))
        pids = arena.add_points(
            pos, desc[feat_idx], kf, delta / np.maximum(dist, 1e-9)[:, None],
            min_dist, max_dist,
        )
        arena.associate_batch(kf, np.asarray(feat_idx), pids)
        return pids

    def _ref_kf_tracked_strong(self) -> int:
        """Number of reference-KF map points with >= min_obs observations
        (KeyFrame::TrackedMapPoints(3), keyframe.cpp:416-435)."""
        if self.ref_kf < 0:
            return 0
        arena = self.arena
        min_obs = 3 if arena.n_valid_kfs > 2 else 2
        pids = arena.kf_point_idx[self.ref_kf]
        pids = pids[pids >= 0]
        if len(pids) == 0:
            return 0
        return int((arena.pt_valid[pids] & (arena.pt_obs_count[pids] >= min_obs)).sum())

    def _create_keyframe(self, fid, ts, pose, pack, desc, block_ids=None,
                         ba_data=None, tri_data=None, fuse_data=None,
                         pack_dev=None, desc_dev=None, defer=False) -> int:
        """CreateNewKeyFrame (tracker.cpp:1311-1379) for a (lag-synced) frame.

        pack/desc are HOST arrays (fetched by _drain's consolidated fetch), as are
        the optional prefetched BA / triangulation results — this path performs
        no blocking device round-trips; everything it dispatches (triangulation,
        local BA) is consumed at the NEXT drain.

        block_ids: the point-id layout of the block this frame's chunk was
        DISPATCHED with (pack slot indices refer to it; self._block_ids may
        already be newer if an earlier frame of the same chunk made a keyframe)."""
        arena = self.arena
        cfg = self.cfg
        if block_ids is None:
            block_ids = self._block_ids
        if isinstance(pack, jnp.ndarray):
            if pack_dev is None:
                pack_dev, desc_dev = pack, desc  # already device-resident
            pack, desc = jax.device_get([pack, desc])  # direct callers (reloc/mono)
        xy = pack[:, 0:2]
        u_right = pack[:, 2]
        depth = pack[:, 3]
        octave = pack[:, 4].astype(np.int16)
        angle = pack[:, 5]
        valid = pack[:, 6] > 0.5
        slot = pack[:, 7].astype(np.int32)
        fuse = pack[:, 8].astype(np.int32)
        # fuse re-detections into existing points before considering new ones
        slot = np.where(slot >= 0, slot, fuse)
        point_ids = np.where(slot >= 0, block_ids[np.maximum(slot, 0)], -1).astype(np.int32)
        point_ids[point_ids >= 0] = np.where(
            arena.pt_valid[point_ids[point_ids >= 0]], point_ids[point_ids >= 0], -1
        )
        kf = arena.add_keyframe(
            pose, fid, ts, xy, u_right, depth, octave, angle, desc, valid,
            point_ids.copy(),
        )
        if pack_dev is not None:
            # device-to-device copy of the chunk's feature block into the
            # keyframe store — the mapper/loop programs gather it by index
            self.local_mapper.kf_store.set_from_device(kf, pack_dev, desc_dev)
        # New points from stereo depth, the reference's rule (tracker.cpp:1340-1373):
        # every unassociated CLOSE feature (depth < threshold) becomes a point, and
        # if that yields < 100 the nearest far ones pad up to 100. Far single-view
        # stereo depth is noisy (sigma_z ~ z^2/bf); flooding the map with one-view
        # far points crowds BA-refined geometry out of the fixed-capacity local
        # block and erodes tracking (measured: inliers 890 -> lost in 40 frames on
        # the r3 bench when creating ALL depths). Far geometry comes from the
        # mapper's multi-view triangulation instead (local_mapper.cpp:258-492).
        cand = np.nonzero((depth > 0) & valid & (point_ids < 0))[0]
        cand = cand[np.argsort(depth[cand], kind="stable")]
        n_close = int((depth[cand] < cfg.depth_threshold).sum())
        cand = cand[: max(n_close, 100)]
        if len(cand):
            pids = self._create_points_from_stereo(kf, cand, pose, xy, depth, octave, desc)
            point_ids[cand] = pids
            self.local_mapper.note_new_points(pids, kf)
        arena.kf_point_idx[kf] = point_ids
        # (found/visible counters accrue per-frame from the chunk accumulators)
        seen = point_ids[point_ids >= 0]
        # stat refresh stays on the critical path: the block rebuild below
        # selects points by the refreshed descriptors/normals, and deferring it
        # measurably raised post-loop ATE (0.502 -> 0.536 on the circle e2e)
        self._update_point_stats(seen)
        self.ref_kf = kf
        self.ref_kf_tracked = int((point_ids >= 0).sum())
        self.last_kf_frame_id = fid
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)
        with self.timers.time("keyframe"), trace_span("tracker/keyframe"):
            self.local_mapper.process_keyframe(
                kf, prefetched_ba=ba_data, prefetched_tri=tri_data,
                prefetched_fuse=fuse_data,
                defer_queue=self._deferred if defer else None,
            )
        self.metrics.add(
            event="keyframe", frame_id=fid, kf=kf,
            tracked_points=self.ref_kf_tracked,
            ba=dict(self.local_mapper.last_ba_stats),
            triangulation=dict(self.local_mapper.last_triangulation),
        )
        old_ids = self._block_ids
        self._rebuild_block()
        # remap of the device state is deferred to the next dispatch (the state of
        # the in-flight chunk still references the PRE-rebuild block; remapping now
        # would block on that chunk). Keep the EARLIEST pre-rebuild ids.
        if self._pending_remap is None:
            self._pending_remap = old_ids
        return kf

    @staticmethod
    def _remap_program(state: DeviceTrackState, perm: jnp.ndarray, new_pos: jnp.ndarray):
        """On-device slot translation after a block rebuild: slot' = perm[slot]
        (-1 when the point left the block), tracked positions refreshed from the
        new block (BA / loop correction may have moved them). Enqueued on the
        device stream between chunks, so it composes with ANY pipeline depth —
        no host fetch of the in-flight state is ever needed."""
        slot_old = state.assoc_slot
        slot = jnp.where(slot_old >= 0, perm[jnp.maximum(slot_old, 0)], -1)
        has = slot >= 0
        return state._replace(
            assoc_slot=slot,
            pt_mask=has,
            pt_pos=jnp.where(has[:, None], new_pos[jnp.maximum(slot, 0)], 0.0),
        )

    def _remap_device_state(self, old_ids: np.ndarray) -> None:
        """After a block rebuild, the device state's assoc_slot indices refer to
        the OLD block layout; translate them to the new one on device."""
        st = self._dstate
        if st is None:
            return
        # old slot -> new slot permutation (host numpy over the id arrays only)
        new_slots_of_old = self._ids_to_slots(
            np.where(old_ids >= 0, old_ids, -1)
        ).astype(np.int32)
        self._dstate = self._jit_remap(
            st, jnp.asarray(new_slots_of_old), self._block.pos
        )

    # ------------------------------------------------------------------ local map block

    def _rebuild_block(self) -> None:
        """Assemble the device point block from the current local map
        (UpdateLocalKeyFrames/Points, tracker.cpp:1002-1134): every keyframe
        sharing observations with the newest keyframe VOTES (no minimum — the
        reference counts any shared point, tracker.cpp:1039-1050), then the
        set expands with each voter's top covisible neighbors up to the 80-KF
        cap (tracker.cpp:1082-1133). Points are the union over the local set;
        an over-cap block keeps the BEST-observed points, not the newest ids."""
        arena = self.arena
        kf = self.ref_kf if self.ref_kf >= 0 else arena.num_kfs - 1
        kf_cap = self.cfg.tracker.local_map_kf_cap
        votes = arena.covisibility_counts(kf)
        voters = np.nonzero(votes > 0)[0]
        voters = voters[np.argsort(-votes[voters], kind="stable")]
        local = [kf]
        in_set = {kf}
        for v in voters[: kf_cap - 1]:
            local.append(int(v))
            in_set.add(int(v))
        # neighbor expansion (tracker.cpp:1082-1115): each voter contributes its
        # best not-yet-included covisible neighbor until the cap
        for v in list(local[1:]):
            if len(local) >= kf_cap:
                break
            for nb in arena.covisible_keyframes(v, min_shared=15, max_n=10):
                if int(nb) not in in_set:
                    local.append(int(nb))
                    in_set.add(int(nb))
                    break
        kfs = np.asarray(local, np.int64)
        pid_set = arena.kf_point_idx[kfs].reshape(-1)
        pid_set = np.unique(pid_set[pid_set >= 0])
        pid_set = pid_set[arena.pt_valid[pid_set]]
        cap = self.cfg.capacity.local_window_points
        if len(pid_set) > cap:
            # Survivor policy for an over-cap block: order by (most recent
            # observing keyframe, observation count). The frontier — points the
            # newest keyframes see — must stay in the block or freshly created
            # geometry never gains observations (fuse can only bind re-detections
            # to block members); among equally recent points the better-anchored
            # win. Newest-by-pid (the old rule) silently dropped BA-refined old
            # geometry; pure obs-count starves the frontier.
            last_obs = arena.pt_obs_kf[pid_set].max(axis=1).astype(np.int64)
            obs_n = np.minimum(arena.pt_obs_count[pid_set], 63).astype(np.int64)
            score = last_obs * 64 + obs_n
            keep = np.argsort(-score, kind="stable")[:cap]
            self.metrics.add(event="cap_clip", site="local_block",
                             kept=cap, dropped=int(len(pid_set) - cap))
            pid_set = np.sort(pid_set[keep])
        P = cap
        ids = np.full(P, -1, np.int32)
        ids[: len(pid_set)] = pid_set
        sl = slice(0, len(pid_set))
        # ONE packed f32 upload + one u32 upload instead of six separate
        # device_puts; a tiny jitted unpack slices the fields apart on device
        packed = np.zeros((P, 9), np.float32)
        packed[sl, 0:3] = arena.pt_pos[pid_set]
        packed[sl, 3:6] = arena.pt_normal[pid_set]
        packed[sl, 6] = arena.pt_min_dist[pid_set]
        packed[sl, 7] = arena.pt_max_dist[pid_set]
        packed[sl, 8] = 1.0
        desc = np.zeros((P, 8), np.uint32)
        desc[sl] = arena.pt_desc[pid_set]
        self._block = self._jit_unpack_block(jnp.asarray(packed), jnp.asarray(desc))
        self._block_ids = ids
        self._block_pos_host = packed[:, 0:3]  # host mirror — remap stays fetch-free

    def _ids_to_slots(self, point_ids: np.ndarray) -> np.ndarray:
        lookup = np.full(self.arena.num_pts + 1, -1, np.int32)
        valid_slots = np.nonzero(self._block_ids >= 0)[0]
        lookup[self._block_ids[valid_slots]] = valid_slots
        out = np.full(len(point_ids), -1, np.int32)
        has = point_ids >= 0
        out[has] = lookup[point_ids[has]]
        return out

    def _block_pos_for_slots(self, slot: np.ndarray) -> np.ndarray:
        pos = np.zeros((len(slot), 3), np.float32)
        has = slot >= 0
        pos[has] = self._block_pos_host[slot[has]]
        return pos

    def _update_point_stats(self, pids: np.ndarray) -> None:
        """MapPoint::UpdateNormalAndDepth + ComputeDistinctiveDescriptors
        (map_point.cpp:249-304, :311-354), vectorized over all touched points.

        The descriptor refresh is essential: as the camera approaches a landmark its
        appearance scale changes, and only observations keep the representative
        descriptor current — without this, long-lived points stop matching and the
        tracker decays into drift (observed empirically)."""
        arena = self.arena
        if len(pids) == 0:
            return
        pids = np.unique(pids)
        obs_kf = arena.pt_obs_kf[pids]
        obs_ft = arena.pt_obs_feat[pids]
        has = obs_kf >= 0
        kf_s = np.maximum(obs_kf, 0)
        ft_s = np.maximum(obs_ft, 0)
        # --- normal: mean viewing direction over observations ---
        R = arena.kf_pose[kf_s, :3, :3]
        t = arena.kf_pose[kf_s, :3, 3]
        kf_centers = -np.einsum("noji,noj->noi", R, t)
        delta = arena.pt_pos[pids][:, None, :] - kf_centers
        norm = np.linalg.norm(delta, axis=-1, keepdims=True)
        dirs = np.where(has[..., None], delta / np.maximum(norm, 1e-9), 0.0)
        mean_dir = dirs.sum(axis=1)
        mean_norm = np.linalg.norm(mean_dir, axis=-1, keepdims=True)
        arena.pt_normal[pids] = mean_dir / np.maximum(mean_norm, 1e-9)
        # --- scale-invariance range from the NEWEST observation (adapts as the
        # camera approaches; the reference anchors to the creating keyframe) ---
        newest = np.argmax(np.where(has, obs_kf, -1), axis=1)
        ar = np.arange(len(pids))
        d_new = norm[ar, newest, 0]
        oct_new = arena.kf_octave[kf_s[ar, newest], ft_s[ar, newest]].astype(np.float32)
        sf = self.cfg.orb.scale_factor
        max_dist = d_new * (sf ** oct_new)
        arena.pt_max_dist[pids] = max_dist
        arena.pt_min_dist[pids] = max_dist / (sf ** (self.cfg.orb.num_levels - 1))
        # --- distinctive descriptor: min median Hamming among observations ---
        # capped at the first 16 obs slots (stable anchors); sorted-median instead of
        # nanmedian (the nanmedian path cost ~100 ms per keyframe)
        Ocap = min(16, kf_s.shape[1])
        kf_c, ft_c, has_c = kf_s[:, :Ocap], ft_s[:, :Ocap], has[:, :Ocap]
        descs = arena.kf_desc[kf_c, ft_c]                      # (n, Oc, 8) uint32
        x = descs[:, :, None, :] ^ descs[:, None, :, :]        # (n, Oc, Oc, 8)
        ham = np.bitwise_count(x).sum(axis=-1).astype(np.float32)
        pair_ok = has_c[:, :, None] & has_c[:, None, :]
        ham = np.where(pair_ok, ham, np.inf)
        srt = np.sort(ham, axis=2)
        cnt = pair_ok.sum(axis=2)                              # (n, Oc)
        mid = np.maximum(cnt - 1, 0) // 2
        med = np.take_along_axis(srt, mid[:, :, None], axis=2)[:, :, 0]
        med = np.where(has_c, med, np.inf)
        best = np.argmin(med, axis=1)
        arena.pt_desc[pids] = descs[ar, best]

    # ------------------------------------------------------------------ export

    def _rel_to_ref(self, pose: np.ndarray, ref_kf: int) -> np.ndarray:
        """Tcr = Tcw @ Trw^-1 against the ref keyframe's CURRENT pose — the
        reference's per-frame relative bookkeeping (tracker.cpp:629-642)."""
        Trw = self.arena.kf_pose[ref_kf].astype(np.float64)
        R, t = Trw[:3, :3], Trw[:3, 3]
        inv = np.eye(4, dtype=np.float64)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return pose.astype(np.float64) @ inv

    def trajectory_poses(self) -> np.ndarray:
        """Per-frame Tcw reconstructed as Tcr @ Trw from the FINAL keyframe poses,
        so BA / loop-closure refinements propagate into the whole trajectory
        (SaveTrajectoryKITTI semantics, slam_system.cpp:264-314). Lost frames
        repeat the previous pose. Culled reference keyframes compose through
        their spanning-tree parent chain (slam_system.cpp:283-296), so their
        effective pose keeps following BA / loop-closure refinements of the
        surviving ancestors."""
        out = []
        prev = np.eye(4, dtype=np.float32)
        for r in self.records:
            if r.pose is not None:
                if r.rel_pose is not None:
                    Trw = self.arena.effective_kf_pose(r.ref_kf)
                    prev = (r.rel_pose @ Trw).astype(np.float32)
                else:
                    prev = r.pose
            out.append(prev.copy())
        return np.stack(out)
