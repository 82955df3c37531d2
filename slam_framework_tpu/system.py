"""SlamSystem façade: the public per-frame API over the staged device pipeline.

Replacement for SlamSystem (reference: src/slam_system.{h,cpp}):
construction from config (+ vocabulary), per-frame entry points TrackStereo /
TrackRGBD / TrackMonocular (:89-224), localization-mode switch (:131-141), reset
handling (:97-120), Shutdown (:226-247), SaveTrajectoryKITTI (:264-314) and
SaveKeyFrameTrajectory (:316-349).

Differences from the reference architecture (deliberate, accelerator-first):
  - The three reference threads are sequenced pipeline stages driven by the
    tracker's chunked device dispatch (see pipeline/tracker.py); no mutexes.
  - The ORB vocabulary: the reference requires a pre-trained ORBvoc.txt (the blob
    is stripped from the repo, .MISSING_LARGE_BLOBS:1). Here, if no vocabulary file
    is configured, one is trained online from the first keyframes' descriptors —
    place recognition (loop closing + relocalization) activates once trained.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from slam_framework_tpu.bow import vocabulary as bow_vocab
from slam_framework_tpu.config import SlamConfig
from slam_framework_tpu.io import trajectory
from slam_framework_tpu.map.arena import MapArena
from slam_framework_tpu.pipeline.loop_closer import LoopCloser
from slam_framework_tpu.pipeline.relocalization import Relocalizer
from slam_framework_tpu.pipeline.tracker import StereoTracker, TrackingState


def _shipped_vocabulary() -> Optional[str]:
    """Path of the bundled offline vocabulary asset, if present (the analogue of
    the reference's required ORBvoc.txt, slam_system.cpp:8-30 — stripped from its
    repo; ours is trained on a synthetic corpus by tools/train_vocab.py)."""
    import os

    p = os.path.join(os.path.dirname(__file__), "assets", "orbvoc_synth.npz")
    return p if os.path.exists(p) else None


class SlamSystem:
    """User-facing engine. One instance per camera stream."""

    VOCAB_TRAIN_AT_KFS = 6       # train the online vocabulary once this many KFs exist
    RESET_IF_LOST_BELOW_KFS = 5  # tracker.cpp:613-620

    def __init__(self, cfg: Optional[SlamConfig] = None, config_path: Optional[str] = None,
                 sensor: Optional[str] = None, sync_every: int = 4, mesh=None):
        """mesh: optional jax.sharding.Mesh. With > 1 device, the post-loop
        global BA runs as a sharded SPMD program over it (owner-keyed
        covisibility segments, parallel/{dist_ba,map_shard}.py) and point
        ownership migrates after each merge — the distributed backend wired
        into the live system the way the reference wires its concurrency at
        construction (slam_system.cpp:49-82)."""
        if cfg is None:
            if config_path is None:
                raise ValueError("provide cfg or config_path")
            cfg = SlamConfig.from_json(config_path, sensor=sensor or "stereo")
        if sensor is not None and sensor != cfg.sensor:
            import dataclasses

            cfg = dataclasses.replace(cfg, sensor=sensor)
        self.cfg = cfg
        self.sync_every = sync_every
        self.mesh = mesh
        self.vocab: Optional[bow_vocab.Vocabulary] = None
        vocab_path = cfg.vocabulary_path or _shipped_vocabulary()
        if vocab_path:
            try:
                self.vocab = bow_vocab.load(vocab_path)
            except (OSError, ValueError, KeyError):
                self.vocab = None  # fall back to online training
        self.n_resets = 0
        self._build()

    # ------------------------------------------------------------------ lifecycle

    def _build(self, arena: Optional[MapArena] = None) -> None:
        cfg = self.cfg
        self.arena = arena or MapArena.create(cfg.capacity, cfg.capacity.max_features)
        if cfg.sensor == "monocular":
            from slam_framework_tpu.pipeline.mono_tracker import MonoTracker

            self.tracker = MonoTracker(cfg, self.arena, sync_every=self.sync_every)
        else:
            self.tracker = StereoTracker(cfg, self.arena, sync_every=self.sync_every)
        self.loop_closer: Optional[LoopCloser] = None
        if self.vocab is not None:
            self._activate_place_recognition()
        self.tracker.on_new_keyframe = self._on_new_keyframe
        # visualization thread (reference: RosPublisher, started when use_ros is
        # set, slam_system.cpp:69-73) — sink-pluggable, see viz/publisher.py
        prev_pub = getattr(self, "publisher", None)
        if prev_pub is not None:
            prev_pub.stop()
        self.publisher = None
        if cfg.use_viewer:
            from slam_framework_tpu.viz import MapPublisher

            self.publisher = MapPublisher(self.tracker, self.arena)
            self.publisher.start()

    def reset(self) -> None:
        """Tracker::Reset (tracker.cpp:225-246): clear map, database, state."""
        self.n_resets += 1
        self._build()

    def shutdown(self) -> dict:
        """Drain pending device work; return run statistics (Shutdown :226-247)."""
        if self.publisher is not None:
            self.publisher.stop()
        self._settle()
        return {
            "frames": len(self.tracker.records),
            "keyframes": self.arena.n_valid_kfs,
            "map_points": self.arena.n_valid_pts,
            "loops_closed": self.loop_closer.n_loops_closed if self.loop_closer else 0,
            "resets": self.n_resets,
        }

    def metrics_summary(self) -> dict:
        """Structured run metrics: tracking aggregates + per-stage wall clocks
        (the reference logs nothing structured, SURVEY.md §5.5; here it is a
        first-class output)."""
        caps = dict(self.tracker.local_mapper.cap_clips)
        if self.loop_closer:
            caps.update(self.loop_closer.cap_clips)
        block_clips = [
            r for r in self.tracker.metrics.records if r.get("event") == "cap_clip"
        ]
        if block_clips:
            caps["local_block_points"] = sum(r.get("dropped", 0) for r in block_clips)
        return {
            "tracking": self.tracker.metrics.summary(),
            "stages": self.tracker.timers.summary(),
            "cap_clips": caps,
        }

    def dump_metrics(self, path: str) -> None:
        """Write the full structured event log (one JSON line per frame/keyframe)."""
        self.tracker.metrics.to_jsonl(path)

    # ------------------------------------------------------------------ tracking API

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        """Per-frame stereo entry (TrackStereo, slam_system.cpp:89-129). Returns the
        latest synced Tcw (lags sync_every frames) or None."""
        assert self.cfg.sensor == "stereo"
        pose = self.tracker.track(left, right, timestamp)
        self._maybe_reset()
        return pose

    def track_stereo_device(self, pair, timestamp: float):
        """Stereo entry for a (2, H, W) image pair ALREADY in device memory — the
        production ingestion path (sensor frames prefetched to the device ahead
        of compute; see StereoTracker.track_device)."""
        assert self.cfg.sensor == "stereo"
        pose = self.tracker.track_device(pair, timestamp)
        self._maybe_reset()
        return pose

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        """Per-frame RGB-D entry (TrackRGBD, slam_system.cpp:131-172)."""
        assert self.cfg.sensor == "rgbd"
        pose = self.tracker.track(gray, depth, timestamp)
        self._maybe_reset()
        return pose

    def track_monocular(self, gray: np.ndarray, timestamp: float):
        """Per-frame monocular entry (TrackMonocular, slam_system.cpp:174-224).
        Scale is gauge-free: evaluate trajectories Sim3-aligned."""
        assert self.cfg.sensor == "monocular"
        pose = self.tracker.track(gray, gray, timestamp)
        self._maybe_reset()
        return pose

    def _maybe_reset(self) -> None:
        # the reference resets on a young-map loss UNCONDITIONALLY — even with
        # a relocalizer available (tracker.cpp:613-620: KeyFramesInMap()<=5);
        # an earlier `relocalizer is None` guard here broke that parity once
        # the shipped vocabulary made the relocalizer active from frame 0
        if (
            self.tracker.state == TrackingState.LOST
            and self.arena.n_valid_kfs <= self.RESET_IF_LOST_BELOW_KFS
        ):
            self.reset()

    # ------------------------------------------------------------------ modes

    def activate_localization_mode(self) -> None:
        """Tracking-only: no new keyframes/map growth (slam_system.cpp:131-141)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.localization_only = False

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    # ------------------------------------------------------------------ stage wiring

    def _activate_place_recognition(self) -> None:
        K = self.tracker.K if hasattr(self, "tracker") else None
        from slam_framework_tpu.geometry.projection import Intrinsics

        cam = self.cfg.camera
        K = Intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        self.loop_closer = LoopCloser(
            self.cfg, self.arena, K, self.vocab,
            kf_store=self.tracker.local_mapper.kf_store,
            mesh=self.mesh,
        )
        # the loop closer's in-flight BoW rides the tracker's drain fetch
        # (drop a stale instance first: online vocab training rebuilds us)
        self.tracker.aux_fetch = [
            s for s in self.tracker.aux_fetch if not isinstance(s, LoopCloser)
        ]
        self.tracker.aux_fetch.append(self.loop_closer)

        def _forget(k: int) -> None:
            self.loop_closer.db.erase(k)
            self.loop_closer.bow_frames.pop(k, None)

        self.tracker.local_mapper.on_erase_keyframe = _forget
        self.tracker.relocalizer = Relocalizer(
            self.cfg, self.arena, self.tracker.K, self.loop_closer
        )

    def _on_new_keyframe(self, kf: int) -> None:
        # 1. online vocabulary training once the map has enough texture
        if self.vocab is None and self.arena.n_valid_kfs >= self.VOCAB_TRAIN_AT_KFS:
            self._train_vocabulary()
        if self.loop_closer is None:
            return
        # catch up the BoW database (covers backfill after online training);
        # skip the keyframe whose BoW transform is still IN FLIGHT on device
        # (the deferred harvest will register it next step)
        pending = self.loop_closer._bow_pending
        pending_kf = pending[0] if pending is not None else None
        for k in range(self.arena.num_kfs):
            if k == kf or k == pending_kf:
                continue
            if self.arena.kf_valid[k] and k not in self.loop_closer.bow_frames:
                bow = self.loop_closer.compute_bow(k)
                self.loop_closer.bow_frames[k] = bow
                self.loop_closer.db.add(k, bow)
        # 2. merge an async global BA from a PREVIOUS loop closure (needs settled
        # poses — finalize only when one is actually in flight), then run loop
        # detection for this keyframe. Detection is appearance-only; the full
        # mapper drain is deferred to the moment a consistent candidate forces a
        # Sim3/correction (pre_close hook). Draining EVERY keyframe serialized
        # the async BA/triangulation pipeline into the tracker's critical path.
        if self.loop_closer.has_pending_gba():
            self.tracker.local_mapper.finalize()
            pre = self.arena.kf_pose[kf].copy()
            if self.loop_closer.apply_pending_gba():
                self._apply_world_correction(pre, self.arena.kf_pose[kf])
        pre_box = {}

        def _pre_close():
            self.tracker.local_mapper.finalize()
            pre_box["pose"] = self.arena.kf_pose[kf].copy()

        closed = self.loop_closer.process_keyframe(kf, pre_close=_pre_close)
        if closed:
            self._apply_world_correction(pre_box["pose"], self.arena.kf_pose[kf])

    def _train_vocabulary(self) -> None:
        """Online vocabulary: k=10 depth=4 (10k words) with IDF weights refitted
        from the existing keyframes — the DBoW2-scale regime (the reference's
        ORBvoc is k=10 L=6 trained offline on a large corpus,
        TemplatedVocabulary.h:1335-1418 + ScoringObject.cpp L1/TF-IDF). A
        pre-trained ORBvoc.txt takes precedence when configured
        (cfg.vocabulary_path, loaded in _build)."""
        arena = self.arena
        descs = arena.kf_desc[: arena.num_kfs][arena.kf_feat_valid[: arena.num_kfs]]
        if len(descs) < 500:
            return
        sample = descs[np.random.default_rng(0).permutation(len(descs))[:30000]]
        self.vocab = bow_vocab.train(sample, k=10, depth=4, seed=0)
        # IDF refit over the keyframes trained on (keyframe_database scoring is
        # TF-IDF L1; uniform weights flatten the score distribution and cost
        # loop precision at map scale)
        word_lists = []
        for k in range(arena.num_kfs):
            if not arena.kf_valid[k]:
                continue
            d = arena.kf_desc[k][arena.kf_feat_valid[k]]
            word_lists.append(bow_vocab.transform_host(self.vocab, d))
        bow_vocab.refit_idf(self.vocab, word_lists)
        self._activate_place_recognition()

    def _apply_world_correction(self, kf_pose_pre: np.ndarray, kf_pose_post: np.ndarray) -> None:
        """After a loop closure rewrote the map under the tracker, move the
        device-resident pose into the corrected world: T' = T @ (T_pre^-1 T_post)."""
        import jax.numpy as jnp

        st = self.tracker._dstate
        if st is None:
            return
        corr = np.linalg.inv(kf_pose_pre.astype(np.float64)) @ kf_pose_post.astype(np.float64)
        self.tracker._dstate = st._replace(
            pose=jnp.asarray(
                (np.asarray(st.pose, np.float64) @ corr).astype(np.float32)
            )
        )

    # ------------------------------------------------------------------ checkpoint

    def save_map(self, path: str) -> None:
        """Persist map + trajectory + vocabulary (the reference's SaveMap TODO,
        slam_system.h:59-61, implemented: the array map is a direct dump)."""
        from slam_framework_tpu.io import checkpoint

        self._settle()
        checkpoint.save_map(path, self.arena, self.tracker.records, self.vocab)

    def load_map(self, path: str) -> None:
        """Restore a saved map. The tracker resumes in LOST state and relocalizes
        against the loaded map on the next frames (requires a saved vocabulary)."""
        from slam_framework_tpu.io import checkpoint
        from slam_framework_tpu.pipeline.tracker import TrackingState

        arena, records, vocab = checkpoint.load_map(path)
        if vocab is not None:
            self.vocab = vocab
        self._build(arena=arena)
        if records:
            self.tracker.records = records
            self.tracker.frame_id = records[-1].frame_id + 1
        valid = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
        if len(valid):
            self.tracker.ref_kf = int(valid[-1])
            self.tracker.last_kf_frame_id = int(arena.kf_frame_id[valid[-1]])
            self.tracker.state = TrackingState.LOST  # relocalize to resume
        if self.loop_closer is not None:
            for k in valid:  # backfill the place-recognition database
                bow = self.loop_closer.compute_bow(int(k))
                self.loop_closer.bow_frames[int(k)] = bow
                self.loop_closer.db.add(int(k), bow)

    # ------------------------------------------------------------------ export

    def save_trajectory_kitti(self, path: str) -> None:
        """Per-frame camera trajectory in KITTI format (slam_system.cpp:264-314)."""
        self._settle()
        trajectory.save_kitti(path, self.tracker.trajectory_poses())

    def save_keyframe_trajectory(self, path: str) -> None:
        """Keyframe-only trajectory (slam_system.cpp:316-349)."""
        self._settle()
        arena = self.arena
        kfs = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
        trajectory.save_kitti(path, arena.kf_pose[kfs])

    def frame_poses(self) -> np.ndarray:
        self._settle()
        return self.tracker.trajectory_poses()

    def _settle(self) -> None:
        """Drain ALL in-flight device work (tracker chunks, mapper BA/tri/fuse,
        deferred loop detection, async global BA) so exported state is final."""
        self.tracker.flush()
        if self.loop_closer is not None:
            self._finish_loop_stage()
            self.loop_closer.apply_pending_gba()

    def _finish_loop_stage(self) -> bool:
        """Run the deferred (one-keyframe-late) loop detection for the last
        keyframe and apply the world correction if it closes."""
        if self.loop_closer is None:
            return False
        arena = self.arena
        valid = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
        if len(valid) == 0:
            return bool(self.loop_closer.flush())
        anchor = int(valid[-1])
        pre_box = {}

        def _pre_close():
            self.tracker.local_mapper.finalize()
            pre_box["pose"] = arena.kf_pose[anchor].copy()

        closed = self.loop_closer.flush(pre_close=_pre_close)
        if closed:
            self._apply_world_correction(pre_box["pose"], arena.kf_pose[anchor])
        return closed
