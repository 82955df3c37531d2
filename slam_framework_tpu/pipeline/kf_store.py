"""Device-resident mirror of the arena's per-keyframe feature blocks.

The mapper's triangulation/fusion programs and the loop closer consume whole
keyframe feature blocks (xy/ur/octave/angle/desc). Those blocks are PRODUCED on
device by the chunked tracking program, so instead of fetching them to the host
arena and re-uploading them on every mapper dispatch (11 keyframes × ~130 KB
each), this store keeps one copy of every keyframe's feature block in device
memory, written ONCE:

  - chunk-path keyframes: a device-to-device slice of the tracking chunk's
    per-frame pack/desc outputs (zero host traffic);
  - init/reloc/mono keyframes: one lazy upload via `ensure()`.

Consumers gather neighbor blocks BY INDEX inside their jitted programs
(`mapping_ops.block_from_store`), so a triangulation dispatch ships only
indices, poses, and candidate masks (~25 KB) instead of the blocks themselves.

The store is append-only like the arena (slots of culled keyframes simply stop
being referenced); mutable per-feature state (map-point assignment masks) and
poses stay host-authoritative and ride along as small per-dispatch inputs.

Pack row layout (matches the tracker chunk's per-frame pack,
pipeline/tracker.py `_track_core`): [x, y, u_right, depth, octave, angle,
valid, slot, fuse] — only fields 0-5 are read by consumers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PACK_W = 9


class DeviceKFStore:
    def __init__(self, max_keyframes: int, max_features: int, device=None):
        self.device = device
        K, N = max_keyframes, max_features
        put = (lambda a: jax.device_put(a, device)) if device is not None else jnp.asarray
        self.packs = put(np.zeros((K, N, PACK_W), np.float32))
        self.descs = put(np.zeros((K, N, 8), np.uint32))
        self.present = np.zeros(K, bool)

        def _set(packs, descs, k, pack, desc):
            return (
                jax.lax.dynamic_update_slice(packs, pack[None], (k, 0, 0)),
                jax.lax.dynamic_update_slice(descs, desc[None], (k, 0, 0)),
            )

        # donate: the store is the only reference; update in place on device
        from slam_framework_tpu.utils import progcache

        self._jit_set = progcache.shared_jit(
            ("DeviceKFStore", max_keyframes, max_features, str(device)),
            lambda: jax.jit(_set, donate_argnums=(0, 1)),
        )

    def _on_store_device(self, *arrays):
        """`arrays` placed beside the store (a device-to-device copy when the
        tracker's chunk outputs live on another device than the mapper's)."""
        if self.device is None:
            return arrays
        return jax.device_put(arrays, self.device)

    def set_from_device(self, k: int, pack, desc) -> None:
        """Write keyframe k's block from device-resident chunk outputs
        (pack: (N, PACK_W) f32, desc: (N, 8) u32) — no host traffic."""
        self.packs, self.descs = self._jit_set(
            self.packs, self.descs, *self._on_store_device(np.int32(k), pack, desc)
        )
        self.present[k] = True

    def set_from_host(self, k: int, xy, ur, depth, octave, angle, desc) -> None:
        """One-off upload for keyframes created outside the chunk path."""
        N = self.packs.shape[1]
        pack = np.zeros((N, PACK_W), np.float32)
        n = xy.shape[0]
        pack[:n, 0:2] = xy
        pack[:n, 2] = ur
        pack[:n, 3] = depth
        pack[:n, 4] = octave
        pack[:n, 5] = angle
        d = np.zeros((N, 8), np.uint32)
        d[:n] = desc
        self.packs, self.descs = self._jit_set(
            self.packs, self.descs, *self._on_store_device(np.int32(k), pack, d)
        )
        self.present[k] = True

    def ensure(self, kfs, arena) -> None:
        """Upload any keyframes the chunk path didn't populate (rare: stereo
        init, mono init pair, relocalization re-seeds)."""
        for k in np.unique(np.asarray(kfs, np.int64)):
            if not self.present[k]:
                self.set_from_host(
                    int(k), arena.kf_xy[k], arena.kf_ur[k], arena.kf_depth[k],
                    arena.kf_octave[k].astype(np.float32), arena.kf_angle[k],
                    arena.kf_desc[k],
                )
