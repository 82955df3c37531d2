#!/usr/bin/env python
"""Offline vocabulary training on a multi-world synthetic descriptor corpus.

The reference ships a ~1M-leaf ORBvoc trained offline on a large image corpus
(third_party/DBoW2/DBoW2/TemplatedVocabulary.h:1335-1418; the blob is stripped
from its repo). The online 10k-word fallback (system.py:_train_vocabulary) is
trained on the current sequence's first keyframes only — fine within one
sequence, but place-recognition precision/recall at city scale or across
sequences needs a bigger, corpus-trained tree.

This tool harvests ORB descriptors from many varied synthetic worlds (different
seeds, turn rates, corridor widths => different texture statistics), trains a
k=10 depth=5 (100k-word) binary-k-medians tree, refits IDF weights on held-out
frames, and writes the compressed asset the system auto-loads
(slam_framework_tpu/assets/orbvoc_synth.npz).

Usage:
  python tools/train_vocab.py [--worlds 24] [--frames-per-world 20] [--depth 5]
                              [--out slam_framework_tpu/assets/orbvoc_synth.npz]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def harvest(n_worlds: int, frames_per_world: int, seed0: int = 100):
    import jax
    import jax.numpy as jnp

    from slam_framework_tpu.config import SlamConfig
    from slam_framework_tpu.io import synthetic
    from slam_framework_tpu.ops.extractor import default_extractor

    cfg = SlamConfig()
    ext = default_extractor(cfg.orb.num_features, cfg.orb.num_levels)
    all_desc = []
    frame_descs = []  # per-frame lists for IDF refit
    rng = np.random.default_rng(7)
    t0 = time.time()
    for w in range(n_worlds):
        world = synthetic.make_world(
            num_frames=frames_per_world,
            cam=cfg.camera,
            seed=seed0 + w,
            speed=float(rng.uniform(0.5, 2.0)),
            yaw_rate=float(rng.uniform(-0.03, 0.03)),
            corridor_half_width=float(rng.uniform(7.0, 16.0)),
        )
        for f in range(frames_per_world):
            left, _ = world.stereo_pair(f)
            feats = ext(jnp.asarray(left))
            d, v = jax.device_get([feats.desc, feats.valid])
            d = np.asarray(d)[np.asarray(v)]
            all_desc.append(d)
            frame_descs.append(d)
        print(f"world {w + 1}/{n_worlds}: {sum(len(a) for a in all_desc)} descriptors"
              f" ({time.time() - t0:.0f}s)", file=sys.stderr)
    return np.concatenate(all_desc), frame_descs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=24)
    ap.add_argument("--frames-per-world", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "slam_framework_tpu", "assets", "orbvoc_synth.npz"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        os.environ.setdefault("SLAM_NO_COMPILE_CACHE", "1")  # CPU AOT cache loader is crash-prone
        jax.config.update("jax_platform_name", "cpu")

    from slam_framework_tpu.bow import vocabulary as bow_vocab

    desc, frame_descs = harvest(args.worlds, args.frames_per_world)
    print(f"corpus: {len(desc)} descriptors from {len(frame_descs)} frames",
          file=sys.stderr)

    t0 = time.time()
    vocab = bow_vocab.train(desc, k=args.k, depth=args.depth, seed=0)
    print(f"trained k={args.k} depth={args.depth}: {vocab.num_words} words, "
          f"{vocab.num_nodes} nodes ({time.time() - t0:.0f}s)", file=sys.stderr)

    # IDF on the harvest frames (document frequency over per-frame word sets)
    word_lists = [bow_vocab.transform_host(vocab, d) for d in frame_descs]
    bow_vocab.refit_idf(vocab, word_lists)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    bow_vocab.save_npz(vocab, args.out)
    sz = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({sz:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
