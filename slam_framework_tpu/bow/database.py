"""Keyframe database: inverted index + loop/relocalization candidate detection.

Replacement for KeyframeDatabase
(reference: src/data/keyframe_database.{h,cpp}): word -> keyframe inverted index
(:5-18), DetectLoopCandidates (:48-176) and DetectRelocalizationCandidates (:179-299).

The vocabulary descent runs on device (bow/vocabulary.py); the index and scoring live
on host numpy — a frame's word list is ~2k entries in a >=1e4-word vocabulary, so the
sparse host path is faster than any dense device formulation and runs concurrently
with device tracking.

Scoring is L1 TF-IDF like the reference (TemplatedVocabulary.h:54 L1_NORM):
  s(v, w) = 2 * sum_i min(v_i, w_i)  with v, w L1-normalized weighted histograms,
equivalently 2 - |v - w|_1 (ScoringObject.cpp L1Scoring).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class BowFrame:
    """Sparse BoW of one frame: sorted unique word ids + normalized tf-idf values."""

    __slots__ = ["words", "values"]

    def __init__(self, word_ids: np.ndarray, weights: Optional[np.ndarray] = None):
        w = word_ids[word_ids >= 0]
        if weights is None:
            weights = np.ones(len(w), np.float32)
        else:
            weights = weights[word_ids >= 0].astype(np.float32)
        words, inv = np.unique(w, return_inverse=True)
        vals = np.zeros(len(words), np.float32)
        np.add.at(vals, inv, weights)
        norm = vals.sum()
        self.words = words
        self.values = vals / max(norm, 1e-9)

    def score(self, other: "BowFrame") -> float:
        """L1 score in [0, 1]: sum of elementwise minima of the common words."""
        ia = np.searchsorted(self.words, other.words)
        ia = np.clip(ia, 0, len(self.words) - 1) if len(self.words) else ia
        if len(self.words) == 0 or len(other.words) == 0:
            return 0.0
        match = self.words[ia] == other.words
        return float(np.minimum(self.values[ia[match]], other.values[match]).sum())


class KeyframeDatabase:
    def __init__(self, num_words: int):
        self.num_words = num_words
        self.index: Dict[int, List[int]] = {}
        self.frames: Dict[int, BowFrame] = {}

    def add(self, kf: int, bow: BowFrame) -> None:
        if kf in self.frames:
            # idempotent: a re-add would duplicate the inverted-index entries,
            # and a later erase would remove only one copy — the stale copy
            # then dangles into frames-lookups after culling
            return
        self.frames[kf] = bow
        for w in bow.words:
            self.index.setdefault(int(w), []).append(kf)

    def erase(self, kf: int) -> None:
        bow = self.frames.pop(kf, None)
        if bow is None:
            return
        for w in bow.words:
            lst = self.index.get(int(w))
            if lst and kf in lst:
                lst.remove(kf)

    def _shared_word_counts(self, bow: BowFrame, exclude: set) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for w in bow.words:
            for kf in self.index.get(int(w), ()):
                if kf not in exclude:
                    counts[kf] = counts.get(kf, 0) + 1
        return counts

    def detect_loop_candidates(
        self,
        bow: BowFrame,
        min_score: float,
        connected: set,
        covisibility_groups: Optional[Dict[int, List[int]]] = None,
    ) -> List[int]:
        """DetectLoopCandidates (keyframe_database.cpp:48-176):
        1. keyframes sharing words, excluding the covisible set;
        2. keep those with shared-words >= 0.8 * max and score >= min_score;
        3. accumulate scores over covisibility groups; keep groups with
           acc >= 0.75 * best, return each group's best keyframe."""
        counts = self._shared_word_counts(bow, connected)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored: List[Tuple[int, float]] = []
        for kf, c in counts.items():
            if c >= min_common:
                s = bow.score(self.frames[kf])
                if s >= min_score:
                    scored.append((kf, s))
        if not scored:
            return []
        return self._group_accumulate(scored, covisibility_groups)

    @staticmethod
    def _group_accumulate(
        scored: List[Tuple[int, float]],
        covisibility_groups: Optional[Dict[int, List[int]]],
    ) -> List[int]:
        """Covisibility-group score accumulation shared by loop and reloc
        candidate detection (keyframe_database.cpp:121-167 / :243-291): each
        scoring keyframe's group accumulates the scores of its covisible
        members that also scored; groups with acc > 0.75 * best contribute
        their best-scoring member."""
        best_acc = 0.0
        group_best: List[Tuple[float, int]] = []
        scored_map = dict(scored)
        for kf, s in scored:
            group = (covisibility_groups or {}).get(kf, [kf])
            acc = s
            best_kf, best_s = kf, s
            for g in group:
                gs = scored_map.get(g)
                if gs is not None and g != kf:
                    acc += gs
                    if gs > best_s:
                        best_kf, best_s = g, gs
            group_best.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        out = []
        seen = set()
        for acc, kf in group_best:
            if acc > 0.75 * best_acc and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_relocalization_candidates(
        self,
        bow: BowFrame,
        covisibility_groups: Optional[Dict[int, List[int]]] = None,
    ) -> List[int]:
        """DetectRelocalizationCandidates (keyframe_database.cpp:179-299): same
        pipeline without the min_score gate or connected-set exclusion, with the
        same covisibility-group score accumulation (:243-291)."""
        counts = self._shared_word_counts(bow, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = [
            (kf, bow.score(self.frames[kf]))
            for kf, c in counts.items()
            if c >= min_common
        ]
        if not scored:
            return []
        return self._group_accumulate(scored, covisibility_groups)
