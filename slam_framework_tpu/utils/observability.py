"""Structured metrics, stage timers, and profiler hooks.

The reference has no observability beyond std::cout prints (SURVEY.md §5.1/§5.5):
manual wall-clock timing lives only in the example mains (examples/main_stereo.cpp:116-130)
and lifecycle messages are unstructured prints. This build makes metrics first-class:

  - `StageTimers`   — per-stage wall-clock accumulators (dispatch / drain / keyframe /
                      ba / triangulation / loop), the replacement for the reference's
                      ad-hoc `tracked_times` vector.
  - `MetricsLog`    — append-only structured per-frame records (matches, inliers,
                      keyframe events with BA chi2 / outliers / new-point counts),
                      with aggregate summaries and JSONL export.
  - `trace_span`    — jax.profiler TraceAnnotation wrapper so pipeline stages show up
                      named in xprof/perfetto traces (§5.1: "use JAX profiler traces
                      + per-stage step timers as first-class output"). Captures are
                      started and stopped with jax.profiler.start_trace/stop_trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Iterator, Optional

import jax.profiler
import numpy as np


class StageTimers:
    """Wall-clock accumulators keyed by stage name."""

    def __init__(self):
        self.total_s: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total_s[name] = self.total_s.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def summary(self) -> dict:
        """Per-stage totals + means, in milliseconds."""
        out = {}
        for name, tot in sorted(self.total_s.items()):
            n = self.count[name]
            out[name] = {
                "total_ms": round(tot * 1e3, 2),
                "count": n,
                "mean_ms": round(tot / n * 1e3, 3),
            }
        return out

    def merge(self, other: "StageTimers") -> None:
        for k, v in other.total_s.items():
            self.total_s[k] = self.total_s.get(k, 0.0) + v
            self.count[k] = self.count.get(k, 0) + other.count[k]


class MetricsLog:
    """Append-only structured event log (per-frame + per-keyframe records)."""

    def __init__(self):
        self.records: list[dict] = []

    def add(self, **fields) -> None:
        self.records.append(fields)

    def __len__(self) -> int:
        return len(self.records)

    def frames(self) -> list[dict]:
        return [r for r in self.records if r.get("event", "frame") == "frame"]

    def keyframes(self) -> list[dict]:
        return [r for r in self.records if r.get("event") == "keyframe"]

    def summary(self) -> dict:
        fr = self.frames()
        kf = self.keyframes()
        out: dict = {"frames": len(fr), "keyframes": len(kf)}
        if fr:
            inl = np.array([r.get("inliers", 0) for r in fr], np.float64)
            out["inliers_mean"] = round(float(inl.mean()), 1)
            out["inliers_p5"] = round(float(np.percentile(inl, 5)), 1)
            out["lost_frames"] = sum(1 for r in fr if r.get("lost"))
            out["relocalizations"] = sum(1 for r in fr if r.get("relocalized"))
        if kf:
            out["ba_outliers_total"] = sum(r.get("ba", {}).get("outliers", 0) for r in kf)
            out["new_points_total"] = sum(
                r.get("triangulation", {}).get("new_points", 0) for r in kf
            )
            chi2 = [r["ba"]["chi2"] for r in kf if r.get("ba", {}).get("chi2") is not None]
            if chi2:
                out["ba_chi2_last"] = round(float(chi2[-1]), 3)
        return out

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=_json_default) + "\n")


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named span in the JAX profiler timeline (costs next to nothing when no
    trace is being captured). Errors raised in the body propagate."""
    with jax.profiler.TraceAnnotation(name):
        yield
