"""Tests for structured metrics / stage timers (SURVEY.md §5.1/§5.5 — the
reference has only unstructured prints; observability is first-class here)."""

import json
import time

import pytest

from slam_framework_tpu.utils.observability import (
    MetricsLog,
    StageTimers,
    trace_span,
)


def test_stage_timers_accumulate():
    t = StageTimers()
    for _ in range(3):
        with t.time("stage_a"):
            time.sleep(0.002)
    with t.time("stage_b"):
        pass
    s = t.summary()
    assert s["stage_a"]["count"] == 3
    assert s["stage_a"]["total_ms"] >= 6.0
    assert s["stage_a"]["mean_ms"] >= 2.0
    assert s["stage_b"]["count"] == 1


def test_stage_timers_merge():
    a, b = StageTimers(), StageTimers()
    with a.time("x"):
        pass
    with b.time("x"):
        pass
    with b.time("y"):
        pass
    a.merge(b)
    assert a.count["x"] == 2 and a.count["y"] == 1


def test_metrics_log_summary_and_jsonl(tmp_path):
    log = MetricsLog()
    log.add(event="frame", frame_id=0, matches=80, inliers=60)
    log.add(event="frame", frame_id=1, matches=70, inliers=50, lost=True)
    log.add(event="frame", frame_id=2, matches=75, inliers=55, relocalized=True)
    log.add(event="keyframe", frame_id=2, kf=0,
            ba={"cams": 3, "points": 100, "obs": 300, "outliers": 4, "chi2": 123.4},
            triangulation={"neighbors": 5, "new_points": 42})
    s = log.summary()
    assert s["frames"] == 3 and s["keyframes"] == 1
    assert s["lost_frames"] == 1 and s["relocalizations"] == 1
    assert s["inliers_mean"] == 55.0
    assert s["ba_outliers_total"] == 4
    assert s["new_points_total"] == 42
    assert s["ba_chi2_last"] == 123.4

    path = str(tmp_path / "metrics.jsonl")
    log.to_jsonl(path)
    lines = [json.loads(l) for l in open(path)]
    assert len(lines) == 4
    assert lines[3]["ba"]["chi2"] == 123.4


def test_trace_span_noop_safe():
    with trace_span("anything"):
        x = 1 + 1
    assert x == 2


def test_trace_span_propagates_body_errors():
    with pytest.raises(ValueError, match="from the body"):
        with trace_span("failing"):
            raise ValueError("from the body")
