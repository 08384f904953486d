"""A whole run on the CPU at a tiny size: the last line's keys and the
comparison."""
from __future__ import annotations

import json
import time

import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_line(tiny):
    spec = tiny("edge_5120-16x16.replay")
    out = harness.run(spec, 2**31 + 5, 0.0, False, "cpu", time.perf_counter(),
                      log=lambda msg: None)
    assert list(out) == KEYS  # the comparison's numbers come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= spec.cell["quality_jobs"]
    assert set(out["metrics"]) == {"job_s", "avg_hop", "edge_cut",
                                   "noc_latency", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(spec.cell["limits"])
    json.dumps(out)


def test_map_cell_has_no_noc_latency(tiny):
    spec = tiny("edge_5120-16x16.map")
    out = harness.run(spec, 11, 0.0, False, "cpu", time.perf_counter(),
                      log=lambda msg: None)
    assert out["correct"] is True
    assert "noc_latency" not in out["metrics"]
    assert "noc_gap" not in out["checks"]
