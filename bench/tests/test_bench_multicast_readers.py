"""The readers of the multicast cell's per-layer metrics, on hand-made traces
and spans: the volume refiner's levels and D* evaluations, the
connectivity kernel's roofline share, and the tree-fork replay's time and
stepped share."""
from __future__ import annotations

import importlib
import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

import harness
import program_spans
import tracing

S = namedtuple("S", "id parent root name start_ns end_ns attrs")
NS = 1_000_000_000  # a second
T0 = 1_800_000_000  # seconds on the Unix epoch, as the profiler's clock
PEAKS = {"hbm_bytes_per_s": 3.35e12}
READERS = ["vol_refine_s", "vol_eval_s", "conn_roofline", "tree_replay_s",
           "tree_stepped_share"]


def _span(name, a, b, id=0, parent=0, **attrs):
    """A span from ``a`` to ``b`` seconds after T0."""
    return S(id, parent, 0, name, int((T0 + a) * NS), int((T0 + b) * NS),
             attrs)


def _trace(w0, w1, busy=(), spans=None):
    return tracing.JobTrace(
        window=(T0 + w0, T0 + w1), busy=[(T0 + a, T0 + b) for a, b in busy],
        spans={k: [(T0 + a, T0 + b) for a, b in v]
               for k, v in (spans or {}).items()})


def _read(name, monkeypatch, traces, records):
    monkeypatch.setattr(program_spans, "recorded", lambda: records)
    ctx = SimpleNamespace(traces=traces, peaks=PEAKS)
    return harness.load_reader(name).read(ctx)


def test_vol_refine_s_reads_the_levels_that_evaluate_d_star(monkeypatch):
    records = [_span("sneap.partition.refine.eval", 0.5, 1, id=2, parent=1,
                     engine="kernel"),
               _span("sneap.partition.refine", 0, 2, id=1, engine="vec"),
               _span("sneap.partition.refine.eval", 2.5, 3, id=4, parent=3,
                     engine="gather_host"),
               _span("sneap.partition.refine.eval", 3.5, 4, id=5, parent=3,
                     engine="gather_host"),
               _span("sneap.partition.refine", 2, 5, id=3, engine="vec"),
               # A cut level: no D* evaluation spans under it.
               _span("sneap.partition.refine", 5, 6, id=6, engine="vec"),
               _span("sneap.partition.refine", 6, 7, id=7, engine="scalar")]
    traces = [_trace(0, 10)]
    assert _read("vol_refine_s", monkeypatch, traces, records) == \
        pytest.approx(5.0)
    assert _read("vol_refine_s", monkeypatch, traces, records[5:]) is None


def test_vol_eval_s_sums_every_engine(monkeypatch):
    records = [_span("sneap.partition.refine", 0, 4, engine="vec"),
               _span("sneap.partition.refine.eval", 0.5, 1, engine="kernel"),
               _span("sneap.partition.refine.eval", 1, 1.25,
                     engine="dense_host"),
               _span("sneap.partition.refine.eval", 2, 3,
                     engine="gather_host"),
               _span("sneap.partition.refine.eval", 12, 13,
                     engine="gather_host")]  # the next job
    traces = [_trace(0, 10), _trace(11, 20)]
    assert _read("vol_eval_s", monkeypatch, traces, records) == \
        pytest.approx((1.75 + 1.0) / 2)


def test_tree_replay_s_sums_the_dedupe_and_the_tree_steps(monkeypatch):
    records = [_span("sneap.evaluate", 0, 9),
               _span("sneap.noc.order", 0, 1),  # shared with unicast: not read
               _span("sneap.noc.dedupe", 1, 1.5),
               _span("sneap.replay.tree.links", 1.5, 2.5),
               _span("sneap.replay.tree.screen", 2.5, 2.75),
               _span("sneap.replay.tree.schedule", 2.75, 3),
               _span("sneap.replay.tree.stepper", 3, 5),
               _span("sneap.replay.tree.stats", 5, 5.25)]
    assert _read("tree_replay_s", monkeypatch, [_trace(0, 10)], records) == \
        pytest.approx(4.25)


def test_tree_stepped_share_is_over_the_noc_bound_firings(monkeypatch):
    records = [_span("sneap.noc.dedupe", 0, 1, records=900, firings=400,
                     packets=700),
               _span("sneap.replay.tree.links", 1, 2, packets=700,
                     firings=400, tree_links=1500),
               _span("sneap.replay.tree.screen", 2, 3, hot_pairs=20,
                     stepped_firings=300),
               _span("sneap.replay.tree.schedule", 3, 4,
                     past_screen_windows=9, windows=4, stepped_firings=100)]
    traces = [_trace(0, 10)]
    assert _read("tree_stepped_share", monkeypatch, traces, records) == \
        pytest.approx(25.0)
    # No overloaded pair: no schedule screen, every firing analytic.
    assert _read("tree_stepped_share", monkeypatch, traces,
                 records[:2]) == 0.0


def test_conn_roofline_reads_the_kernel_evaluations(monkeypatch):
    conn = harness.load_reader("conn_roofline")
    records = [_span("sneap.partition.refine.eval", 1, 1.1, engine="kernel",
                     rows=64, inc_entries=2048, edges=4096, k=141),
               _span("sneap.partition.refine.eval", 2, 2.1, engine="kernel",
                     rows=3072, inc_entries=98_304, edges=4096, k=141),
               _span("sneap.partition.refine.eval", 3, 4,
                     engine="gather_host", rows=5000)]
    # 2 ms of device activity inside the refinement levels' spans, 1 ms
    # outside them.
    tr = _trace(0, 10, busy=[(1, 1.001), (2, 2.001), (6, 6.001)],
                spans={conn.SPAN: [(0, 2.5), (2.5, 5)]})
    nbytes = (conn.eval_bytes(64, 2048, 4096, 141)
              + conn.eval_bytes(3072, 98_304, 4096, 141))
    # Φ: a row an entry in the small call, the whole table in the large.
    assert nbytes == ((24 + 4 * 141) * (64 + 3072) + 8 * (2048 + 98_304)
                      + 4 * 141 * (2048 + 4096))
    got = _read("conn_roofline", monkeypatch, [tr], records)
    # (Intervals of a millisecond on the epoch clock keep ~1e-4 of it.)
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 0.002, rel=1e-3)
    assert 0 < got < 100
    # Host levels alone: no bytes, nothing to read.
    assert _read("conn_roofline", monkeypatch, [tr], records[2:]) is None
    # No refinement span in the trace: nothing to read.
    assert _read("conn_roofline", monkeypatch, [_trace(0, 10)],
                 records) is None


def test_conn_roofline_wraps_an_entry_of_the_program():
    conn = harness.load_reader("conn_roofline")
    ((module, attr),) = conn.SPANS
    assert conn.SPAN == f"bench.{attr}"
    assert callable(getattr(importlib.import_module(module), attr))


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_programs_recorder(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert program_spans.recorded() is None
    ctx = SimpleNamespace(traces=[_trace(0, 10, busy=[(1, 2)])], peaks=PEAKS)
    assert harness.load_reader(name).read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_program_keeps_no_such_span(monkeypatch, name):
    # A program before these spans: a level with no D* evaluation under it,
    # the unicast replay's spans, and spans outside every window.
    records = [_span("sneap.partition.refine", 1, 2, level=0, engine="vec"),
               _span("sneap.noc.order", 3, 4, records=10, local=2),
               _span("sneap.replay.windows", 4, 5, noc_packets=8),
               _span("sneap.replay.tree.links", 20, 21, firings=5)]
    tr = _trace(0, 10, busy=[(1, 2)],
                spans={"bench.refine_level_vec": [(1, 2)]})
    assert _read(name, monkeypatch, [tr], records) is None
    assert _read(name, monkeypatch, [], records) is None
