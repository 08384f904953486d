"""The reader of ``vol_select_s``, the volume refiner's mover selection, on
hand-made spans: the selection spans of the traced jobs, by either engine,
and nothing where the program keeps none."""
from __future__ import annotations

import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

import harness
import program_spans
import tracing

S = namedtuple("S", "id parent root name start_ns end_ns attrs")
NS = 1_000_000_000
T0 = 1_800_000_000
SELECT = "sneap.partition.refine.select"


def _span(name, a, b, id=0, parent=0, **attrs):
    return S(id, parent, 0, name, int((T0 + a) * NS), int((T0 + b) * NS),
             attrs)


def _read(monkeypatch, traces, records):
    monkeypatch.setattr(program_spans, "recorded", lambda: records)
    ctx = SimpleNamespace(traces=traces, peaks={})
    return harness.load_reader("vol_select_s").read(ctx)


def _trace(w0, w1):
    return tracing.JobTrace(window=(T0 + w0, T0 + w1), busy=[], spans={})


def test_vol_select_s_sums_the_selection_spans_of_each_job(monkeypatch):
    records = [_span("sneap.partition.refine", 0, 4, id=1, engine="vec"),
               _span(SELECT, 0.5, 0.75, id=2, parent=1, engine="kernel",
                     candidates=40, pairs=1500, contended=30, rounds=2,
                     winners=21, escape=False),
               _span("sneap.partition.refine.eval", 1, 2, id=3, parent=1,
                     engine="kernel"),
               _span(SELECT, 2, 2.5, id=4, parent=1, engine="host",
                     escape=True),
               _span(SELECT, 12, 13, id=5, parent=6, engine="kernel"),
               _span(SELECT, 30, 31, id=7, parent=8, engine="kernel")]
    traces = [_trace(0, 10), _trace(11, 20)]
    assert _read(monkeypatch, traces, records) == pytest.approx(
        (0.25 + 0.5 + 1.0) / 2)


def test_vol_select_s_none_without_selection_spans(monkeypatch):
    # The parent program: levels and D* evaluations, no selection span.
    records = [_span("sneap.partition.refine", 0, 4, id=1, engine="vec"),
               _span("sneap.partition.refine.eval", 1, 2, id=2, parent=1,
                     engine="kernel")]
    assert _read(monkeypatch, [_trace(0, 10)], records) is None
    assert _read(monkeypatch, [], records) is None


def test_vol_select_s_none_without_the_programs_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert program_spans.recorded() is None
    ctx = SimpleNamespace(traces=[_trace(0, 10)], peaks={})
    assert harness.load_reader("vol_select_s").read(ctx) is None
