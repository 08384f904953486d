"""The readers of the program's own spans, on hand-made traces and spans."""
from __future__ import annotations

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


def _span(name, a, b, **attrs):
    """A span from ``a`` to ``b`` seconds after T0."""
    return S(0, 0, 0, name, int((T0 + a) * NS), int((T0 + b) * NS), attrs)


def _trace(w0, w1, busy=()):
    return tracing.JobTrace(window=(T0 + w0, T0 + w1),
                            busy=[(T0 + a, T0 + b) for a, b in busy])


def _read(name, monkeypatch, traces, records):
    monkeypatch.setattr(program_spans, "recorded", lambda: records)
    return harness.load_reader(name).read(SimpleNamespace(traces=traces))


def test_window_keeps_the_kept_attempt_of_a_redriven_job(monkeypatch):
    # The job was driven twice: the first attempt's spans (0-10 s) lie
    # before the kept window (20-30 s) and are not read.
    records = [_span("sneap.partition.refine", 1, 4),
               _span("sneap.partition.refine", 21, 22),
               _span("sneap.partition.refine", 23, 23.5),
               _span("sneap.partition.refine", 41, 42)]  # the next job
    traces = [_trace(20, 30), _trace(40, 50)]
    jobs = program_spans.per_job(traces, records)
    assert [len(j) for j in jobs] == [2, 1]
    assert _read("refine_s", monkeypatch, traces, records) == pytest.approx(
        (1.5 + 1.0) / 2)


@pytest.mark.parametrize("name,spans,want", [
    ("extract_s", [("sneap.profile.extract", 0, 0.3),
                   ("sneap.profile.graph", 0.3, 0.4),
                   ("sneap.profile.lif", 0.4, 2.0)], 0.4),
    ("polish_s", [("sneap.polish", 1, 1.25), ("sneap.polish.wait", 1, 1.1)],
     0.25),
    ("stepper_s", [("sneap.replay.stepper", 2, 2.5),
                   ("sneap.replay.stepper.wait", 2.1, 2.2)], 0.5),
    ("screen_s", [("sneap.noc.order", 0, 0.1), ("sneap.replay.windows", 1, 2),
                  ("sneap.replay.screen", 2, 2.5),
                  ("sneap.replay.expand", 2.5, 3),
                  ("sneap.replay.schedule", 3, 3.25),
                  ("sneap.replay.stepper", 3.25, 5)], 2.35),
])
def test_seconds_sum_the_named_spans(monkeypatch, name, spans, want):
    records = [_span(*s) for s in spans]
    assert _read(name, monkeypatch, [_trace(0, 10)], records) == pytest.approx(
        want)


def test_idle_inside_spans():
    tr = _trace(0, 10, busy=[(1, 2), (3, 4)])
    records = [_span("sneap.sa.epoch", 0, 2.5), _span("sneap.sa.epoch", 2.5, 5)]
    jobs = program_spans.per_job([tr], records)
    # 5 s of spans less 2 s of device activity inside them.
    assert program_spans.idle([tr], jobs, ("sneap.sa.epoch",)) == pytest.approx(3)
    assert program_spans.idle([tr], jobs, ("sneap.polish",)) is None


def test_sa_host_s_reads_the_setup_and_the_capture_outside_waits(
        monkeypatch):
    # setup 0-2 s holding a wait 1.5-2; the capturing epoch 2-3; two
    # replayed epochs 3-5 and the polish 5-6 (not read); busy 0.5-1,
    # 2.5-2.7 and 3.2-3.4.
    tr = _trace(0, 20, busy=[(0.5, 1), (2.5, 2.7), (3.2, 3.4)])
    records = [_span("sneap.sa", 0, 6), _span("sneap.sa.setup", 0, 2),
               _span("sneap.sa.wait", 1.5, 2),
               _span("sneap.sa.epoch", 2, 3, captured=1),
               _span("sneap.sa.epoch", 3, 4), _span("sneap.sa.epoch", 4, 5),
               _span("sneap.polish", 5, 6)]
    # Idle in setup: 2 - 0.5 = 1.5, less 0.5 in its wait; in the capture:
    # 1 - 0.2.
    assert _read("sa_host_s", monkeypatch, [tr], records) == pytest.approx(
        1.8)
    # Without a capture (the graph kept from an earlier call, or the CPU):
    # the setup alone.
    del records[3]
    assert _read("sa_host_s", monkeypatch, [tr], records) == pytest.approx(
        1.0)


def test_stepped_share_is_over_the_noc_bound_packets(monkeypatch):
    records = [_span("sneap.noc.order", 0, 1, records=1000, local=400),
               _span("sneap.replay.windows", 1, 2, noc_packets=600),
               _span("sneap.replay.schedule", 2, 3, past_screen=200,
                     stepped=150)]
    assert _read("stepped_share", monkeypatch, [_trace(0, 10)],
                 records) == pytest.approx(25.0)
    # A job whose packets all pass the screens analytically steps none.
    assert _read("stepped_share", monkeypatch, [_trace(0, 10)],
                 records[:2]) == 0.0


READERS = ["extract_s", "refine_s", "sa_host_s", "polish_s", "screen_s",
           "stepper_s", "stepped_share"]


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_programs_recorder(monkeypatch, name):
    # The parent commit's program has no repro_torch.spans module.
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert program_spans.recorded() is None
    ctx = SimpleNamespace(traces=[_trace(0, 10, busy=[(1, 2)])])
    assert harness.load_reader(name).read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_cell_has_no_such_span(monkeypatch, name):
    # The map cell has no profile and no replay; spans outside every
    # window are not the traced jobs'.
    records = [_span("sneap.partition.refine", 20, 21),
               _span("sneap.sa", 30, 31), _span("sneap.sa.setup", 30, 30.5),
               _span("sneap.noc.analytic", 0, 1)]
    got = _read(name, monkeypatch, [_trace(0, 10)], records)
    assert got is None
    assert _read(name, monkeypatch, [], records) is None


def test_readers_declare_no_entries():
    for name in READERS:
        reader = harness.load_reader(name)
        assert not hasattr(reader, "SPANS") and not hasattr(reader, "COUNTERS")
