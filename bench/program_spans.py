"""The program's own spans over the traced jobs (``repro_torch.spans``).

The program records its steps as spans named ``sneap.<layer>.<step>``, with
their counts, on ``time.time_ns()``: the clock of the profiler's events, so
a span's interval lies on the axis of ``JobTrace.busy``.  A traced job's
spans are those whose start lies inside its ``JobTrace.window``; the
profiler's re-drives of a job repeat its spans, and only the kept attempt's
window counts.  Every reading is ``None`` where the program keeps no spans
(a program without ``repro_torch.spans``) or where no traced job holds a
span of the names read.
"""
from __future__ import annotations

import importlib

from tracing import merge, overlap

__all__ = ["recorded", "per_job", "seconds", "idle", "idle_outside",
           "count"]


def recorded() -> list | None:
    """The program's recorded spans, or None without a recorder."""
    try:
        mod = importlib.import_module("repro_torch.spans")
    except ImportError:
        return None
    return mod.spans()


def per_job(traces: list, records: list | None) -> list[list] | None:
    """Each traced job's spans, in the order of ``traces``."""
    if records is None or not traces:
        return None
    out = []
    for tr in traces:
        w0, w1 = tr.window
        out.append([s for s in records if w0 <= s.start_ns * 1e-9 <= w1])
    return out


def _intervals(spans: list, names) -> list[tuple[float, float]]:
    return [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans
            if s.name in names]


def seconds(jobs: list[list] | None, names) -> float | None:
    """Seconds inside the named spans, mean over the jobs."""
    if not jobs or not any(_intervals(j, names) for j in jobs):
        return None
    return sum(b - a for j in jobs for a, b in _intervals(j, names)) / len(jobs)


def _idle(trace, merged: list[tuple[float, float]]) -> float:
    return sum(b - a - overlap(trace.busy, a, b) for a, b in merged)


def idle(traces: list, jobs: list[list] | None, names) -> float | None:
    """Card-idle seconds inside the named spans, mean over the jobs."""
    if not jobs or not any(_intervals(j, names) for j in jobs):
        return None
    return sum(_idle(tr, merge(_intervals(j, names)))
               for tr, j in zip(traces, jobs)) / len(jobs)


def idle_outside(traces: list, jobs: list[list] | None, names,
                 inner) -> float | None:
    """Card-idle seconds inside the ``names`` spans and outside the
    ``inner`` ones, mean over the jobs."""
    if not jobs or not any(_intervals(j, names) for j in jobs):
        return None
    total = 0.0
    for tr, j in zip(traces, jobs):
        outer = merge(_intervals(j, names))
        clipped = [(max(a, x), min(b, y)) for a, b in _intervals(j, inner)
                   for x, y in outer if min(b, y) > max(a, x)]
        total += _idle(tr, outer) - _idle(tr, merge(clipped))
    return total / len(jobs)


def count(jobs: list[list] | None, name: str, key: str) -> int | None:
    """The sum of one count over the named spans of the jobs."""
    if not jobs:
        return None
    found = [s.attrs.get(key, 0) for j in jobs for s in j if s.name == name]
    return sum(found) if found else None
