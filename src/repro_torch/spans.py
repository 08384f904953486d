"""Named spans and counts of the toolchain's steps, on the profiler's clock.

Every step of the SNEAP path opens a span named ``sneap.<layer>.<step>``
(``sneap.partition.refine``, ``sneap.sa.epoch``, ``sneap.replay.screen``
...) and adds the counts of its work to it (``s.add(packets=n)``).  A span
is on while a ``torch.profiler`` session records or while a `recording`
block is open; off, it reads that flag and does nothing else.  On, it
enters ``torch.profiler.record_function(name)`` where a profiler session
records (so the session's trace shows it beside the device activity),
stamps ``time.time_ns()`` inside that annotation at entry and at exit, and
keeps the span in a bounded buffer, innermost first.  ``time.time_ns()``
is the clock of the profiler's own events (Unix-epoch nanoseconds), so a
span's interval lies on the same axis as the kernels and copies that the
session records.  A span that waits for a device result is named
``....wait``: idle card inside a wait is the device's own pace, idle card
elsewhere is the host not feeding it.

To get the spans of a toolchain run::

    from repro_torch import spans

    spans.clear()
    with spans.recording():
        run_toolchain(profile, config=cfg)
    for s in spans.spans():
        print(s.name, s.seconds, s.attrs)

or run it under ``torch.profiler.profile(...)`` and read `spans()` after:
the profiler's trace then holds the same spans as user annotations.
`self_ns` gives each span's duration less its children's.  A root span
(``sneap.toolchain`` of `core.run_toolchain`, ``sneap.sweep`` of
`launch.sweep.run_sweep`, ``sneap.profile`` of `snn.profile_snn`) gives
every span under it its id as ``root``.

A `phase` span is also a clock: on or off, it reads the monotonic
``time.perf_counter_ns()`` at entry and exit, and its ``seconds`` (the
toolchain's ``phase_seconds``) come from those two reads.  No span opens inside a
CUDA graph capture, synchronises the device or reads a device value.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["Span", "CAPACITY", "span", "phase", "add", "recording",
           "spans", "clear", "dropped", "self_ns"]

# Spans the buffer keeps; the oldest are dropped (and counted) past it.
CAPACITY = 1 << 17


class Span(NamedTuple):
    """One closed span: ids (``parent`` 0 at a root), its name, its
    Unix-epoch nanoseconds at entry and exit, and its counts."""

    id: int
    parent: int
    root: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_buffer: deque[Span] = deque(maxlen=CAPACITY)
_stack: list = []  # the open spans, innermost last
_ids = itertools.count(1)
_dropped = 0
_recording = 0  # open `recording` blocks


def _on() -> bool:
    """Whether spans record: a `recording` block or a profiler session."""
    return _recording > 0 or _autograd_profiler._is_profiler_enabled


def _keep(s: Span) -> None:
    global _dropped
    if len(_buffer) == _buffer.maxlen:
        _dropped += 1
    _buffer.append(s)


class _Off:
    """The span of a step while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Open:
    """A span being timed; recorded at exit where ``record`` is set."""

    __slots__ = ("name", "attrs", "record", "id", "parent", "root",
                 "start_ns", "end_ns", "t0", "t1", "_annotation")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record = name, attrs, record
        self.t0 = self.t1 = 0
        self._annotation = None

    def __enter__(self):
        if self.record:
            if _autograd_profiler._is_profiler_enabled:
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            self.id = next(_ids)
            if _stack:
                self.parent, self.root = _stack[-1].id, _stack[-1].root
            else:
                self.parent, self.root = 0, self.id
            _stack.append(self)
            self.start_ns = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.record:
            self.end_ns = time.time_ns()
            if _stack and _stack[-1] is self:
                _stack.pop()
            _keep(Span(self.id, self.parent, self.root, self.name,
                       self.start_ns, self.end_ns, self.attrs))
            if self._annotation is not None:
                self._annotation.__exit__(*exc)
                self._annotation = None
        return False

    def __bool__(self):
        return self.record

    def add(self, **counts) -> None:
        """Add ``counts`` to the span's (a new key starts at 0)."""
        for key, value in counts.items():
            self.attrs[key] = self.attrs.get(key, 0) + value

    @property
    def seconds(self) -> float:
        """The span's duration on the monotonic clock, once closed."""
        return (self.t1 - self.t0) * 1e-9


def span(name: str, **attrs):
    """A context manager timing one step; ``attrs`` are its first counts.
    Off, the shared do-nothing span (false in a test, so a count that
    costs work is taken under ``if s:``)."""
    if not _on():
        return _OFF
    return _Open(name, attrs, True)


def phase(name: str, **attrs) -> _Open:
    """A span that is also a clock: it reads the monotonic clock whether
    tracing is on or off, and ``seconds`` is its duration once closed."""
    return _Open(name, attrs, _on())


def add(**counts) -> None:
    """Add ``counts`` to the innermost open span (the kernel wrappers'
    per-call shapes); nothing where tracing is off."""
    if _on() and _stack:
        _stack[-1].add(**counts)


@contextmanager
def recording():
    """Turn the spans on for the block, without a profiler session."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[Span]:
    """The buffer's spans, in the order they closed (not drained)."""
    return list(_buffer)


def clear() -> None:
    """Empty the buffer and zero its dropped count."""
    global _dropped
    _buffer.clear()
    _dropped = 0


def dropped() -> int:
    """Spans dropped from the buffer, oldest first, since `clear`."""
    return _dropped


def self_ns(records: list[Span]) -> dict[int, int]:
    """Each span's nanoseconds less those of its children among
    ``records`` (children do not overlap: the toolchain steps on one
    thread)."""
    out = {s.id: s.end_ns - s.start_ns for s in records}
    for s in records:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
