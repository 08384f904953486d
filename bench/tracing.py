"""Spans around the program's layer entries, and the device trace of a job.

In a traced run every entry that a per-layer metric names (``SPANS`` in its
file under ``bench/metrics``, a module and an attribute) is replaced, for the
run, by a wrapper that opens a ``torch.profiler.record_function`` span named
``bench.<attribute>`` and records the call's scalar arguments.  An entry that
does not exist fails the run.  Each job runs under a profiler session of its
own that ends with a marker kernel; a session whose trace lost the marker
(the profiler dropped its tail) is driven again, up to three times in all,
and the last is kept as it is.
"""
from __future__ import annotations

import importlib
import inspect
import time
from dataclasses import dataclass, field

__all__ = ["Hooks", "JobTrace", "traced_job", "merge", "overlap"]

END_MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Hooks:
    """Wrappers around ``(module, attribute)`` entries, installed for the
    life of the object (``close`` restores them)."""

    def __init__(self, entries, counters):
        import torch

        self.calls: dict[str, list[dict]] = {}
        self.counters = [(importlib.import_module(m), a) for m, a in counters]
        for mod, attr in self.counters:
            if not hasattr(mod, attr):
                raise RuntimeError(f"counter {mod.__name__}.{attr} is missing")
        self._saved = []
        for modname, attr in entries:
            mod = importlib.import_module(modname)
            inner = getattr(mod, attr, None)
            if inner is None:
                raise RuntimeError(f"span entry {modname}.{attr} is missing")
            if any(m is mod and a == attr for m, a, _ in self._saved):
                continue
            sig = inspect.signature(inner)
            calls = self.calls.setdefault(attr, [])

            def wrapper(*args, _inner=inner, _sig=sig, _calls=calls,
                        _name=f"bench.{attr}", **kwargs):
                bound = _sig.bind(*args, **kwargs)
                bound.apply_defaults()
                _calls.append({k: v for k, v in bound.arguments.items()
                               if isinstance(v, (int, float, str, bool))
                               or (isinstance(v, list)
                                   and all(hasattr(x, "shape") for x in v))})
                with torch.profiler.record_function(_name):
                    return _inner(*args, **kwargs)

            setattr(mod, attr, wrapper)
            self._saved.append((mod, attr, inner))

    def read_counters(self) -> dict:
        return {f"{m.__name__}.{a}": int(getattr(m, a)) for m, a in self.counters}

    def take_calls(self) -> dict:
        out = {k: list(v) for k, v in self.calls.items()}
        for v in self.calls.values():
            v.clear()
        return out

    def close(self) -> None:
        for mod, attr, inner in reversed(self._saved):
            setattr(mod, attr, inner)
        self._saved = []


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def overlap(merged: list[tuple[float, float]], a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in merged)


@dataclass
class JobTrace:
    """One job's trace, times in seconds on the profiler's clock."""

    window: tuple[float, float]
    busy: list[tuple[float, float]]  # merged device intervals
    ops: dict[str, float] = field(default_factory=dict)  # device s by name
    spans: dict[str, list[tuple[float, float]]] = field(default_factory=dict)

    def device_s(self, span: str) -> float | None:
        """Device seconds inside the named span's calls; None without one."""
        if span not in self.spans:
            return None
        return sum(overlap(self.busy, a, b) for a, b in self.spans[span])

    @property
    def busy_s(self) -> float:
        return overlap(self.busy, *self.window)

    def gaps(self) -> list[tuple[str, float]]:
        """Idle stretches of the device inside the window, each named by
        the innermost span around its middle."""
        w0, w1 = self.window
        out = []
        edges = [w0]
        for a, b in self.busy:
            if b > w0 and a < w1:
                edges += [max(a, w0), min(b, w1)]
        edges.append(w1)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [(y - x, name) for name, ivs in self.spans.items()
                      if name != "bench.job" for x, y in ivs if x <= mid <= y]
            out.append((min(inside)[1] if inside else "bench.job", b - a))
        return out


def _parse(events) -> tuple[JobTrace | None, bool]:
    """``events``: (kind, name, start s, end s), kind "device" or "span"."""
    spans: dict[str, list[tuple[float, float]]] = {}
    device, ops, marker = [], {}, False
    for kind, name, a, b in events:
        if kind == "device":
            if END_MARKER in name:
                marker = True
                continue
            device.append((a, b))
            ops[name] = ops.get(name, 0.0) + (b - a)
        elif name.startswith("bench."):
            spans.setdefault(name, []).append((a, b))
    if "bench.job" not in spans:
        return None, marker
    window = spans["bench.job"][0]
    return JobTrace(window=window, busy=merge(device), ops=ops, spans=spans), marker


def _events(prof):
    """The session's raw events as (kind, name, start s, end s): device
    activity (kernels, copies, fills) and the benchmark's spans."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        cuda = e.device_type() == DeviceType.CUDA
        span = e.is_user_annotation() or e.name().startswith("bench.")
        if span == cuda:
            continue  # a host op, or a span's mirror on the device timeline
        a = e.start_ns() * 1e-9
        yield ("device" if cuda else "span", e.name(), a, a + e.duration_ns() * 1e-9)


def traced_job(drive):
    """Run ``drive()`` under a profiler session (host ops and device
    activity); returns its result, the parsed trace, the attempts made and
    the seconds the reading took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.job"):
                out = drive()
                torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace, marker = _parse(_events(prof))
        parse_s = time.perf_counter() - t0
        if trace is not None and (marker or attempt == ATTEMPTS):
            return out, trace, attempt, parse_s
    raise RuntimeError("the profiler recorded no job span in any attempt")
