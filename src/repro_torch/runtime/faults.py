"""Deterministic fault model for the graceful-degradation scenario driver.

Real many-core neuromorphic platforms lose cores and links at run time;
this module gives the toolchain a seeded, reproducible way to say *when*
and *what*.  A `FaultSchedule` is a sorted list of `FaultEvent`s at
trace-window (SNN time step) granularity; folding the events up to a
window yields a `FaultState` — boolean dead-core / dead-link masks over
the mesh — which `repro_torch.nocsim.simulate_noc(faults=...)` turns into
routing consequences:

  * packets whose source or destination core is dead are **dropped**;
  * packets whose XY route crosses a dead link/core try the **YX escape
    route** (the other dimension order — still static, minimal and
    deadlock-free on what remains of the mesh) and are counted as
    detoured;
  * packets with both orders blocked are dropped.

An empty state (``FaultState.none``) short-circuits to ``faults=None``
inside the simulator, so zero-fault runs stay bit-identical to the
fault-free engines.

`heartbeat_detect` wires `repro_torch.runtime.health.HeartbeatMonitor` in as
the failure-*detection* source: dead cores report pathologically slow
synthetic step times, the monitor's straggler rule flags them, and the
scenario driver re-maps only after the detection window has elapsed —
the window during which spikes are genuinely lost.

A host numpy copy of the reference's `repro.runtime.faults`: the same
seed gives the same schedule, and the same masks the same replay.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.nocsim.xy import link_count, link_endpoints

__all__ = ["FaultEvent", "FaultState", "FaultSchedule", "heartbeat_detect"]


@dataclass(frozen=True)
class FaultEvent:
    """One failure: at window ``t``, the listed cores or links die."""

    t: int
    kind: str  # "core" | "link"
    ids: tuple[int, ...]

    def __post_init__(self):
        if self.kind not in ("core", "link"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        object.__setattr__(self, "ids", tuple(int(i) for i in self.ids))


@dataclass
class FaultState:
    """Cumulative platform health at one point in time (mesh masks)."""

    w: int
    h: int
    dead_cores: np.ndarray  # (w*h,) bool
    dead_links: np.ndarray  # (link_count(w, h),) bool

    @classmethod
    def none(cls, w: int, h: int) -> "FaultState":
        return cls(w, h, np.zeros(w * h, dtype=bool),
                   np.zeros(link_count(w, h), dtype=bool))

    def any(self) -> bool:
        return bool(self.dead_cores.any() or self.dead_links.any())

    def apply(self, event: FaultEvent) -> "FaultState":
        """New state with the event's failures added (inputs untouched)."""
        cores = self.dead_cores.copy()
        links = self.dead_links.copy()
        ids = np.asarray(event.ids, dtype=np.int64)
        if event.kind == "core":
            if ids.size and (ids.min() < 0 or ids.max() >= cores.shape[0]):
                raise ValueError(f"core ids {event.ids} outside mesh {self.w}x{self.h}")
            cores[ids] = True
        else:
            if ids.size and (ids.min() < 0 or ids.max() >= links.shape[0]):
                raise ValueError(f"link ids {event.ids} outside mesh {self.w}x{self.h}")
            links[ids] = True
        return FaultState(self.w, self.h, cores, links)

    def blocked_links(self) -> np.ndarray:
        """(nl,) mask of unusable links: dead ones plus every link whose
        tail or head router is dead (a dead core kills its whole router)."""
        nl = self.dead_links.shape[0]
        tail, head = link_endpoints(np.arange(nl), self.w, self.h)
        return self.dead_links | self.dead_cores[tail] | self.dead_cores[head]

    def alive_cores(self) -> np.ndarray:
        return np.flatnonzero(~self.dead_cores)


@dataclass
class FaultSchedule:
    """Time-sorted failure events over one trace replay."""

    events: list[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.t)

    def __len__(self) -> int:
        return len(self.events)

    def event_times(self) -> list[int]:
        return sorted({e.t for e in self.events})

    def events_at(self, t: int) -> list[FaultEvent]:
        return [e for e in self.events if e.t == t]

    def state_at(self, t: int, w: int, h: int) -> FaultState:
        """Cumulative `FaultState` with every event at or before ``t`` applied."""
        state = FaultState.none(w, h)
        for e in self.events:
            if e.t <= t:
                state = state.apply(e)
        return state

    @classmethod
    def random(
        cls,
        w: int,
        h: int,
        n_core_faults: int,
        t_max: int,
        n_link_faults: int = 0,
        seed: int = 0,
        t_min: int = 1,
    ) -> "FaultSchedule":
        """Seeded random schedule: distinct cores/links failing at distinct
        uniformly drawn windows in ``[t_min, t_max)`` — deterministic per
        seed, the generator the failure-rate benchmark sweeps."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        t_max = max(t_max, t_min + 1)
        if n_core_faults:
            cores = rng.choice(w * h, size=n_core_faults, replace=False)
            times = rng.integers(t_min, t_max, n_core_faults)
            events += [FaultEvent(int(t), "core", (int(c),))
                       for t, c in zip(times, cores)]
        if n_link_faults:
            links = rng.choice(link_count(w, h), size=n_link_faults,
                               replace=False)
            times = rng.integers(t_min, t_max, n_link_faults)
            events += [FaultEvent(int(t), "link", (int(l),))
                       for t, l in zip(times, links)]
        return cls(events)


def heartbeat_detect(monitor, dead_cores: np.ndarray,
                     base_s: float = 1.0, slow_factor: float = 8.0) -> list[int]:
    """Drive a `HeartbeatMonitor` with synthetic per-core step times and
    return the cores its straggler rule flags.

    Dead cores report ``slow_factor`` x the healthy step time for the
    monitor's full trailing window — the synthetic stand-in for a core
    that stopped making progress.  The scenario driver treats the returned
    straggler set (not the schedule itself) as the remap trigger, so the
    detection path exercises the same machinery a live deployment would.
    """
    dead_cores = np.asarray(dead_cores, dtype=bool)
    for step in range(monitor.window):
        for core in range(monitor.num_hosts):
            monitor.report(core, step,
                           base_s * slow_factor if dead_cores[core] else base_s)
    return monitor.stragglers()
