"""Straggler detection and data-shard rebalancing bookkeeping (host-side).

On a real cluster each host reports per-step wall times; the monitor flags
hosts whose trailing-window median exceeds `threshold` x the fleet median
and emits a rebalancing plan (move whole data shards away from stragglers,
in shard units so the deterministic pipeline stays pure).  The dry-run and
tests drive it with synthetic timings.  A host numpy copy of the
reference's `repro.runtime.health`; the fault scenario driver
(`repro_torch.runtime.faults.heartbeat_detect`) is its caller in the port.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["HeartbeatMonitor"]


@dataclass
class HeartbeatMonitor:
    num_hosts: int
    window: int = 16
    threshold: float = 1.5
    _times: dict = field(default_factory=lambda: defaultdict(deque))

    def report(self, host: int, step: int, seconds: float) -> None:
        q = self._times[host]
        q.append(seconds)
        if len(q) > self.window:
            q.popleft()

    def medians(self) -> np.ndarray:
        return np.array([
            np.median(self._times[h]) if self._times[h] else np.nan
            for h in range(self.num_hosts)
        ])

    def stragglers(self) -> list[int]:
        med = self.medians()
        fleet = np.nanmedian(med)
        if not np.isfinite(fleet):
            return []
        return [h for h in range(self.num_hosts)
                if np.isfinite(med[h]) and med[h] > self.threshold * fleet]

    def rebalance_plan(self, shards_per_host: dict[int, int]) -> dict[int, int]:
        """Return new shard counts: stragglers shed ~1/3 of their shards to
        the fastest hosts (shard-granular, total preserved)."""
        plan = dict(shards_per_host)
        lagging = self.stragglers()
        if not lagging:
            return plan
        med = self.medians()
        fast = sorted((h for h in plan if h not in lagging),
                      key=lambda h: med[h] if np.isfinite(med[h]) else np.inf)
        if not fast:
            return plan
        for i, h in enumerate(lagging):
            shed = max(plan[h] // 3, 1) if plan[h] > 1 else 0
            plan[h] -= shed
            plan[fast[i % len(fast)]] += shed
        return plan
