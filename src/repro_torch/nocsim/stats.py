"""Result record of a NoC replay (shared by every engine).

Lives in its own module so the scalar reference engine (`sim._queued_ref`),
the batched replay (`replay`), and the analytic path can all construct the
same record without import cycles.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

__all__ = ["NoCStats", "edge_stats", "combine_stats"]


@dataclass
class NoCStats:
    avg_latency: float  # cycles, averaged over NoC-traversing packets
    max_latency: int
    avg_hop: float
    total_hops: int
    congestion_count: int  # Eq. 3
    edge_variance: float  # Eq. 4-5
    dynamic_energy_pj: float
    num_noc_spikes: int  # NoC-traversing packets (deduplicated under multicast)
    num_local_spikes: int
    cycles_simulated: int
    # None only on hand-built records (engines always fill it); consumers
    # must guard — see `max_link_load`.
    per_link_hops: np.ndarray | None = field(repr=False, default=None)
    cast: str = "unicast"
    link_traversals: int = 0  # == total_hops for unicast; tree links for multicast
    # Fault accounting (repro.runtime.faults); both stay 0 on healthy
    # meshes so zero-fault records compare bit-identical to pre-fault ones.
    spikes_dropped: int = 0  # packets lost to dead endpoints / unroutable faults
    detour_hops: int = 0  # hops traversed on YX fault-escape routes

    def max_link_load(self) -> int:
        """Heaviest per-link traversal total (0 when loads were not kept)."""
        if self.per_link_hops is None or self.per_link_hops.size == 0:
            return 0
        return int(self.per_link_hops.max())


def edge_stats(per_link_hops: np.ndarray | None) -> float:
    """Edge variance (Eq. 4-5) of a per-link traversal histogram."""
    if per_link_hops is None or per_link_hops.size == 0:
        return 0.0
    return float(np.var(per_link_hops))


def combine_stats(parts: list[NoCStats]) -> NoCStats:
    """Aggregate per-segment replays into one trace-level record.

    The degraded scenario driver replays a trace in segments (between
    failure events, each possibly under a different mapping) and combines
    them here: counters and energies sum, packet-weighted means re-weight,
    maxima max, and edge variance is recomputed from the summed per-link
    histogram.  A single segment passes through unchanged.
    """
    if not parts:
        raise ValueError("combine_stats needs at least one segment")
    if len(parts) == 1:
        return parts[0]
    if len({p.cast for p in parts}) != 1:
        raise ValueError("segments mix casts")
    n_noc = sum(p.num_noc_spikes for p in parts)
    per_link = None
    if all(p.per_link_hops is not None for p in parts):
        per_link = np.sum([p.per_link_hops for p in parts], axis=0)
    return replace(
        parts[0],
        avg_latency=(sum(p.avg_latency * p.num_noc_spikes for p in parts)
                     / n_noc if n_noc else 0.0),
        max_latency=max(p.max_latency for p in parts),
        avg_hop=(sum(p.total_hops for p in parts) / n_noc if n_noc else 0.0),
        total_hops=sum(p.total_hops for p in parts),
        congestion_count=sum(p.congestion_count for p in parts),
        edge_variance=edge_stats(per_link),
        dynamic_energy_pj=sum(p.dynamic_energy_pj for p in parts),
        num_noc_spikes=n_noc,
        num_local_spikes=sum(p.num_local_spikes for p in parts),
        cycles_simulated=sum(p.cycles_simulated for p in parts),
        per_link_hops=per_link,
        link_traversals=sum(p.link_traversals for p in parts),
        spikes_dropped=sum(p.spikes_dropped for p in parts),
        detour_hops=sum(p.detour_hops for p in parts),
    )
