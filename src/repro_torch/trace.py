"""Spike-trace primitives shared by the partitioning and NoC layers.

Lives outside both ``repro.core`` and ``repro.nocsim`` so the multicast
packet identity has a single definition without either package importing
the other.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dedupe_firings"]


def dedupe_firings(
    trace_t: np.ndarray,
    trace_src: np.ndarray,
    dest: np.ndarray,
    num_neurons: int,
    num_dest: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One multicast packet per distinct (firing = (t, src neuron), destination).

    The single definition of the multicast packet identity, shared by the
    hop-cost traffic matrix (destinations are partitions) and the NoC
    replay (destinations are cores) so the two traffic models cannot
    drift.  ``num_dest`` is the destination id space.  Returns the
    deduplicated (t, src, dest, firing_id) arrays; ``firing_id`` is equal
    for all packets replicated from one firing.
    """
    key = ((trace_t.astype(np.int64) * num_neurons + trace_src.astype(np.int64))
           * num_dest + dest.astype(np.int64))
    uniq = np.unique(key)
    firing = uniq // num_dest
    return ((firing // num_neurons).astype(trace_t.dtype),
            firing % num_neurons, uniq % num_dest, firing)
