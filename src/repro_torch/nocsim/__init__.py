"""Trace-driven NoC simulator substrate (the toolchain's evaluation phase).

A Noxim++ substitute at the abstraction the paper measures: XY
deterministic routing on a W x H 2D mesh, per-link bandwidth limits per
cycle, per-core injection limits (a crossbar sends at most `capacity`
spikes per time step), and the four paper metrics — average spike latency,
dynamic energy, congestion count (Eq. 3) and edge variance (Eq. 4-5).

Two traffic models (``simulate_noc``'s ``cast``):

* ``unicast`` — every spike transmission is an independent packet; a
  neuron whose spikes fan out over d synapses injects d packets.  This is
  the replay model the paper's edge-cut objective implicitly assumes.
* ``multicast`` — one packet per (firing, destination core), delivered
  along the XY multicast tree (the union of the deterministic XY routes,
  which share their common prefix).  Link loads, edge variance and dynamic
  energy count each (firing, link) branch traversal once — the model the
  ``objective="volume"`` partitioning metric (`repro.core.graph.comm_volume`)
  optimizes, so partitioner and simulator measure the same quantity.  The
  queued replay simulates true tree-fork flits: one flit per firing forks
  at branch routers (`replay.queued_multicast_tree`), so latency and
  congestion are router-faithful rather than replica-based upper bounds.

The queued replay runs on the batched two-tier engine in `repro.nocsim.replay`
(contention screening + joint congested-window stepping); the scalar
reference engine survives as ``simulate_noc(engine="ref")`` for parity
diffs and as the replica-based multicast baseline.
"""
from .energy import EnergyModel
from .sim import NoCStats, dedupe_firings, simulate_noc
from .stats import combine_stats
from .xy import (
    link_count,
    link_endpoints,
    link_ids_for_routes,
    multicast_tree_links,
    multicast_tree_sizes,
    route_hops,
    routes_blocked,
)

__all__ = [
    "EnergyModel", "NoCStats", "combine_stats", "dedupe_firings",
    "simulate_noc", "link_count", "link_endpoints", "link_ids_for_routes",
    "multicast_tree_links", "multicast_tree_sizes", "route_hops",
    "routes_blocked",
]
