"""Dynamic-energy model for spike traversal on the NoC.

The paper evaluates *dynamic* energy only (static energy is constant for a
fixed mesh, §5.3.2).  Dynamic energy is proportional to *link traversals*:
every traversal costs one router pass plus one inter-router wire pass.
Under unicast routing traversals equal spike-hops; under multicast XY-tree
routing a branch link is traversed once per firing regardless of how many
destinations lie beyond it, so callers pass the deduplicated tree-link
traversal count (see ``xy.multicast_tree_links``) instead of the
per-destination hop sum.  Constants are representative 32 nm figures
(ORION-class); all paper comparisons are ratios, so the absolute scale
cancels.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EnergyModel"]


@dataclass(frozen=True)
class EnergyModel:
    router_pj_per_spike: float = 0.98  # switch + arbitration per traversal
    link_pj_per_spike: float = 0.34  # wire pass per traversal
    local_pj_per_spike: float = 0.10  # core-local delivery (no NoC hop)

    @property
    def pj_per_traversal(self) -> float:
        return self.router_pj_per_spike + self.link_pj_per_spike

    def dynamic_energy_pj(self, link_traversals: int, local_spikes: int = 0) -> float:
        """One router+wire pass per link traversal (== hop for unicast,
        distinct (firing, link) tree branch for multicast), plus the
        core-local delivery cost."""
        return (float(link_traversals) * self.pj_per_traversal
                + float(local_spikes) * self.local_pj_per_spike)
