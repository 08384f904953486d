"""Plain checks of a partition and a placement against a profiled network.

Every count is taken over the synapses, each carrying the spikes its source
fired (``fire_counts``), which is the trace grouped by synapse: the edge cut
is the spikes on synapses whose ends lie in different partitions, the
average hop is the Manhattan distance between the cores of a synapse's ends,
weighted the same way, over all spikes (Eq. 2 of the paper).  Under the
multicast model the hop and the swap gain take its traffic matrix
(`multicast.traffic`) in place of the per-synapse spikes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["partition_checks", "placement_checks", "best_swap_gain"]


def _coords(cores: np.ndarray, mesh_w: int) -> tuple[np.ndarray, np.ndarray]:
    return cores % mesh_w, cores // mesh_w


def partition_checks(part: np.ndarray, k: int, edge_cut: int, capacity: int,
                     num_neurons: int, src: np.ndarray, dst: np.ndarray,
                     spikes: np.ndarray) -> dict:
    """``cap_over``: neurons over a core's capacity and neurons without a
    valid partition; ``cut_gap``: the reported cut against a recount."""
    part = np.asarray(part)
    bad = 0 if part.shape == (num_neurons,) else num_neurons
    if bad:
        return {"cap_over": bad, "cut_gap": abs(int(edge_cut))}
    valid = (part >= 0) & (part < k)
    sizes = np.bincount(part[valid], minlength=k)
    over = int(np.maximum(sizes - capacity, 0).sum())
    cut = int(spikes[part[src] != part[dst]].sum())
    return {"cap_over": over + int((~valid).sum()),
            "cut_gap": abs(int(edge_cut) - cut)}


def best_swap_gain(traffic: np.ndarray, placement: np.ndarray, num_cores: int,
                   mesh_w: int) -> float:
    """The largest share of the hop cost that one exchange of two cores'
    contents (a partition with a partition, or with a free core) would
    save; 0 at a swap-local optimum."""
    k = traffic.shape[0]
    sym = np.zeros((num_cores, num_cores), dtype=np.float64)
    sym[:k, :k] = traffic + traffic.T
    np.fill_diagonal(sym, 0.0)  # a partition's own spikes never travel
    free = np.setdiff1d(np.arange(num_cores), placement)
    cores = np.concatenate([placement, free])
    x, y = _coords(cores, mesh_w)
    dist = (np.abs(x[:, None] - x[None, :])
            + np.abs(y[:, None] - y[None, :])).astype(np.float64)
    cost = float((sym * dist).sum()) / 2.0
    # delta(a, b) = sum over m != a, b of (S[a,m] - S[b,m]) (D[b,m] - D[a,m])
    m = sym @ dist
    diag = np.diag(m)
    delta = m + m.T - diag[:, None] - diag[None, :] + 2.0 * sym * dist
    np.fill_diagonal(delta, np.inf)
    best = float(delta.min())
    return max(0.0, -best) / cost if cost > 0 else 0.0


def placement_checks(part: np.ndarray, k: int, placement: np.ndarray,
                     avg_hop: float, num_cores: int, mesh_w: int,
                     src: np.ndarray, dst: np.ndarray,
                     spikes: np.ndarray, traffic: np.ndarray | None = None,
                     swap: bool = True) -> dict:
    """``place_bad``: partitions without a core of their own on the mesh;
    ``hop_gap``: the reported avg_hop against a recount, relative;
    ``swap_gain``: `best_swap_gain` of the placement (left out unless
    ``swap``).  The traffic is one packet a synapse a spike, or the (k, k)
    ``traffic`` matrix of another model, whose sum is the hop's
    denominator."""
    placement = np.asarray(placement, dtype=np.int64)
    if placement.shape != (k,):
        return {"place_bad": max(k, 1), "hop_gap": float("inf"),
                "swap_gain": float("inf")}
    inside = (placement >= 0) & (placement < num_cores)
    bad = int((~inside).sum()) + (k - int(np.unique(placement[inside]).shape[0]))
    if bad:
        return {"place_bad": bad, "hop_gap": float("inf"),
                "swap_gain": float("inf")}
    x, y = _coords(placement, mesh_w)
    if traffic is None:
        ps, pd = part[src], part[dst]
        hops = np.abs(x[ps] - x[pd]) + np.abs(y[ps] - y[pd])
        total = int(spikes.sum())
        hop = float(int((spikes * hops).sum())) / max(total, 1)
        traffic = np.bincount(ps * k + pd, weights=spikes,
                              minlength=k * k).reshape(k, k)
    else:
        dist = (np.abs(x[:, None] - x[None, :])
                + np.abs(y[:, None] - y[None, :]))
        hop = float(int((traffic * dist).sum())) / max(int(traffic.sum()), 1)
    out = {"place_bad": 0,
           "hop_gap": abs(float(avg_hop) - hop) / hop if hop else abs(avg_hop)}
    if swap:
        out["swap_gain"] = best_swap_gain(traffic, placement, num_cores, mesh_w)
    return out
