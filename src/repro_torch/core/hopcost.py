"""Average-hop evaluation (paper §3.4.2, Algorithm 1).

The paper's key engineering insight: under static XY routing the hop count
of a spike is just the Manhattan distance between source and destination
cores, so the search loop can score a candidate mapping analytically
instead of invoking a hardware simulator.  This file is the host/numpy
reference; `repro.kernels.hop_eval` is the Pallas TPU version and
`repro.kernels.swap_delta` batch-evaluates SA neighborhoods.

Two traffic models feed the evaluation (``traffic_matrix``'s ``cast``):

* ``"unicast"`` — one packet per spike transmission, i.e. per synapse
  crossing.  A neuron firing into d remote partitions is counted d_syn
  times (once per destination synapse) — the paper's Algorithm 1.
* ``"multicast"`` — one packet per (firing, destination partition): a
  neuron's fan-out into a partition is a single replicated packet, which
  is what a multicast NoC actually injects.  Requires the trace time
  stamps to identify firings.
"""
from __future__ import annotations

import numpy as np

from repro_torch.trace import dedupe_firings

__all__ = [
    "traffic_matrix",
    "core_coords",
    "hop_distance_matrix",
    "average_hop",
    "swap_delta",
    "swap_delta_batch",
]


def traffic_matrix(
    part: np.ndarray,
    trace_src: np.ndarray,
    trace_dst: np.ndarray,
    k: int,
    trace_t: np.ndarray | None = None,
    cast: str = "unicast",
) -> np.ndarray:
    """C[i, j] = number of packets sent from partition i to partition j.

    Built from the spike trace (Algorithm 1 lines 5-9); the diagonal holds
    intra-partition deliveries, which never enter the NoC (0 hops).
    ``cast="unicast"`` counts one packet per transmission; ``"multicast"``
    (requires ``trace_t``) deduplicates transmissions of one firing toward
    the same destination partition into a single packet.
    """
    pi = part[trace_src].astype(np.int64)
    pj = part[trace_dst].astype(np.int64)
    if cast == "multicast":
        if trace_t is None:
            raise ValueError("multicast traffic needs trace_t to identify firings")
        # One packet per distinct (firing, dest partition) — off-diagonal
        # only: intra-partition deliveries are synaptic events, not
        # packets, and keep their per-transmission counts so the matrix
        # totals match `nocsim.simulate_noc`'s accounting (which shares
        # `dedupe_firings` for the packet identity).
        remote = pi != pj
        _, rsrc, rpj, _ = dedupe_firings(trace_t[remote], trace_src[remote],
                                         pj[remote], int(part.shape[0]), k)
        pi = np.concatenate([pi[~remote], part[rsrc].astype(np.int64)])
        pj = np.concatenate([pj[~remote], rpj])
    elif cast != "unicast":
        raise ValueError(f"unknown cast {cast!r}")
    flat = np.bincount(pi * k + pj, minlength=k * k)
    return flat.reshape(k, k).astype(np.int64)


def core_coords(num_cores: int, mesh_w: int) -> np.ndarray:
    """(num_cores, 2) int array of (x, y) for row-major core ids."""
    ids = np.arange(num_cores)
    return np.stack([ids % mesh_w, ids // mesh_w], axis=1)


def hop_distance_matrix(num_cores: int, mesh_w: int, torus: bool = False) -> np.ndarray:
    """(num_cores, num_cores) hop distances under XY routing.

    `torus=False` is the paper's NoC mesh (plain Manhattan); `torus=True`
    is the TPU-ICI variant with wraparound links (used by the beyond-paper
    device-layout optimizer, see DESIGN.md §3).
    """
    c = core_coords(num_cores, mesh_w)
    dx = np.abs(c[:, None, 0] - c[None, :, 0])
    dy = np.abs(c[:, None, 1] - c[None, :, 1])
    if torus:
        w = mesh_w
        h = (num_cores + mesh_w - 1) // mesh_w
        dx = np.minimum(dx, w - dx)
        dy = np.minimum(dy, h - dy)
    return (dx + dy).astype(np.int32)


def average_hop(
    traffic: np.ndarray,
    placement: np.ndarray,
    dist: np.ndarray,
    trace_length: int,
) -> float:
    """H = sum_{a,b} d(M(a), M(b)) * C(a, b) / trace_length  (Algorithm 1)."""
    d = dist[placement[:, None], placement[None, :]]
    return float((d * traffic).sum() / trace_length)


def swap_delta(
    sym_traffic: np.ndarray,
    placement: np.ndarray,
    dist: np.ndarray,
    a: int,
    b: int,
) -> float:
    """Change in total hop-weighted traffic if partitions a and b swap cores.

    `sym_traffic` must be C + C.T.  O(k) instead of re-evaluating the full
    O(k^2) objective — the SA inner-loop trick.  Canonical definition of the
    formula; `repro.core.mapping_jax._delta_one` (device twin) and
    `repro.kernels.swap_delta` (all-pairs MXU batch) both implement it.
    """
    ca, cb = placement[a], placement[b]
    d_a = dist[ca, placement]
    d_b = dist[cb, placement]
    diff = (sym_traffic[a] - sym_traffic[b]) * (d_b - d_a)
    # Exclude j in {a, b}: the a<->b term is invariant (d symmetric) and the
    # self terms ride on the zero diagonal of dist but not of sym_traffic diff.
    return float(diff.sum() - diff[a] - diff[b])


def swap_delta_batch(
    sym_traffic: np.ndarray,
    placement: np.ndarray,
    dist: np.ndarray,
    aa: np.ndarray,
    bb: np.ndarray,
) -> np.ndarray:
    """`swap_delta` for B candidate pairs in one vectorized call.

    Returns the (B,) array of deltas for swapping ``(aa[i], bb[i])`` — each
    evaluated against the *same* ``placement`` (candidates are independent
    alternatives, not a sequence).  Canonical/reference form of the batch
    formula: the batched mapping engine's hot path is
    `placecost.PairwiseObjective.swap_delta_batch`, which computes the same
    quantity through its placement-permuted distance-column cache (and is
    pinned against this function by the engine tests); the all-pairs MXU
    form lives in `repro.kernels.swap_delta`.
    """
    aa = np.asarray(aa, dtype=np.int64)
    bb = np.asarray(bb, dtype=np.int64)
    d_a = dist[placement[aa][:, None], placement[None, :]]  # (B, K)
    d_b = dist[placement[bb][:, None], placement[None, :]]
    diff = (sym_traffic[aa] - sym_traffic[bb]) * (d_b - d_a)
    rows = np.arange(aa.shape[0])
    return diff.sum(axis=1) - diff[rows, aa] - diff[rows, bb]
