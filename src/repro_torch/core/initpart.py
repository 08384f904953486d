"""Initial partitioning step of the multilevel paradigm (paper §3.3).

Greedy region growing on the coarsest graph G_c: seed each partition with a
random unassigned vertex, then repeatedly pull in the unassigned vertex
connected to the partition by the heaviest edge, until the partition's
total vertex weight reaches the capacity bound (the number of neurons a
neuromorphic core can accommodate).

Two engines share the contract:

* the sequential heap walk (``impl="scalar"``) — grows one partition at a
  time to capacity, exactly the paper's loop; and
* a frontier-at-once vectorized grower (``impl="vec"``) — all k regions
  grow simultaneously in rounds: one ``np.maximum.at`` segment-argmax over
  the CSR arrays finds every unassigned vertex's heaviest edge into the
  assigned region, and a grouped-cumsum admission (identical to the vec
  refiner's) admits frontier vertices per partition in weight order under
  capacity.  No per-vertex Python work.

``impl="auto"`` (what the vec partitioning engine requests) picks the
vectorized grower unless the instance is a tight fit — when
``k * capacity`` barely exceeds the total vertex weight, round-based
balanced growth strands heavy vertices that only the one-region-at-a-time
heap walk can still pack, so the heap version stays the fallback there.
"""
from __future__ import annotations

import heapq

import numpy as np

from .graph import Graph, grouped_admission

__all__ = ["greedy_region_growing"]

# Tight-fit guard: below this slack factor the vectorized grower falls back
# to the sequential heap walk (see module docstring).
_VEC_MIN_SLACK = 1.05


def _place_leftovers(
    part: np.ndarray, pweight: np.ndarray, vwgt: np.ndarray, capacity: int
) -> np.ndarray:
    """Assign part==-1 vertices, heaviest first, to the lightest feasible
    partition (heavy-first packing wastes the least headroom)."""
    leftover = np.nonzero(part == -1)[0]
    for v in leftover[np.argsort(-vwgt[leftover], kind="stable")]:
        order = np.argsort(pweight, kind="stable")
        placed = False
        for p in order:
            if pweight[p] + vwgt[v] <= capacity:
                part[v] = p
                pweight[p] += vwgt[v]
                placed = True
                break
        if not placed:
            raise RuntimeError("could not place vertex within capacity — infeasible instance")
    return part


def _grow_scalar(
    graph: Graph, k: int, capacity: int, rng: np.random.Generator
) -> np.ndarray:
    n = graph.num_vertices
    part = np.full(n, -1, dtype=np.int64)
    pweight = np.zeros(k, dtype=np.int64)
    xadj, adjncy, adjwgt, vwgt = graph.xadj, graph.adjncy, graph.adjwgt, graph.vwgt
    seed_order = iter(rng.permutation(n))

    def next_seed() -> int | None:
        for s in seed_order:
            if part[s] == -1:
                return int(s)
        return None

    for p in range(k):
        seed = next_seed()
        if seed is None:
            break
        if pweight[p] + vwgt[seed] > capacity:
            continue  # degenerate: oversized single vertex for remaining space
        part[seed] = p
        pweight[p] += vwgt[seed]
        # Max-heap of (−edge weight, vertex) edges from the partition frontier.
        heap: list[tuple[int, int]] = []
        s, e = xadj[seed], xadj[seed + 1]
        for u, w in zip(adjncy[s:e], adjwgt[s:e]):
            heapq.heappush(heap, (-int(w), int(u)))
        while heap:
            negw, u = heapq.heappop(heap)
            if part[u] != -1:
                continue
            if pweight[p] + vwgt[u] > capacity:
                continue  # skip; a lighter frontier vertex may still fit
            part[u] = p
            pweight[p] += vwgt[u]
            s, e = xadj[u], xadj[u + 1]
            for v2, w2 in zip(adjncy[s:e], adjwgt[s:e]):
                if part[v2] == -1:
                    heapq.heappush(heap, (-int(w2), int(v2)))

    return _place_leftovers(part, pweight, vwgt, capacity)


def _grow_vec(
    graph: Graph, k: int, capacity: int, rng: np.random.Generator
) -> np.ndarray:
    n = graph.num_vertices
    part = np.full(n, -1, dtype=np.int64)
    pweight = np.zeros(k, dtype=np.int64)
    adjncy, adjwgt, vwgt = graph.adjncy, graph.adjwgt, graph.vwgt
    edge_src = graph.edge_src
    nbr = adjncy.astype(np.int64)

    # Seed every region at once with distinct random vertices that fit
    # (fewer seeds than regions when n < k; the extras stay empty).
    seeds = rng.permutation(n)[:k]
    fits = vwgt[seeds] <= capacity
    seeds = seeds[fits]
    seed_parts = np.arange(seeds.shape[0], dtype=np.int64)
    part[seeds] = seed_parts
    pweight[seed_parts] = vwgt[seeds]

    if int(adjwgt.max(initial=0)) >= (1 << 62) // max(k, 1):
        raise OverflowError("edge weights too large for the packed frontier keys")

    for _ in range(n):
        # Frontier: edges from an assigned vertex into an unassigned one.
        live = (part[edge_src] >= 0) & (part[nbr] == -1)
        if not live.any():
            break
        v_ids = nbr[live]
        # Heaviest-edge pull per unassigned vertex as one packed segment-max
        # (weight * k + partition; ties break toward the higher partition id).
        best = np.full(n, -1, dtype=np.int64)
        np.maximum.at(best, v_ids, adjwgt[live] * k + part[edge_src[live]])
        cand = np.nonzero(best >= 0)[0]
        bw = best[cand] // k
        bp = best[cand] % k
        # Admission: per partition, admit in pull-weight order while the
        # cumulative vertex weight fits in the remaining headroom (the
        # refiner's grouped-cumsum step, shared via graph.grouped_admission).
        order = np.lexsort((cand, -bw, bp))
        cand, bp = cand[order], bp[order]
        admit = grouped_admission(bp, vwgt[cand], capacity - pweight)
        if not admit.any():
            break  # every frontier vertex is blocked by capacity
        grown, gp = cand[admit], bp[admit]
        part[grown] = gp
        np.add.at(pweight, gp, vwgt[grown])

    try:
        return _place_leftovers(part, pweight, vwgt, capacity)
    except RuntimeError:
        # Round-based growth packed the regions too evenly to absorb a
        # heavy leftover; the one-region-at-a-time heap walk leaves more
        # uneven headroom, so retry with it before declaring infeasibility.
        return _grow_scalar(graph, k, capacity, rng)


def greedy_region_growing(
    graph: Graph,
    k: int,
    capacity: int,
    rng: np.random.Generator,
    impl: str = "scalar",
) -> np.ndarray:
    """Return part[v] in [0, k) with per-partition vertex weight <= capacity.

    ``impl``: "scalar" (sequential heap walk), "vec" (frontier-at-once
    rounds; falls back to scalar on tight-fit instances), or "auto"
    (vec when the instance has slack, scalar otherwise).
    """
    if impl not in ("scalar", "vec", "auto"):
        raise ValueError(f"unknown region-growing impl {impl!r}")
    if k * capacity < graph.total_vwgt:
        raise ValueError(
            f"infeasible: k={k} cores x capacity={capacity} < total weight {graph.total_vwgt}"
        )
    tight = k * capacity < _VEC_MIN_SLACK * graph.total_vwgt
    if impl in ("vec", "auto") and not tight:
        return _grow_vec(graph, k, capacity, rng)
    return _grow_scalar(graph, k, capacity, rng)
