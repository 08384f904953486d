"""Baseline toolchains the paper compares against (§5).

* SpiNeMap [Balaji et al., TVLSI'19]: SpiNeCluster — a greedy
  Kernighan–Lin partitioner that works directly on the *full* graph with
  per-partition priority queues over *all* vertices (no multilevel
  coarsening — this is why SNEAP wins 890x on partitioning time), plus
  SpiNePlacer — a PSO placement search.
* SCO [Lee et al., TACO'19]: sequential mapping that packs neurons into
  cores in index order to minimize core usage, with no communication
  optimization at all.

A host numpy copy of the reference's `repro.core.baselines`: both
baselines are serial host algorithms with no device work of their own,
so every result equals the reference's bitwise.  Their placements are
scored and replayed by the same pipeline phases as SNEAP's.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass

import numpy as np

from .graph import Graph, comm_volume, edge_cut, partition_weights, validate_partition
from .mapping import MappingResult, pso_search
from .partition import PartitionResult
from .refine import CutState, VolumeState

__all__ = ["greedy_kl_partition", "sco_partition", "sco_place"]


def greedy_kl_partition(
    graph: Graph,
    capacity: int = 256,
    k: int | None = None,
    seed: int = 0,
    max_passes: int = 8,
    slack: float = 1.10,
    max_k: int | None = None,
    objective: str = "cut",
) -> PartitionResult:
    """SpiNeCluster: greedy KL on the uncoarsened graph.

    Every pass scans *all* vertices into per-partition priority queues and
    greedily applies the best gain moves until none improve.  Identical
    objective to `sneap_partition` — ``"cut"`` (inter-partition spikes) or
    ``"volume"`` (multicast communication volume) under the capacity
    constraint — but no multilevel compression, so each pass is O(n log n)
    on the full graph and many passes are needed.
    """
    if objective not in ("cut", "volume"):
        raise ValueError(f"unknown objective {objective!r}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = graph.num_vertices
    total = graph.total_vwgt
    min_k = math.ceil(total / capacity)
    if k is None:
        k = max(min_k, math.ceil(min_k * slack))
        if max_k is not None:
            k = min(k, max_k)

    # Random balanced initial assignment (SpiNeMap starts unoptimized).
    part = np.repeat(np.arange(k), math.ceil(n / k))[:n]
    rng.shuffle(part)
    part = part.astype(np.int64)
    pweight = partition_weights(graph, part, k)
    state = (CutState if objective == "cut" else VolumeState)(graph, part, k)
    cut = state.score(part)
    counter = itertools.count()

    def degrees(v: int) -> tuple[int, np.ndarray]:
        return state.degrees(part, v)

    for _ in range(max_passes):
        start_cut = cut
        # k priority queues, all vertices considered (the "generalized KL"
        # the SNEAP paper contrasts against in §3.3).
        queues: list[list[tuple[int, int, int]]] = [[] for _ in range(k)]
        for v in range(n):
            internal, ext = degrees(v)
            if ext.sum() == 0:
                continue
            b = int(np.argmax(ext))
            gain = int(ext[b]) - internal
            heapq.heappush(queues[part[v]], (-gain, next(counter), v))
        moved = np.zeros(n, dtype=bool)
        improved = True
        while improved:
            improved = False
            # Greedy: take the globally best head among the k queues.
            best_q, best_gain = -1, None
            for q in range(k):
                while queues[q] and moved[queues[q][0][2]]:
                    heapq.heappop(queues[q])
                if queues[q]:
                    g = -queues[q][0][0]
                    if best_gain is None or g > best_gain:
                        best_q, best_gain = q, g
            if best_q < 0:
                break
            _, _, v = heapq.heappop(queues[best_q])
            internal, ext = degrees(v)
            order = np.argsort(-ext, kind="stable")
            for b in order:
                if ext[b] <= 0:
                    break
                gain = int(ext[b]) - internal
                if gain <= 0:
                    break
                if pweight[b] + graph.vwgt[v] > capacity:
                    continue
                src = int(part[v])
                part[v] = int(b)
                pweight[src] -= graph.vwgt[v]
                pweight[b] += graph.vwgt[v]
                state.apply_move(v, src, int(b))
                cut -= gain
                moved[v] = True
                improved = True
                break
        if cut >= start_cut:
            break
    seconds = time.perf_counter() - t0
    validate_partition(graph, part, k, capacity)
    assert cut == state.score(part)
    vol = comm_volume(graph.hyper, part) if graph.hyper is not None else None
    return PartitionResult(
        part=part, k=k, edge_cut=edge_cut(graph, part), capacity=capacity,
        num_levels=1, seconds=seconds, objective=objective, comm_volume=vol,
    )


def sco_partition(graph: Graph, capacity: int = 256,
                  objective: str = "cut") -> PartitionResult:
    """SCO: sequential packing — fill each core to capacity in neuron order.

    Minimizes the number of cores used; ignores spike traffic entirely
    (``objective`` only selects which metric the result reports as its
    optimization target — the packing is identical).
    """
    if objective not in ("cut", "volume"):
        raise ValueError(f"unknown objective {objective!r}")
    t0 = time.perf_counter()
    n = graph.num_vertices
    part = np.empty(n, dtype=np.int64)
    p, w = 0, 0
    for v in range(n):
        if w + graph.vwgt[v] > capacity:
            p += 1
            w = 0
        part[v] = p
        w += graph.vwgt[v]
    k = p + 1
    seconds = time.perf_counter() - t0
    validate_partition(graph, part, k, capacity)
    vol = comm_volume(graph.hyper, part) if graph.hyper is not None else None
    return PartitionResult(part=part, k=k, edge_cut=edge_cut(graph, part),
                           capacity=capacity, num_levels=1, seconds=seconds,
                           objective=objective, comm_volume=vol)


def sco_place(k: int, num_cores: int) -> MappingResult:
    """SCO placement: partitions land on cores in row-major sequence.

    No search runs, so no metric is computed here — ``avg_hop``/``tree_hop``
    start NaN/None and are filled by the pipeline's shared evaluator
    (`repro_torch.core.placecost.evaluate_placement`), the same code path every
    other method's reported hop comes from.
    """
    if k > num_cores:
        raise ValueError(f"{k} partitions > {num_cores} cores")
    return MappingResult(placement=np.arange(k, dtype=np.int64), avg_hop=float("nan"),
                         seconds=0.0, history=[], evaluations=0)


# SpiNeMap's placer is PSO; re-export for pipeline symmetry.
spinemap_place = pso_search
