"""SNEAP partitioning phase: the multilevel driver (paper §3.3).

Coarsening -> initial partitioning -> uncoarsening with refinement, under
the neuromorphic-core capacity constraint (<= `capacity` neurons/core).

Two interchangeable engines drive the coarsen/refine hot path:

* ``impl="scalar"`` — the paper-faithful sequential algorithms
  (`coarsen.heavy_edge_matching` + `refine.refine_level`): random-order
  matching and a one-vertex-at-a-time FM-style priority queue.  Best cut
  quality; per-vertex Python loops make it O(n) interpreter iterations.
* ``impl="vec"`` — array-parallel engine
  (`coarsen.heavy_edge_matching_vec` + `refine_vec.refine_level_vec`):
  round-based mutual-proposal matching and batched conflict-free
  positive-gain refinement, all as whole-array numpy passes (with the
  `kernels.gain_eval` CUDA kernel path on the card).  Within a few percent
  of the scalar cut at a tiny fraction of the time — the engine to use
  for ≳10^4-neuron graphs.

Two objectives drive both engines (selected by ``objective``):

* ``objective="cut"`` — minimize spikes on cut synapses (`graph.edge_cut`),
  the paper's stated metric.
* ``objective="volume"`` — minimize the connectivity-(λ−1) communication
  volume (`graph.comm_volume`) over the multicast hypergraph attached to
  the profiled graph: a source pays its fire count once per *distinct*
  remote destination partition, matching what the multicast NoC simulator
  measures.  Requires ``graph.hyper`` (set by `snn.simulate.profile_snn`).

Both produce `validate_partition`-clean results and share every other
knob; `benchmarks/bench_partition.py` tracks their cut/time trade-off.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

from .coarsen import coarsen
from .graph import (
    Graph,
    Hypergraph,
    comm_volume,
    edge_cut,
    partition_weights,
    validate_partition,
)
from .initpart import greedy_region_growing
from .refine import uncoarsen

__all__ = ["PartitionResult", "sneap_partition"]

# Below this vertex count the vec engine routes to the scalar algorithms:
# array-parallel passes have nothing to amortize on tiny graphs, while the
# scalar FM queue's stronger hill-climbing still matters there (small-k
# cuts are seed-sensitive and label-propagation-style refinement stalls).
_VEC_MIN_N = 1024


@dataclass
class PartitionResult:
    part: np.ndarray  # (n,) partition id per neuron
    k: int
    edge_cut: int  # spikes communicated between partitions ("global traffic")
    capacity: int
    num_levels: int
    seconds: float
    impl: str = "scalar"
    objective: str = "cut"  # which metric refinement optimized
    comm_volume: int | None = None  # connectivity-(λ−1) volume, when hyper known

    def partition_sizes(self, graph: Graph) -> np.ndarray:
        return partition_weights(graph, self.part, self.k)


def sneap_partition(
    graph: Graph,
    capacity: int = 256,
    k: int | None = None,
    seed: int = 0,
    coarsen_to: int | None = None,
    max_nonimproving: int = 64,
    slack: float = 1.10,
    max_k: int | None = None,
    impl: str = "scalar",
    objective: str = "cut",
    hyper: Hypergraph | None = None,
    plateau_rounds: int | None = None,
    shards=None,
    stream_levels: bool = False,
    device: "str | torch.device" = "cuda",
) -> PartitionResult:
    """Partition an SNN graph into k parts of <= `capacity` neurons each.

    Args:
      graph: spike-weighted CSR graph from the profiling phase.
      capacity: neurons per neuromorphic core (256 for the paper's crossbars).
      k: number of partitions; default = ceil(total_neurons / capacity) with
         ~10% slack so refinement has room to move vertices.
      slack: multiplies k upward when k is derived (never above feasibility).
      impl: "scalar" (sequential reference) or "vec" (array-parallel
         matching + batched refinement; see module docstring).  "vec"
         adapts: graphs under ``_VEC_MIN_N`` vertices run the scalar
         algorithms outright, and during uncoarsening small few-partition
         *cut* levels delegate to the scalar FM refiner (`refine_vec`
         bounds); volume levels always use the vec refiner (incremental Φ
         + plateau walk — faster than the λ-gain FM queue at equal
         quality).
      objective: "cut" (spikes on cut synapses) or "volume" (multicast
         communication volume over the hypergraph; see module docstring).
      hyper: multicast hypergraph; defaults to ``graph.hyper`` and, when
         passed explicitly, overrides it (without mutating the caller's
         graph).  Required for ``objective="volume"``; when present,
         ``comm_volume`` is reported on the result under either objective.
      plateau_rounds: stall budget of the vec refiner's Jet-style
         zero/negative-gain plateau walk (quality <-> time knob; None =
         per-objective default, 0 disables).  Ignored by ``impl="scalar"``.
      shards: the reference's device-sharded vec engine; not ported yet
         (ROADMAP queue 1, item 9), so anything but ``None`` raises
         NotImplementedError.
      stream_levels: spill each coarsening level to a temporary on-disk
         ``coarsen.LevelStore`` and uncoarsen out-of-core, holding at most
         two levels resident (vec impl only).  Same result as in-memory
         levels; trades re-load I/O for peak RSS.
      device: where the vec refiner's degree kernel runs (the card by
         default; raises where CUDA is absent unless ``device="cpu"``).
         Host logic is numpy either way, and the result does not depend
         on the device.
    """
    if impl not in ("scalar", "vec"):
        raise ValueError(f"unknown partitioning impl {impl!r}")
    if objective not in ("cut", "volume"):
        raise ValueError(f"unknown objective {objective!r}")
    if shards is not None:
        raise NotImplementedError(
            "shards= is not ported yet (ROADMAP queue 1, item 9: sharded "
            "partitioning)")
    dev = resolve_device(device)
    if hyper is not None:
        # An explicit hypergraph wins over the attached one; rebind on a
        # shallow copy so the caller's graph is not mutated.
        graph = dataclasses.replace(graph, hyper=hyper)
    hyper = graph.hyper
    if objective == "volume" and hyper is None:
        raise ValueError(
            "objective='volume' needs the multicast hypergraph: pass hyper= or "
            "use a graph profiled by snn.simulate.profile_snn"
        )
    requested_impl = impl
    if impl == "vec" and graph.num_vertices < _VEC_MIN_N:
        impl = "scalar"
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    total = graph.total_vwgt
    min_k = math.ceil(total / capacity)
    if k is None:
        k = max(min_k, math.ceil(min_k * slack))
        if max_k is not None:
            k = min(k, max_k)  # cannot exceed the mesh's core count
    if k < min_k:
        deficit = total - k * capacity
        raise ValueError(
            f"k={k} infeasible: {total} neurons exceed {k} cores x capacity "
            f"{capacity} = {k * capacity} slots by {deficit}; need >= {min_k} "
            f"cores (or {math.ceil(total / k)} capacity)"
        )
    if coarsen_to is None:
        coarsen_to = max(4 * k, 128)

    # Coarse vertices must stay well under capacity or region growing jams.
    max_vwgt = max(1, capacity // 3)
    store = None
    if stream_levels and impl == "vec":
        from .coarsen import LevelStore

        store = LevelStore()
    levels = coarsen(graph, rng, coarsen_to=coarsen_to, max_vwgt=max_vwgt,
                     impl=impl, contract_hyper=objective == "volume",
                     shards=shards if impl == "vec" else None, store=store)
    coarse_part = greedy_region_growing(
        levels[-1], k, capacity, rng,
        impl="auto" if impl == "vec" else "scalar",
    )
    if impl == "vec":
        from .refine_vec import uncoarsen_vec

        part, score = uncoarsen_vec(levels, coarse_part, k, capacity,
                                    max_nonimproving, objective=objective,
                                    plateau_rounds=plateau_rounds,
                                    shards=shards, device=dev)
    else:
        part, score = uncoarsen(levels, coarse_part, k, capacity,
                                max_nonimproving, objective=objective)
    num_levels = len(levels)
    if store is not None:
        store.close()
    seconds = time.perf_counter() - t0
    validate_partition(graph, part, k, capacity)
    if objective == "cut":
        cut = score
        assert cut == edge_cut(graph, part), "incremental cut bookkeeping diverged"
        vol = comm_volume(hyper, part) if hyper is not None else None
    else:
        vol = score
        assert vol == comm_volume(hyper, part), "incremental volume bookkeeping diverged"
        cut = edge_cut(graph, part)
    return PartitionResult(
        part=part, k=k, edge_cut=cut, capacity=capacity,
        num_levels=num_levels, seconds=seconds, impl=requested_impl,
        objective=objective, comm_volume=vol,
    )
