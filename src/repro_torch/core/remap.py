"""Incremental re-mapping after core failures (graceful degradation).

When cores die mid-run (see `repro_torch.runtime.faults`), the live mapping is
broken in two ways: neurons hosted on the failed cores are unreachable,
and — if the mesh was packed — there may no longer be enough live cores
for one partition each.  This module repairs the mapping with as little
neuron movement as possible:

1. **Eviction** (only when the dead partitions cannot simply relocate,
   i.e. more real partitions than live cores): neurons of the failed
   cores' partitions are redistributed into surviving partitions under
   the capacity constraint, targets chosen by their external partition
   degrees (the refiner's own gain rows, `refine_vec.partition_degrees` /
   `graph.volume_degrees`), admitted per target through
   `graph.grouped_admission` — then a *bounded* `refine_level_vec` pass
   (``plateau_rounds=0``, ``forbid`` = the vacated partitions) recovers
   local cut quality without unbounded churn.
2. **Warm-started placement search**: the batched SA engine restarts
   from the live placement under a `placecost.MigrationAwareObjective`,
   which prices every position that leaves its live core at
   ``migration_cost`` x its neuron count (and makes dead cores
   prohibitively expensive for non-empty partitions), so hop/tree-hop
   gains are traded against bytes actually moved between cores.

`scratch_remap` is the from-scratch baseline the paper-style benchmarks
compare against: re-partition the whole SNN onto the surviving cores and
search a fresh placement, ignoring where neurons currently live.  Both
strategies return a `RemapResult` whose ``neurons_migrated`` counts
neurons whose *physical core* changed — the degradation benchmark's
headline metric next to the degraded energy/latency.

A host numpy copy of the reference's `repro.core.remap`.  Every function
that reaches device work takes ``device`` (the card by default, the CPU
when the caller asks) and passes it on: the eviction's bounded
`refine_level_vec` pass (its degree kernel behind the size gates), the
scratch strategy's `sneap_partition`, and `mapping.sa_search` (whose
``score_backend="auto"`` scores on the `swap_delta` op).  Under
``device="cpu"`` nothing touches CUDA, and every result equals the
reference's bitwise.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .graph import (
    Graph,
    grouped_admission,
    partition_weights,
    validate_partition,
    volume_degrees,
)
from .hopcost import traffic_matrix
from .mapping import MappingResult, sa_search
from .partition import sneap_partition
from .placecost import MigrationAwareObjective, evaluate_placement, make_objective
from .refine_vec import partition_degrees, refine_level_vec

__all__ = [
    "RemapResult",
    "check_degraded_capacity",
    "evict_dead_partitions",
    "incremental_remap",
    "scratch_remap",
]


@dataclass
class RemapResult:
    part: np.ndarray  # (n,) repaired partition id per neuron
    placement: np.ndarray  # (num_cores,) full permutation, no real part on a dead core
    k: int
    strategy: str  # "incremental" | "scratch"
    neurons_migrated: int  # neurons whose physical core changed vs the live mapping
    neurons_evicted: int  # neurons reassigned out of failed partitions
    seconds: float
    mapping: MappingResult
    migration_cost: float  # per-neuron migration price the search used


def check_degraded_capacity(
    n_neurons: int, capacity: int, live_cores: int, what: str = "live cores"
) -> None:
    """Raise an actionable error when the degraded mesh cannot hold the SNN.

    Names the exact deficit: how many neurons exceed the surviving slot
    count and how many cores the network actually needs.
    """
    slots = int(capacity) * int(live_cores)
    n_neurons = int(n_neurons)
    if n_neurons > slots:
        deficit = n_neurons - slots
        need = math.ceil(n_neurons / max(int(capacity), 1))
        raise ValueError(
            f"degraded mesh infeasible: {n_neurons} neurons exceed "
            f"{live_cores} {what} x capacity {capacity} = {slots} slots by "
            f"{deficit}; the network needs >= {need} {what}"
        )


def _full_placement(placement: np.ndarray, num_cores: int) -> np.ndarray:
    """Extend a (k,) placement to a full (num_cores,) permutation.

    Virtual positions (empty partitions) take the unused cores in sorted
    order — they carry no traffic and no migration weight, so any
    deterministic completion is equivalent.
    """
    placement = np.asarray(placement, dtype=np.int64)
    if placement.shape[0] == num_cores:
        return placement.copy()
    used = np.zeros(num_cores, dtype=bool)
    used[placement] = True
    return np.concatenate([placement, np.flatnonzero(~used)])


def evict_dead_partitions(
    graph: Graph,
    part: np.ndarray,
    k: int,
    capacity: int,
    dead_parts: np.ndarray,
    objective: str = "cut",
    refine_iters: int = 8,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, int]:
    """Vacate ``dead_parts`` by moving their neurons into survivors.

    Returns (new part vector, neurons evicted).  Targets are chosen
    greedily by each evicted neuron's external degree toward surviving
    partitions (cut) or its connectivity degree D* (volume) — the same
    gain rows the batched refiner uses — and admitted per target under
    the remaining headroom; rejected neurons retarget next round.  A
    bounded `refine_level_vec` pass (``forbid`` = the vacated partitions,
    no plateau walk) then cleans up the greedy seams; ``refine_iters=0``
    skips it for a pure minimal-movement eviction.  ``device`` is where
    that pass's degree kernel runs.
    """
    part = np.asarray(part, dtype=np.int64).copy()
    dead_parts = np.asarray(dead_parts, dtype=np.int64)
    forbid = np.zeros(k, dtype=bool)
    forbid[dead_parts] = True
    evicted = np.flatnonzero(forbid[part])
    if evicted.shape[0] == 0:
        return part, 0
    total = int(graph.vwgt.sum())
    check_degraded_capacity(
        total, capacity, k - int(forbid.sum()), what="surviving partitions"
    )
    hyper = graph.hyper
    if objective == "volume" and hyper is None:
        raise ValueError("objective='volume' eviction requires graph.hyper")

    pweight = partition_weights(graph, part, k)
    vwgt = graph.vwgt
    if objective == "volume":
        deg = volume_degrees(hyper, part, k, rows=evicted)
    else:
        deg = partition_degrees(graph, part, k, rows=evicted)
    deg[:, forbid] = -np.inf  # never target a vacated partition

    done = np.zeros(evicted.shape[0], dtype=bool)
    while not done.all():
        idx = np.flatnonzero(~done)
        verts = evicted[idx]
        headroom = capacity - pweight
        feasible = headroom[None, :] >= vwgt[verts][:, None]
        score = np.where(feasible, deg[idx], -np.inf)
        tgt = np.argmax(score, axis=1)
        valid = np.isfinite(score[np.arange(verts.shape[0]), tgt])
        if not valid.any():
            stuck = int(vwgt[verts].sum())
            room = int(np.maximum(headroom[~forbid], 0).sum())
            raise ValueError(
                f"eviction stalled: {stuck} neuron weight from failed "
                f"partitions exceeds the surviving partitions' remaining "
                f"headroom {room} (deficit {stuck - room}) under capacity "
                f"{capacity}"
            )
        sel, tg = idx[valid], tgt[valid]
        gains = deg[sel, tg]
        order = np.lexsort((sel, -gains, tg))
        sel, tg = sel[order], tg[order]
        admit = grouped_admission(tg, vwgt[evicted[sel]], headroom)
        # The top candidate of every target group fits its pre-round
        # headroom by construction, so each round makes progress.
        adm_idx, adm_tgt = sel[admit], tg[admit]
        part[evicted[adm_idx]] = adm_tgt
        np.add.at(pweight, adm_tgt, vwgt[evicted[adm_idx]])
        done[adm_idx] = True

    if refine_iters:
        part, _ = refine_level_vec(
            graph, part, k, capacity, max_iters=refine_iters,
            objective=objective, plateau_rounds=0, forbid=forbid,
            device=device,
        )
    validate_partition(graph, part, k, capacity)
    if forbid[part].any():  # pragma: no cover - forbid mask guarantees this
        raise RuntimeError("refine repopulated a vacated partition")
    return part, int(evicted.shape[0])


def _repair_dead(obj, full: np.ndarray, real_pos: np.ndarray,
                 dead: np.ndarray) -> np.ndarray:
    """Force any real partition left on a dead core onto a live one.

    The forbid penalty makes such states prohibitively expensive, so the
    SA chain all but never ends in one — this is the deterministic safety
    net that turns "all but never" into "never": each offender swaps with
    the cheapest weightless position currently on a live core.
    """
    viol = np.flatnonzero(real_pos & dead[full])
    if viol.shape[0] == 0:
        return full
    obj.attach(full)
    for j in viol:
        free = np.flatnonzero(~real_pos & ~dead[full])
        if free.shape[0] == 0:
            raise RuntimeError("no live core left for a displaced partition")
        deltas = obj.swap_delta_batch(np.full(free.shape[0], j), free)
        obj.apply_swaps(np.array([[j, int(free[np.argmin(deltas)])]]))
    return full


def incremental_remap(
    graph: Graph,
    part: np.ndarray,
    placement: np.ndarray,
    dead_cores: np.ndarray,
    trace_t: np.ndarray,
    trace_src: np.ndarray,
    trace_dst: np.ndarray,
    mesh_w: int,
    mesh_h: int,
    capacity: int = 256,
    cast: str = "unicast",
    place_objective: str = "pairwise",
    partition_objective: str = "cut",
    migration_cost: float | str = "auto",
    refine_iters: int = 8,
    evict: bool | str = "auto",
    seed: int = 0,
    mapper_kwargs: dict | None = None,
    k: int | None = None,
    device: "str | torch.device" = "cuda",
) -> RemapResult:
    """Repair a live mapping around failed cores with minimal migration.

    ``part``/``placement`` are the live partition vector and placement
    ((k,) or full permutation); ``dead_cores`` the (num_cores,) failure
    mask.  Eviction runs only when required (``evict="auto"``: more real
    partitions than live cores) or forced (``evict=True``) — when the
    mesh has spare live cores, relocating a failed core's partition
    wholesale migrates exactly its own neurons and keeps the partition
    coherent, which is strictly cheaper than scattering it.

    ``migration_cost="auto"`` prices moving *every* neuron at the live
    placement's full objective cost — i.e. moving a fraction f of the SNN
    must buy at least a fraction f of the current hop cost.  Pass an
    explicit per-neuron cost to tilt the trade-off.  ``mapper_kwargs``
    forwards to `mapping.sa_search` (default ``impl="vec"``).  ``device``
    is where the eviction's refine kernel and the search's device scorer
    run.
    """
    t0 = time.perf_counter()
    num_cores = mesh_w * mesh_h
    dead = np.asarray(dead_cores, dtype=bool)
    if dead.shape[0] != num_cores:
        raise ValueError(
            f"dead_cores covers {dead.shape[0]} != {num_cores} cores"
        )
    part = np.asarray(part, dtype=np.int64)
    if k is None:
        k = int(part.max()) + 1
    total = int(graph.vwgt.sum())
    live_cores = num_cores - int(dead.sum())
    check_degraded_capacity(total, capacity, live_cores)
    old_full = _full_placement(placement, num_cores)
    w0 = partition_weights(graph, part, k)
    # Only *populated* partitions on dead cores need rescue; eviction is
    # mandatory only when the survivors plus the displaced can no longer
    # get one live core each (wholesale relocation is cheaper otherwise).
    dead_parts = np.flatnonzero(dead[old_full[:k]] & (w0 > 0))
    n_real = int((w0 > 0).sum())
    if evict is True:
        to_evict = dead_parts  # forced: vacate every failed partition
    elif evict == "auto" and n_real > live_cores:
        # Minimal merge: only the excess partitions beyond the live-core
        # count must dissolve; the other displaced ones relocate wholesale
        # (same neurons moved, partition kept coherent).  Evict the
        # smallest failed partitions — fewest neurons scattered.
        excess = n_real - live_cores
        to_evict = dead_parts[np.argsort(w0[dead_parts], kind="stable")[:excess]]
    else:
        to_evict = dead_parts[:0]
    part2, n_evicted = part.copy(), 0
    if to_evict.shape[0]:
        part2, n_evicted = evict_dead_partitions(
            graph, part2, k, capacity, to_evict,
            objective=partition_objective, refine_iters=refine_iters,
            device=device,
        )

    hyper = graph.hyper
    traffic = traffic_matrix(part2, trace_src, trace_dst, k,
                             trace_t=trace_t, cast=cast)
    trace_len = max(int(traffic.sum()), 1)
    base = make_objective(place_objective, traffic, num_cores, mesh_w,
                          mesh_h=mesh_h, hyper=hyper, part=part2)
    w = partition_weights(graph, part2, k).astype(np.float64)
    base_live = base.total(old_full)
    if migration_cost == "auto":
        migration_cost = base_live / max(total, 1)
    migration_cost = float(migration_cost)
    # Finite but unbeatable: no single swap's hop gain approaches 1e3x the
    # whole live cost, so SA never parks a real partition on a dead core —
    # yet deltas remain exact differences of totals (the metamorphic tests
    # check them on faulty meshes too).
    forbid_penalty = 1e3 * abs(base_live) + 1e6
    wrapper = MigrationAwareObjective(
        base, old_full, w, migration_cost, dead_cores=dead,
        forbid_penalty=forbid_penalty,
    )
    real_pos = np.zeros(num_cores, dtype=bool)
    real_pos[:k] = w > 0
    # Repair *before* the search: SA derives its initial temperature from
    # the seed placement's cost, and a seed still paying forbid penalties
    # (displaced partitions on their dead cores) would inflate T by ~1e3x
    # and turn the whole budget into a random walk.  Relocating the
    # violators first gives the chain a feasible, penalty-free start.
    start_full = _repair_dead(wrapper, old_full.copy(), real_pos, dead)
    mk = dict(impl="vec", device=device)
    mk.update(mapper_kwargs or {})
    mres = sa_search(traffic, num_cores, mesh_w, trace_len, seed=seed,
                     init=start_full, objective=wrapper, **mk)
    new_full = _full_placement(mres.placement, num_cores)
    new_full = _repair_dead(wrapper, new_full, real_pos, dead)
    mres.placement = new_full[:k].copy()
    mres.avg_hop, mres.tree_hop = evaluate_placement(
        mres.placement, traffic, num_cores, mesh_w, trace_len,
        mesh_h=mesh_h, hyper=hyper, part=part2,
    )

    moved = old_full[part] != new_full[part2]
    return RemapResult(
        part=part2, placement=new_full, k=k, strategy="incremental",
        neurons_migrated=int(graph.vwgt[moved].sum()),
        neurons_evicted=n_evicted,
        seconds=time.perf_counter() - t0, mapping=mres,
        migration_cost=migration_cost,
    )


def scratch_remap(
    graph: Graph,
    part: np.ndarray,
    placement: np.ndarray,
    dead_cores: np.ndarray,
    trace_t: np.ndarray,
    trace_src: np.ndarray,
    trace_dst: np.ndarray,
    mesh_w: int,
    mesh_h: int,
    capacity: int = 256,
    cast: str = "unicast",
    place_objective: str = "pairwise",
    partition_objective: str = "cut",
    partition_impl: str = "vec",
    seed: int = 0,
    mapper_kwargs: dict | None = None,
    partition_kwargs: dict | None = None,
    device: "str | torch.device" = "cuda",
) -> RemapResult:
    """From-scratch re-map onto the surviving cores (baseline strategy).

    Re-partitions the whole SNN (``max_k`` = live core count) and searches
    a fresh placement with migration priced at zero — only dead cores are
    forbidden.  The live mapping is used solely to count how many neurons
    the result would physically move.  ``device`` is where the
    re-partition's refine kernel and the search's device scorer run.
    """
    t0 = time.perf_counter()
    num_cores = mesh_w * mesh_h
    dead = np.asarray(dead_cores, dtype=bool)
    if dead.shape[0] != num_cores:
        raise ValueError(
            f"dead_cores covers {dead.shape[0]} != {num_cores} cores"
        )
    part = np.asarray(part, dtype=np.int64)
    total = int(graph.vwgt.sum())
    live_cores = num_cores - int(dead.sum())
    check_degraded_capacity(total, capacity, live_cores)
    old_full = _full_placement(placement, num_cores)

    pres = sneap_partition(
        graph, capacity=capacity, seed=seed, max_k=live_cores,
        impl=partition_impl, objective=partition_objective, device=device,
        **(partition_kwargs or {}),
    )
    part2, k2 = pres.part, pres.k
    hyper = graph.hyper
    traffic = traffic_matrix(part2, trace_src, trace_dst, k2,
                             trace_t=trace_t, cast=cast)
    trace_len = max(int(traffic.sum()), 1)
    base = make_objective(place_objective, traffic, num_cores, mesh_w,
                          mesh_h=mesh_h, hyper=hyper, part=part2)
    w = partition_weights(graph, part2, k2).astype(np.float64)
    # Deterministic feasible seed: real partitions on the first live
    # cores, everything else (spare live cores, then dead ones) after.
    live_ids = np.flatnonzero(~dead)
    init_full = np.concatenate([live_ids, np.flatnonzero(dead)])
    forbid_penalty = 1e3 * abs(base.total(init_full)) + 1e6
    wrapper = MigrationAwareObjective(
        base, init_full, w, migration_cost=0.0, dead_cores=dead,
        forbid_penalty=forbid_penalty,
    )
    mk = dict(impl="vec", device=device)
    mk.update(mapper_kwargs or {})
    mres = sa_search(traffic, num_cores, mesh_w, trace_len, seed=seed,
                     init=init_full, objective=wrapper, **mk)
    new_full = _full_placement(mres.placement, num_cores)
    real_pos = np.zeros(num_cores, dtype=bool)
    real_pos[:k2] = w > 0
    new_full = _repair_dead(wrapper, new_full, real_pos, dead)
    mres.placement = new_full[:k2].copy()
    mres.avg_hop, mres.tree_hop = evaluate_placement(
        mres.placement, traffic, num_cores, mesh_w, trace_len,
        mesh_h=mesh_h, hyper=hyper, part=part2,
    )

    moved = old_full[part] != new_full[part2]
    return RemapResult(
        part=part2, placement=new_full, k=k2, strategy="scratch",
        neurons_migrated=int(graph.vwgt[moved].sum()),
        neurons_evicted=0,
        seconds=time.perf_counter() - t0, mapping=mres,
        migration_cost=0.0,
    )
