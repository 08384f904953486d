"""Mapping phase: place partitions on the NoC mesh (paper §3.4).

Three heuristic searches over placements — Simulated Annealing (the
paper's winner), Particle Swarm Optimization (SpiNeMap's placer), and Tabu
search — all scored through a pluggable placement objective
(`repro.core.placecost`): the paper's pairwise Eq. 2 hop cost, or the
tree-hop objective whose cost is the hfire-weighted XY multicast-tree link
count (the quantity the tree-fork NoC replay actually measures under
``cast="multicast"``).

Placements are represented as a permutation of all `num_cores` cores: the
objective zero-pads with `num_cores - k` virtual partitions, so a "swap
with a virtual partition" implements moving a real partition to an empty
core.  All searches share the same neighborhood (swap two positions).

``sa_search`` has two engines, mirroring the partitioner's
``impl="scalar"|"vec"`` split:

* ``impl="scalar"`` — the paper-faithful serial chain: one proposal at a
  time, scored by the O(k) incremental delta.  The parity reference.
* ``impl="vec"`` — the batched engine: ``batch`` candidate swaps proposed
  per step, scored in one vectorized delta call (numpy, or the
  `repro_torch.kernels.swap_delta` all-pairs batch on the run's device via
  ``score_backend="auto"``), Metropolis acceptance applied elementwise,
  and a conflict-free (position-disjoint) accepted subset committed at
  once with an exact cost resync.

The reference's device searches (population SA, kernel-powered greedy
polish, island SA: ``"sa_jax"``, ``"polish"``, ``"island"``) are not
ported yet (ROADMAP queue 1, items 6 and 10); ``UNPORTED_MAPPERS`` names
them so the pipeline can refuse them with NotImplementedError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device

from .placecost import PairwiseObjective

__all__ = [
    "MappingResult",
    "pad_traffic",
    "sa_search",
    "tabu_search",
    "pso_search",
    "MAPPERS",
    "OBJECTIVE_AWARE_MAPPERS",
    "UNPORTED_MAPPERS",
]


@dataclass
class MappingResult:
    placement: np.ndarray  # (k,) core id per (real) partition
    avg_hop: float  # pairwise Eq. 2 average hops per packet (Fig. 5 units)
    seconds: float
    # Convergence history: (time_axis, best_cost) samples (Fig 5).  The
    # cost samples are in the units of the objective that DROVE the search
    # (the `objective` field below: "pairwise" = Eq. 2 avg hops per
    # packet, "tree" = avg multicast tree-link traversals per packet),
    # normalized by trace_length — do not mix histories across objectives
    # on one convergence plot without checking that field.  Host searches
    # record elapsed seconds for the time axis; device searches
    # (mapping_jax) run the whole chain inside one lax.scan where
    # wall-clock sampling is impossible, so they record the
    # temperature-epoch index instead and `seconds` holds the single
    # post-run elapsed measurement.
    history: list[tuple[float, float]] = field(default_factory=list)
    evaluations: int = 0
    # Average multicast tree-link traversals per packet of the final
    # placement (same normalization as avg_hop).  Filled by searches that
    # ran the tree objective; the pipeline's shared evaluator
    # (`placecost.evaluate_placement`) fills it for every method when the
    # profiled hypergraph is available.
    tree_hop: float | None = None
    # Which placement objective the search minimized — and hence the units
    # of the `history` samples ("pairwise" or "tree").
    objective: str = "pairwise"


def pad_traffic(traffic: np.ndarray, num_cores: int) -> np.ndarray:
    """Zero-pad a (k, k) traffic matrix to (num_cores, num_cores)."""
    k = traffic.shape[0]
    if k > num_cores:
        raise ValueError(f"{k} partitions > {num_cores} cores")
    out = np.zeros((num_cores, num_cores), dtype=np.float64)
    out[:k, :k] = traffic
    return out


def _resolve_objective(objective, traffic, num_cores, mesh_w, torus):
    """Default to the paper's pairwise objective when none is supplied."""
    if objective is None:
        return PairwiseObjective(traffic, num_cores, mesh_w, torus=torus)
    if objective.num_positions != num_cores:
        raise ValueError(
            f"objective built for {objective.num_positions} cores, got {num_cores}"
        )
    return objective


def _finalize(
    obj, best: np.ndarray, traffic: np.ndarray, num_cores: int, mesh_w: int,
    trace_length: int, torus: bool, start: float, history: list, evals: int,
) -> MappingResult:
    """Exact final scoring shared by all host searches.

    Recomputes the driving objective from scratch (guards incremental
    drift) and always reports the pairwise ``avg_hop`` — when the search
    ran the tree objective, the Eq. 2 score is evaluated on the side so
    Fig. 5 comparisons across objectives stay in one unit.
    """
    k = traffic.shape[0]
    score = obj.total(best) / trace_length
    seconds = time.perf_counter() - start
    history.append((seconds, score))
    if obj.name == "pairwise":
        avg_hop, tree_hop = float(score), None
    else:
        pw = PairwiseObjective(traffic, num_cores, mesh_w, torus=torus)
        avg_hop, tree_hop = float(pw.total(best) / trace_length), float(score)
    return MappingResult(
        placement=best[:k].copy(), avg_hop=avg_hop, seconds=seconds,
        history=history, evaluations=evals, tree_hop=tree_hop,
        objective=obj.name,
    )


def sa_search(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    seed: int = 0,
    time_budget: float | None = None,
    iters: int = 20_000,
    t0_frac: float = 0.25,
    alpha: float = 0.95,
    sweeps_per_temp: int | None = None,
    torus: bool = False,
    init: np.ndarray | None = None,
    impl: str = "scalar",
    batch: int = 256,
    score_backend: str = "numpy",
    objective=None,
    device: "str | torch.device" = "cuda",
) -> MappingResult:
    """Simulated annealing over placements (paper §3.4.1).

    Accepts uphill moves with prob exp(-delta/T); geometric cooling.  The
    O(k) incremental swap delta makes each step cheap — the analytic-eval
    insight that gives SNEAP its end-to-end speedup.  `init` seeds the
    chain (e.g. the identity layout for mesh-layout optimization); the
    returned best never regresses below the seed.

    ``impl="scalar"`` is the serial reference chain; ``impl="vec"`` scores
    ``batch`` proposals per step in one vectorized delta call and commits
    a conflict-free accepted subset (see the module docstring).  ``iters``
    counts *proposals* under both engines, so equal budgets do equal
    search work.  ``score_backend="auto"`` (vec + pairwise only) routes the
    batch scoring through the `kernels/swap_delta` all-pairs op on
    ``device`` — the CUDA kernel on the card, its plain PyTorch version on
    the CPU — instead of the numpy batch delta (``"numpy"``).  ``objective`` is a `repro.core.placecost` objective instance;
    None means the paper's pairwise Eq. 2 cost built from ``traffic``.
    """
    if impl not in ("scalar", "vec"):
        raise ValueError(f"unknown impl {impl!r}")
    dev = resolve_device(device)
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    k = traffic.shape[0]
    trace_length = max(trace_length, 1)  # zero-traffic profiles normalize by 1
    obj = _resolve_objective(objective, traffic, num_cores, mesh_w, torus)

    placement = (np.asarray(init, dtype=np.int64).copy() if init is not None
                 else rng.permutation(num_cores).astype(np.int64))
    cost = obj.attach(placement)
    best = placement.copy()
    best_cost = cost
    # Initial temperature: a fraction of the initial per-spike cost scale.
    T = max(t0_frac * cost / max(k, 1), 1e-9)
    if sweeps_per_temp is None:
        sweeps_per_temp = max(num_cores, 32)
    history = [(0.0, best_cost / trace_length)]
    evals = 0

    if impl == "vec":
        scorer = _make_batch_scorer(obj, num_cores, mesh_w, score_backend, dev)
        # On small meshes a large batch is mostly conflicts against one
        # placement state; clamp to ~2 proposals per position.
        batch = max(2, min(batch, 2 * num_cores))
        # Continuous form of the scalar engine's per-sweep geometric
        # cooling: after `batch` proposals the temperature has decayed by
        # the same factor a scalar chain's would over that many steps.
        cool = alpha ** (batch / sweeps_per_temp)
        it = 0
        while it < iters:
            aa = rng.integers(0, num_cores, size=batch)
            b0 = rng.integers(0, num_cores - 1, size=batch)
            bb = np.where(b0 >= aa, b0 + 1, b0)
            deltas = scorer(placement, aa, bb)
            evals += batch
            it += batch
            accept = (deltas <= 0) | (
                rng.random(batch) < np.exp(np.minimum(-deltas / T, 0.0))
            )
            idx = np.flatnonzero(accept)
            if idx.shape[0]:
                # Conflict-free subset, Luby-style: a candidate survives
                # iff it owns (= has the smallest index among candidates
                # touching) both of its positions; survivors are
                # position-disjoint, so their swaps commute.
                owner = np.full(num_cores, batch, dtype=np.int64)
                np.minimum.at(owner, aa[idx], idx)
                np.minimum.at(owner, bb[idx], idx)
                keep = idx[(owner[aa[idx]] == idx) & (owner[bb[idx]] == idx)]
                if keep.shape[0]:
                    cost = obj.apply_swaps(
                        np.stack([aa[keep], bb[keep]], axis=1)
                    )
                    if cost < best_cost - 1e-9:
                        best_cost = cost
                        best = placement.copy()
                        history.append(
                            (time.perf_counter() - start,
                             best_cost / trace_length)
                        )
            T = max(T * cool, 1e-12)
            if time_budget is not None and time.perf_counter() - start > time_budget:
                break
        return _finalize(obj, best, traffic, num_cores, mesh_w, trace_length,
                         torus, start, history, evals)

    it = 0
    while it < iters:
        improved_at_temp = False
        for _ in range(sweeps_per_temp):
            a = int(rng.integers(num_cores))
            b = int(rng.integers(num_cores - 1))
            b = b + 1 if b >= a else b
            delta = obj.swap_delta(a, b)
            evals += 1
            it += 1
            if delta <= 0 or rng.random() < np.exp(-delta / T):
                cost = obj.apply_swaps(np.array([[a, b]]), total_delta=delta)
                if cost < best_cost - 1e-9:
                    best_cost = cost
                    best = placement.copy()
                    improved_at_temp = True
                    history.append((time.perf_counter() - start, best_cost / trace_length))
            if time_budget is not None and time.perf_counter() - start > time_budget:
                it = iters
                break
        T *= alpha
        if T < 1e-12 and not improved_at_temp:
            break
    return _finalize(obj, best, traffic, num_cores, mesh_w, trace_length,
                     torus, start, history, evals)


def _make_batch_scorer(obj, num_cores: int, mesh_w: int, score_backend: str,
                       device: torch.device):
    """Candidate-batch scorer for the vec engine.

    "numpy" asks the objective itself (incremental batch delta); "auto"
    rescores the pairwise objective through the all-pairs
    `kernels/swap_delta` op on ``device`` and gathers the candidate pairs
    there (f32 — quality-equivalent, bitwise different from the f64 host
    deltas).  The symmetrized traffic stays resident on the device; per
    call only the placed coordinates and the candidate ids go up, and only
    the B gathered deltas come back.
    """
    if score_backend == "numpy":
        return lambda placement, aa, bb: obj.swap_delta_batch(aa, bb)
    if score_backend != "auto":
        raise ValueError(
            f"unknown score_backend {score_backend!r}; use 'numpy' or 'auto'")
    if obj.name != "pairwise":
        raise ValueError(
            f"score_backend={score_backend!r} supports only the pairwise "
            f"objective, not {obj.name!r}"
        )
    from repro_torch.kernels.swap_delta import swap_deltas_pairs

    from .hopcost import core_coords

    sym_d = torch.from_numpy(np.asarray(obj.sym, dtype=np.float32)).to(device)
    coords = core_coords(num_cores, mesh_w).astype(np.float32)
    x, y = coords[:, 0], coords[:, 1]

    def scorer(placement, aa, bb):
        deltas = swap_deltas_pairs(
            sym_d,
            torch.from_numpy(x[placement]).to(device),
            torch.from_numpy(y[placement]).to(device),
            torch.from_numpy(np.asarray(aa, dtype=np.int64)).to(device),
            torch.from_numpy(np.asarray(bb, dtype=np.int64)).to(device),
        )
        return deltas.cpu().numpy().astype(np.float64)

    return scorer


def tabu_search(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    seed: int = 0,
    time_budget: float | None = None,
    iters: int = 400,
    tenure: int | None = None,
    candidates: int = 256,
    torus: bool = False,
    objective=None,
) -> MappingResult:
    """Tabu search: best-of-candidate-swaps with a recency tabu list.

    The candidate neighborhood is scored in one batched delta call per
    step (the same vectorized scorer the vec SA engine uses), with
    selection semantics identical to the historical per-candidate loop:
    earliest strict minimum among non-tabu or aspirating candidates.
    """
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    trace_length = max(trace_length, 1)  # zero-traffic profiles normalize by 1
    obj = _resolve_objective(objective, traffic, num_cores, mesh_w, torus)
    if tenure is None:
        tenure = max(8, num_cores // 4)

    placement = rng.permutation(num_cores).astype(np.int64)
    cost = obj.attach(placement)
    best, best_cost = placement.copy(), cost
    tabu_until = np.zeros((num_cores, num_cores), dtype=np.int64)
    history = [(0.0, best_cost / trace_length)]
    evals = 0
    for step in range(iters):
        pa = rng.integers(0, num_cores, size=candidates)
        pb = rng.integers(0, num_cores, size=candidates)
        lo, hi = np.minimum(pa, pb), np.maximum(pa, pb)
        valid = lo != hi
        deltas = obj.swap_delta_batch(lo, hi)
        evals += int(valid.sum())
        is_tabu = tabu_until[lo, hi] > step
        aspires = cost + deltas < best_cost - 1e-9
        ok = valid & (~is_tabu | aspires)
        if not ok.any():
            break
        i = int(np.argmin(np.where(ok, deltas, np.inf)))
        a, b = int(lo[i]), int(hi[i])
        cost = obj.apply_swaps(np.array([[a, b]]), total_delta=float(deltas[i]))
        tabu_until[a, b] = step + tenure
        if cost < best_cost - 1e-9:
            best_cost = cost
            best = placement.copy()
            history.append((time.perf_counter() - start, best_cost / trace_length))
        if time_budget is not None and time.perf_counter() - start > time_budget:
            break
    return _finalize(obj, best, traffic, num_cores, mesh_w, trace_length,
                     torus, start, history, evals)


def pso_search(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    seed: int = 0,
    time_budget: float | None = None,
    iters: int = 200,
    swarm: int = 32,
    w: float = 0.72,
    c1: float = 1.49,
    c2: float = 1.49,
    torus: bool = False,
    objective=None,
) -> MappingResult:
    """Random-key PSO (SpiNeMap's placer, §2.2): particles are continuous
    priority vectors; argsort decodes a vector into a core permutation."""
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    trace_length = max(trace_length, 1)  # zero-traffic profiles normalize by 1
    obj = _resolve_objective(objective, traffic, num_cores, mesh_w, torus)

    def decode(x: np.ndarray) -> np.ndarray:
        return np.argsort(x).astype(np.int64)

    pos = rng.standard_normal((swarm, num_cores))
    vel = np.zeros_like(pos)
    pbest = pos.copy()
    pbest_cost = np.array([obj.total(decode(p)) for p in pos])
    g = int(np.argmin(pbest_cost))
    gbest, gbest_cost = pbest[g].copy(), float(pbest_cost[g])
    history = [(0.0, gbest_cost / trace_length)]
    evals = swarm
    for _ in range(iters):
        r1 = rng.random((swarm, num_cores))
        r2 = rng.random((swarm, num_cores))
        vel = w * vel + c1 * r1 * (pbest - pos) + c2 * r2 * (gbest[None, :] - pos)
        pos = pos + vel
        costs = np.array([obj.total(decode(p)) for p in pos])
        evals += swarm
        better = costs < pbest_cost
        pbest[better] = pos[better]
        pbest_cost[better] = costs[better]
        g = int(np.argmin(pbest_cost))
        if pbest_cost[g] < gbest_cost - 1e-9:
            gbest, gbest_cost = pbest[g].copy(), float(pbest_cost[g])
            history.append((time.perf_counter() - start, gbest_cost / trace_length))
        if time_budget is not None and time.perf_counter() - start > time_budget:
            break
    return _finalize(obj, decode(gbest), traffic, num_cores, mesh_w,
                     trace_length, torus, start, history, evals)


# One registry for every ported placement search.
MAPPERS = {
    "sa": sa_search,
    "pso": pso_search,
    "tabu": tabu_search,
}

# Mappers that accept an `objective=` placement objective.
OBJECTIVE_AWARE_MAPPERS = frozenset({"sa", "pso", "tabu"})

# The reference's device searches, not ported yet, with the ROADMAP
# queue 1 item that ports each.
UNPORTED_MAPPERS = {
    "sa_jax": "item 6: device searches",
    "polish": "item 6: device searches",
    "island": "item 10: island SA",
}
