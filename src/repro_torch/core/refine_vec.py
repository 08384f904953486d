"""Array-parallel boundary refinement (the "vec" partitioning engine).

The scalar engine in ``refine.py`` follows the paper: a single global
priority queue pops one boundary vertex at a time, re-deriving its
per-partition degrees with a fresh ``np.bincount`` per pop.  That is O(n)
Python iterations per pass and dominates end-to-end partitioning time on
large SNNs.

This module is the Jet/label-propagation-style alternative: one shot of

    ``np.bincount(row * k + part[adjncy], weights=adjwgt)``

produces the external degree of *every* boundary vertex toward *every*
partition simultaneously; gains for all boundary vertices follow by
elementwise arithmetic, and a conflict-free batch of positive-gain moves
is applied per iteration:

1. every boundary vertex picks its best feasible target partition
   (capacity-checked against the pre-batch partition weights);
2. candidates adjacent to a higher-gain candidate are suppressed (one
   Luby-style round), so the surviving movers form an independent set and
   their gains are exact and additive;
3. movers are admitted in gain order per target partition under the
   remaining capacity (grouped cumulative-sum bookkeeping, no Python
   loop over vertices);
4. repeat until no positive-gain move exists (a fixed point).

Both objectives run through the same loop (selected by ``objective``):

* ``"cut"`` — the (rows, k) degree matrix above; conflicts are graph
  adjacency.
* ``"volume"`` — the degree matrix generalizes to the per-source
  distinct-partition presence matrix D* (λ-gain of a move =
  D*[v, b] − D*[v, own], exact), and conflicts are scoped per
  **(hyperedge, partition-column) slot**, not per hyperedge: a candidate
  move (v, a→b) touches the slots (e, a) and (e, b) of each incident
  hyperedge e, and a slot is *contended* only when at least two candidates
  touch it AND its member count Φ(e, c) sits near a presence threshold
  (Φ < 2, or Φ minus the slot's candidate leavers < 2).  On a thick slot
  no ±1 traffic can flip the [Φ > 0] / [Φ > 1] indicators any gain or
  cached D* row depends on, so arbitrarily many movers may share it with
  exactly additive gains; only near-threshold slots serialize to one
  max-priority winner per round.  This is the "fewer, fatter rounds"
  restructure: a hub hyperedge between well-populated partitions no longer
  throttles its members to one mover per round (the old per-hyperedge
  scoping's fixed-dispatch bound on fan-out graphs), while destination
  *capacity* contention stays exactly handled by grouped admission.  The
  member-count table Φ(e, p) behind D* is maintained *incrementally*
  across batches via the scalar engine's ``refine.VolumeState`` (one
  merged scatter per accepted mover set, the batch mirror of the FM
  queue's per-move delta updates) instead of being recounted from the
  partition vector every batch, and stale-gain invalidation applies the
  same critical-edge filter: only hyperedges where a move crossed a
  presence threshold re-activate their members.

The reference's sharded execution (``shards=``) is not ported yet
(ROADMAP queue 1, item 9); ``shards`` other than None raises.

When the positive-gain fixed point is reached the engine does not stop:
a bounded Jet-style **plateau walk** runs zero- and bounded-negative-gain
escape rounds (``gain >= -plateau_eps * internal``) through the same
Luby/admission machinery, with two oscillation guards — a per-vertex move
cooldown (a plateau mover sits out the next ``plateau_cooldown`` escape
rounds) and best-seen rollback (the best partition observed is restored on
exit, so the returned objective never regresses).  Each escape either
opens new positive-gain moves (resetting the budget when a new best is
reached) or burns one of ``plateau_rounds`` stall credits.  This is what
lets the batch engine match the scalar FM queue's hill-climbing on volume
plateaus without delegating levels to its O(n)-Python queue.

For large k the dense per-partition degree matrix is also expressible as
``A @ onehot(part)``; ``repro_torch.kernels.gain_eval`` computes its rows
(a per-row partition histogram in a CUDA kernel) and is used here when
running on the card with a graph small enough to densify (coarse levels).
The dense adjacency is uploaded once per level; only the partition vector
and the requested rows move per evaluation.  The volume objective's dense
form ``B @ presence`` (the reference's connectivity-mode kernel) is not
ported yet: volume levels keep the numpy paths.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .graph import (
    Graph,
    Hypergraph,
    _mix64,
    comm_volume,
    csr_gather as _csr_gather,
    edge_cut,
    edge_partition_counts,
    grouped_admission,
    partition_weights,
    volume_degrees,
)
from .refine import _MAX_DEG_ENTRIES, VolumeState, project, refine_level

__all__ = ["partition_degrees", "refine_level_vec", "uncoarsen_vec"]

# Small-problem delegation bounds for the *cut* objective.  At few
# partitions the batched positive-gain passes benefit from the scalar FM
# queue's stronger hill-climbing, and the queue is cheap there — so
# `uncoarsen_vec` hands cut levels with n * k <= _SCALAR_NK and
# k <= _SCALAR_MAX_K to the scalar refiner.  Both bounds matter: FM's
# per-move cost grows with k (a bincount plus a sort of the k-wide degree
# vector per queue operation), so delegating a many-partition level would
# burn the very speedup this module exists for.  Volume levels are *never*
# delegated: λ-gain queue operations touch every member of every incident
# hyperedge (fan-out × heavier than a cut bincount, and worst at coarse
# levels where incidence density peaks), and the plateau walk closes the
# quality gap the delegation used to paper over.
_SCALAR_NK = 1 << 20
_SCALAR_MAX_K = 64

# Plateau-walk defaults: stall credits (consecutive escape rounds without
# a new best) per objective, negative-gain tolerance as a fraction of the
# vertex's internal degree, and the mover cooldown in escape rounds.
# eps = 1.0 admits every move toward a partition the vertex has *any*
# external presence in (gain >= -internal, the full boundary) — on
# capacity-tight landscapes the barrier is feasibility rather than a
# zero-gain plateau, and deep-negative first steps are what open chains
# that scalar FM finds with its tentative-move window; larger eps is
# equivalent (the external-presence condition already binds) and smaller
# eps strands the walk at the first capacity wall.  The cut objective
# keeps the walk off by default: its quality gap to scalar FM was already
# within a few percent and the walk would spend the engine's headline
# speed advantage on it.
_PLATEAU_ROUNDS = {"cut": 0, "volume": 12}
_PLATEAU_EPS = 1.0
_PLATEAU_COOLDOWN = 2
# Stall credits refund only on *meaningful* improvement (this fraction of
# the best objective, at least 1): the jittered escapes keep shaving
# epsilons off forever, and refunding on every new best would let the
# walk's tail consume multiples of the descent phase's time.  A hard cap
# of _PLATEAU_TOTAL x the credit budget bounds total escapes regardless.
_PLATEAU_TOL = 0.002
_PLATEAU_TOTAL = 8
# Iteration safety net per objective: plateau escapes + recovery need far
# more (cheap, active-set-bounded) iterations than pure positive descent.
_MAX_ITERS = {"cut": 200, "volume": 2000}

# Conflict-free mover selection runs this many iterated Luby rounds per
# batch (see ``select_movers``).
_LUBY_ROUNDS = 4

# Densifying for the gain_eval kernel is only worthwhile on the card and only
# for problems whose dense form fits comfortably in HBM (adjacency (n, n)
# for cut; incidence (n, E) for volume).
_KERNEL_MAX_N = 4096
_KERNEL_MIN_K = 64

# Live (E, k) int32 Φ table cap (~128 MB): above it the volume path falls
# back to from-scratch per-chunk recounts instead of incremental updates.
_PHI_MAX_ENTRIES = 32_000_000

# Slot-contention counts come from whole-table ``np.bincount`` passes while
# the Φ table stays under this entry count (~8 MB int64 per count — a tight
# C loop with no zeroing pass); larger tables use persistent int32 count
# buffers updated with ``np.add.at`` and zeroed at the touched keys only.
_SLOT_BINCOUNT_MAX = 1 << 20

# Cached (n, k) degree/D* matrix cap (~128 MB float64).  Degree rows are
# independent of partition *weights* — only target choice is — so caching
# them makes capacity-retargeting a pure masked argmax over cached rows
# instead of a fresh incidence gather per stale target.
_DEG_CACHE_ENTRIES = 16_000_000

# Coarse volume levels are incidence-dense (hyperedges outlive vertices
# under contraction, so per-vertex incidence degree grows every level) and
# the per-pair gather epilogue becomes indexing-overhead-bound there.  When
# the dense (n, E) member-incidence matrix fits this entry cap (~64 MB of
# float64), D* rows come from one BLAS matmul against the live Φ presence
# instead — the CPU mirror of the gain_eval kernel's connectivity mode.
_DENSE_EVAL_ENTRIES = 8_000_000

# Boundary batches share `refine._MAX_DEG_ENTRIES`: rows * k entries per
# evaluation chunk (~128 MB of float64); larger boundaries are swept in
# row chunks.


def _refuse_shards(shards) -> None:
    if shards is not None:
        raise NotImplementedError(
            "shards= is not ported yet (ROADMAP queue 1, item 9: sharded "
            "partitioning)")


def _row_edges(graph: Graph, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather the CSR edges of ``rows``: (edge index array, local row id array)."""
    return _csr_gather(graph.xadj, rows)


def partition_degrees(
    graph: Graph,
    part: np.ndarray,
    k: int,
    rows: np.ndarray | None = None,
) -> np.ndarray:
    """(R, k) weighted histogram of neighbor partitions for each row vertex.

    Column ``part[v]`` of row v holds v's internal degree; every other
    column b holds the external degree ED[v]_b.  ``rows=None`` computes all
    n rows (the issue's one-shot formula); passing the boundary-vertex
    subset keeps the matrix small on fine levels.
    """
    if rows is None:
        rows = np.arange(graph.num_vertices, dtype=np.int64)
    eidx, local = _row_edges(graph, rows)
    deg = np.bincount(
        local * k + part[graph.adjncy[eidx]].astype(np.int64),
        weights=graph.adjwgt[eidx],
        minlength=rows.shape[0] * k,
    )
    return deg.reshape(rows.shape[0], k)


def _dense_adjacency(graph: Graph) -> np.ndarray:
    """(n, n) f32 dense adjacency for the gain_eval kernel path."""
    n = graph.num_vertices
    adj = np.zeros((n, n), dtype=np.float32)
    adj[graph.edge_src, graph.adjncy] = graph.adjwgt
    return adj


def _dense_incidence(hyper: Hypergraph) -> np.ndarray:
    """(n, E) f32 member incidence, hfire-weighted, for the connectivity mode."""
    inc = np.zeros((hyper.num_vertices, hyper.num_hyperedges), dtype=np.float32)
    e_ids = np.arange(hyper.num_hyperedges)
    inc[hyper.hsrc.astype(np.int64), e_ids] = hyper.hfire
    inc[hyper.hpins.astype(np.int64), hyper.pin_edge] = hyper.hfire[hyper.pin_edge]
    return inc


def _degrees_via_kernel(adj: torch.Tensor, part: np.ndarray, k: int,
                        rows: np.ndarray) -> np.ndarray:
    """Row-subset degrees via the gain_eval kernel on ``adj``'s device.

    ``adj`` is the level's dense adjacency, already resident there; the
    partition vector and row ids are uploaded per call and only the
    (rows, k) result comes back, as float64 like the numpy path's.
    """
    from repro_torch.kernels.gain_eval import part_degrees

    dev = adj.device
    deg = part_degrees(adj, torch.from_numpy(part.astype(np.int32)).to(dev), k,
                       torch.from_numpy(rows.astype(np.int64)).to(dev))
    return deg.cpu().numpy().astype(np.float64)


def refine_level_vec(
    graph: Graph,
    part: np.ndarray,
    k: int,
    capacity: int,
    max_iters: int | None = None,
    use_kernel: bool | None = None,
    objective: str = "cut",
    plateau_rounds: int | None = None,
    plateau_eps: float = _PLATEAU_EPS,
    plateau_cooldown: int = _PLATEAU_COOLDOWN,
    stats: dict | None = None,
    forbid: np.ndarray | None = None,
    shards=None,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, int]:
    """Refine ``part`` by batched moves; returns (part, score).

    ``shards`` is the reference's sharded execution mode, not ported yet:
    anything but None raises NotImplementedError.

    ``forbid`` is an optional (k,) boolean mask of partitions that may not
    *receive* movers (their effective capacity is zero); vertices already
    inside one are still free to leave.  The degraded re-mapper uses it to
    keep the post-eviction refine from repopulating partitions whose cores
    failed.

    ``score`` is the edge cut or communication volume per ``objective``.
    Positive-gain batches run to a fixed point; then up to
    ``plateau_rounds`` Jet-style zero/negative-gain escape rounds
    (tolerance ``-plateau_eps * internal degree``, per-vertex cooldown of
    ``plateau_cooldown`` rounds, best-seen rollback on exit) walk the
    engine off plateaus — the returned score is the best observed and
    never exceeds the input's.  ``plateau_rounds=None`` picks the
    per-objective default (see ``_PLATEAU_ROUNDS``); 0 disables the walk.

    ``use_kernel=None`` auto-enables the gain_eval kernel path when
    ``device`` is the card, for cut levels small enough to densify — and
    only when the total weight fits in float32's exact-integer range
    (< 2^24), since the kernel accumulates spike counts in f32 and the
    incremental bookkeeping demands exact integer gains.  True forces the
    path on ``device`` (on the CPU it runs the kernel's plain PyTorch
    version, which the tests use), False keeps the pure-numpy (exact
    float64) bincount path.  The volume objective's kernel is not ported:
    ``use_kernel=True`` with ``objective="volume"`` raises.
    """
    if objective not in ("cut", "volume"):
        raise ValueError(f"unknown objective {objective!r}")
    if use_kernel and objective == "volume":
        raise NotImplementedError(
            "use_kernel=True with objective='volume' needs the connectivity "
            "kernel, not ported yet (ROADMAP queue 2: connectivity_matmul)")
    _refuse_shards(shards)
    dev = resolve_device(device)
    hyper = graph.hyper
    if objective == "volume" and hyper is None:
        raise ValueError("objective='volume' requires graph.hyper")
    part = part.astype(np.int64).copy()
    n = graph.num_vertices
    adjncy, adjwgt, vwgt = graph.adjncy, graph.adjwgt, graph.vwgt
    pweight = partition_weights(graph, part, k)
    cap = np.full(k, capacity, dtype=np.int64)
    if forbid is not None:
        cap[np.asarray(forbid, dtype=bool)] = 0
    cut = edge_cut(graph, part) if objective == "cut" else comm_volume(hyper, part)
    if graph.adjncy.shape[0] == 0:
        return part, cut
    if plateau_rounds is None:
        plateau_rounds = _PLATEAU_ROUNDS[objective]
    if max_iters is None:
        max_iters = _MAX_ITERS[objective]
    src = graph.edge_src
    nbr = adjncy.astype(np.int64)
    # Incremental Φ bookkeeping (the scalar FM queue's VolumeState, driven
    # in batch mode) unless the dense (E, k) table would blow the memory
    # cap — then each chunk recounts Φ for its incident edges from scratch.
    vstate = None
    dense_inc = None
    if objective == "volume":
        if cut == 0:
            return part, cut  # every hyperedge spans one partition already
        if hyper.num_hyperedges * k <= _PHI_MAX_ENTRIES:
            vstate = VolumeState(graph, part, k)
            ne = hyper.num_hyperedges
            avg_inc = (hyper.num_pins + ne) / max(n, 1)
            # Dense only where it wins: the sparse epilogue costs ~avg_inc
            # gather-bound entries per (row, column), the matmul ne
            # BLAS-rate flops — crossover around a 16x flop discount.
            if (n * ne <= _DENSE_EVAL_ENTRIES
                    and avg_inc * 16 >= ne):
                # Exact in float64: entries are hfire-weighted 0/1 sums.
                dense_inc = _dense_incidence(hyper).astype(np.float64)
    # Persistent flat slot buffers for select_movers, addressed by the
    # packed key e * k + c directly — no per-call unique/searchsorted
    # compression.  phi.size <= _PHI_MAX_ENTRIES < 2**31 whenever vstate
    # exists, so int32 keys index them exactly; each call zeroes only the
    # entries it touched.  Tables small enough for whole-table bincounts
    # skip the toucher/leaver count buffers entirely (see select_movers).
    slot_cnt = slot_out = slot_rank = slot_done = None
    if vstate is not None:
        if vstate.phi.size > _SLOT_BINCOUNT_MAX:
            slot_cnt = np.zeros(vstate.phi.size, dtype=np.int32)
            slot_out = np.zeros(vstate.phi.size, dtype=np.int32)
        slot_rank = np.zeros(vstate.phi.size, dtype=np.int32)
        slot_done = np.zeros(vstate.phi.size, dtype=bool)
    if use_kernel is None:
        # Same three gates as the reference (dense size, k, exact f32
        # sums), keyed on the card instead of the TPU; cut levels only.
        total_w = int(adjwgt.sum()) if objective == "cut" else 0
        use_kernel = (objective == "cut" and dev.type == "cuda"
                      and n <= _KERNEL_MAX_N and k >= _KERNEL_MIN_K
                      and total_w < (1 << 24))

    # The level's dense adjacency goes to the device once, here; each
    # eval_rows call moves only the partition vector and the row ids.
    dense = (torch.from_numpy(_dense_adjacency(graph)).to(dev)
             if use_kernel else None)
    # The volume path materializes a (pairs, k) product where pairs is the
    # chunk's total incidence degree — bound the chunk by that expansion,
    # not just rows * k, or fan-out-heavy graphs blow the memory cap.
    row_cost = float(k)
    if objective == "volume" and n:
        avg_inc = (hyper.num_pins + hyper.num_hyperedges) / n
        row_cost *= max(avg_inc, 1.0)
    chunk = max(1, int(_MAX_DEG_ENTRIES / row_cost))

    def eval_rows(rows_v: np.ndarray, pvec: np.ndarray) -> np.ndarray:
        """Degree rows of ``rows_v`` read against partition view ``pvec``
        (the global partition vector)."""
        if objective == "cut":
            if use_kernel:
                return _degrees_via_kernel(dense, pvec, k, rows_v)
            return partition_degrees(graph, pvec, k, rows=rows_v)
        if dense_inc is not None:
            # One (rows, E) @ (E, 2k) BLAS call against the live Φ
            # presence: base counts any member, the own column demands a
            # second one (the row vertex always sits there itself).
            pres = np.concatenate(
                [vstate.phi > 0, vstate.phi > 1], axis=1).astype(np.float64)
            both = dense_inc[rows_v] @ pres
            base, alt = both[:, :k], both[:, k:]
            own = pvec[rows_v]
            r = np.arange(rows_v.shape[0])
            base[r, own] = alt[r, own]
            return base
        if vstate is not None:
            return vstate.degrees_rows(pvec, rows_v)
        return volume_degrees(hyper, pvec, k, rows=rows_v)

    def eval_chunks(need: np.ndarray):
        """Yield (rows chunk, partition vector) pairs covering ``need``."""
        for lo in range(0, need.shape[0], chunk):
            yield need[lo:lo + chunk], part

    def _slot_phi(slots: np.ndarray) -> np.ndarray:
        """Member counts Φ(e, c) for packed (hyperedge, column) slot keys
        ``e * k + c`` — from the live table when one exists, else counted
        from the partition vector for just the slots' distinct edges."""
        if vstate is not None:
            return vstate.phi.reshape(-1)[slots].astype(np.int64)
        ue = np.unique(slots // k)
        pidx, pl = _csr_gather(hyper.hxadj, ue)
        mkeys = np.concatenate([
            ue[pl] * k + part[hyper.hpins[pidx]],
            ue * k + part[hyper.hsrc[ue].astype(np.int64)],
        ])
        mkeys.sort()
        return (np.searchsorted(mkeys, slots, side="right")
                - np.searchsorted(mkeys, slots, side="left"))

    def select_movers(cand_idx: np.ndarray,
                      jitter_round: int | None = None) -> np.ndarray:
        """Greedy conflict-free mover selection: iterated Luby rounds.

        Each round, a candidate survives if no co-scoped candidate has
        strictly higher (gain, -id) priority; survivors join the mover
        set, candidates co-scoped with a survivor drop out, and the
        merely-beaten re-enter the next round.

        Cut: scopes are graph edges, so the pairwise scan over candidates'
        adjacency rows is degree-bounded.

        Volume: scopes are the **(hyperedge, column) slots** a move's ±1
        Φ-updates land on — (e, own) and (e, target) for each incident
        edge e.  A slot is *contended* only when at least two candidates
        touch it and its count sits near a presence threshold:

            touchers(e, c) > 1  and  (Φ(e, c) < 2
                                      or Φ(e, c) − leavers(e, c) < 2)

        Any mover subset confined to uncontended slots leaves every
        [Φ > 0] / [Φ > 1] indicator unchanged there, so batch gains stay
        exactly additive and the two-column delta updates stay exact;
        contended slots admit one max-priority toucher per round (tracked
        across rounds like the old per-edge flags).  Contention is
        computed once per call over the full candidate set — safety is
        monotone under taking subsets (fewer touchers, fewer leavers), so
        later rounds never need to re-derive it.  Compared with the old
        per-hyperedge scoping this is the "fat rounds" restructure: a hub
        edge spanning well-populated partitions admits all its movers at
        once instead of one per round.

        ``jitter_round`` (plateau escapes) perturbs the selection priority
        with a deterministic per-round hash of (vertex, round): consecutive
        escape rounds then explore *different* independent sets instead of
        replaying the same batch out and back — the deterministic-orbit
        failure mode of batch negative-gain walks.  Applied gains stay the
        exact cached values; only who wins the conflict changes.
        """
        g_sel = gain_full
        if jitter_round is not None:
            cg = gain_full[cand_idx]
            span = float(cg.max() - cg.min())
            if span > 0:
                u = (_mix64(cand_idx.astype(np.uint64),
                            np.uint64(2 * jitter_round + 1)).astype(np.float64)
                     / float(1 << 64))
                g_sel = gain_full.copy()
                g_sel[cand_idx] = cg + 0.5 * span * u
        chosen: list[np.ndarray] = []
        remaining = cand_idx
        if objective == "volume":
            vxadj, vedges = hyper.incidence()
            nc = cand_idx.shape[0]
            # One pair per (candidate, incident edge, side): every slot a
            # move's +-1 lands on.  Gathered once; the rounds below work on
            # boolean-masked views of these arrays, never re-gathering.
            ei0, lc0 = _csr_gather(vxadj, cand_idx)
            eids0 = vedges[ei0]
            lc2 = np.concatenate([lc0, lc0])
            if slot_done is not None:
                # Flat persistent buffers addressed by the packed key
                # e * k + c, computed in int32 outright (phi.size < 2^31
                # whenever the live table exists, so the arithmetic is
                # exact and skips an int64 pass + downcast).
                base = eids0.astype(np.int32) * np.int32(k)
                key = np.concatenate([
                    base + part[cand_idx].astype(np.int32)[lc0],
                    base + target_full[cand_idx].astype(np.int32)[lc0],
                ])
                half = eids0.shape[0]
                if slot_cnt is None:
                    # Small table: two straight bincounts beat the buffered
                    # fancy-index adds and need no zeroing afterwards.
                    t_cnt = np.bincount(key, minlength=vstate.phi.size)
                    o_cnt = np.bincount(key[:half],
                                        minlength=vstate.phi.size)
                else:
                    ones = np.ones(key.shape[0], dtype=np.int32)
                    np.add.at(slot_cnt, key, ones)
                    np.add.at(slot_out, key[:half], ones[:half])
                    t_cnt, o_cnt = slot_cnt, slot_out
                ps = vstate.phi.reshape(-1)[key]
                cm = (t_cnt[key] > 1) & ((ps < 2) | (ps - o_cnt[key] < 2))
                if t_cnt is slot_cnt:  # zero only what this call touched
                    slot_cnt[key] = 0
                    slot_out[key] = 0
                used_buf, rank_buf, persistent = slot_done, slot_rank, True
            else:
                skey = np.concatenate([
                    eids0 * k + part[cand_idx][lc0],       # leaving slots
                    eids0 * k + target_full[cand_idx][lc0],  # entering
                ])
                # No phi table (level too big to densify): compress the
                # slot keys first, then use call-local buffers.
                slots = np.unique(skey)
                key = np.searchsorted(slots, skey)
                t_cnt = np.bincount(key, minlength=slots.shape[0])
                o_cnt = np.bincount(key[:eids0.shape[0]],
                                    minlength=slots.shape[0])
                phi_slot = _slot_phi(slots)
                cm = ((t_cnt[key] > 1)
                      & ((phi_slot[key] < 2)
                         | (phi_slot[key] - o_cnt[key] < 2)))
                used_buf = np.zeros(slots.shape[0], dtype=bool)
                rank_buf = np.zeros(slots.shape[0], dtype=np.int32)
                persistent = False
            # Fat-round payoff: a candidate touching no contended slot
            # conflicts with nobody and wins outright; only contended
            # candidates enter the priority rounds.
            rmask = np.bincount(lc2[cm], minlength=nc) > 0
            free = cand_idx[~rmask]
            if free.shape[0]:
                chosen.append(free)
            # Dense (gain, -id) ranks as priorities, computed once per
            # call: rank comparisons are order-isomorphic to the pairwise
            # tie-breaking, and stay valid on every remaining-subset.
            pri = np.empty(nc, dtype=np.int32)
            pri[np.lexsort((cand_idx, -g_sel[cand_idx]))] = np.arange(
                nc, 0, -1, dtype=np.int32)
            ckey, clc = key[cm], lc2[cm]  # contended pairs only
            for _ in range(_LUBY_ROUNDS):
                if not rmask.any():
                    break
                ap = rmask[clc]  # this round's live contended pairs
                akey, alc = ckey[ap], clc[ap]
                excl = np.bincount(alc[used_buf[akey]], minlength=nc) > 0
                rank_buf[akey] = 0
                np.maximum.at(rank_buf, akey, pri[alc])
                lost = np.bincount(alc[rank_buf[akey] > pri[alc]],
                                   minlength=nc) > 0
                win = rmask & ~excl & ~lost
                winners = cand_idx[win]
                if winners.shape[0]:
                    chosen.append(winners)
                    used_buf[akey[win[alc]]] = True
                rmask &= ~excl & lost
            if persistent:  # zero only what this call touched
                used_buf[ckey] = False
                rank_buf[ckey] = 0
            if not chosen:
                return np.empty(0, dtype=np.int64)
            return np.concatenate(chosen)
        # 0 = not a candidate, 1 = still in the running, 2 = chosen.
        status = np.zeros(n, dtype=np.int8)
        status[cand_idx] = 1
        for _ in range(_LUBY_ROUNDS):
            if remaining.shape[0] == 0:
                break
            nr = remaining.shape[0]
            # Segment-any over the (pair -> candidate) map as bincounts of
            # the offending pair subset (buffered C loops; the equivalent
            # ``np.logical_or.at`` is unbuffered and ~10x slower here).
            eidx, local = _row_edges(graph, remaining)
            u, v = remaining[local], nbr[eidx]
            excl = np.bincount(local[status[v] == 2], minlength=nr) > 0
            beat = (status[v] == 1) & (
                (g_sel[v] > g_sel[u])
                | ((g_sel[v] == g_sel[u]) & (v < u))
            )
            lost = np.bincount(local[beat], minlength=nr) > 0
            win = ~excl & ~lost
            winners = remaining[win]
            status[remaining[excl]] = 0  # out of the running for good
            if winners.shape[0]:
                chosen.append(winners)
                status[winners] = 2
            remaining = remaining[~excl & lost]
        if not chosen:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(chosen)

    def touched_by(moved: np.ndarray, srcs: np.ndarray,
                   dsts: np.ndarray) -> np.ndarray:
        """Vertices whose cached gains are stale after `moved` move."""
        if objective == "cut":
            eidx, _ = _row_edges(graph, moved)
            return adjncy[eidx].astype(np.int64)
        if vstate is not None:
            # Critical-edge filter: only hyperedges where the move crossed
            # a presence threshold invalidate their members' D* rows.
            return vstate.touched_moves(moved, srcs, dsts)
        vxadj, vedges = hyper.incidence()
        eidx, _ = _csr_gather(vxadj, moved)
        ue = np.unique(vedges[eidx])
        pidx, _ = _csr_gather(hyper.hxadj, ue)
        return np.concatenate([hyper.hpins[pidx].astype(np.int64),
                               hyper.hsrc[ue].astype(np.int64)])

    # Cached per-vertex move state.  A cached (gain, target) stays exact
    # until a co-member moves (gains depend only on other members'
    # partitions) or the vertex itself moves, so each iteration only
    # re-evaluates the "active" set: last batch's movers plus their scopes.
    gain_full = np.full(n, -np.inf)
    internal_full = np.zeros(n)
    target_full = np.full(n, -1, dtype=np.int64)
    mask = np.zeros(n, dtype=bool)
    if vstate is not None:
        # Volume: members of multi-partition hyperedges — a pin can carry a
        # λ-gain without sitting on any cut *graph* edge (two pins of one
        # source need not be adjacent), so the graph boundary undershoots.
        multi = np.nonzero((vstate.phi > 0).sum(axis=1) > 1)[0]
        pidx, _ = _csr_gather(hyper.hxadj, multi)
        mask[hyper.hpins[pidx].astype(np.int64)] = True
        mask[hyper.hsrc[multi].astype(np.int64)] = True
    else:
        on_cut = part[src] != part[nbr]
        if not on_cut.any():
            return part, cut
        mask[src[on_cut]] = True
    active = np.nonzero(mask)[0]

    # Plateau-walk state: best-seen snapshot (rollback target), stall
    # credits (refunded on meaningful improvement only; see _PLATEAU_TOL),
    # the total-escape cap, and the per-vertex escape-round cooldown.
    best_cut = cut
    best_part = part.copy()
    stall = 0
    escapes = 0
    moves_total = 0
    it = -1
    credit_base = cut
    cooled_until = np.full(n, -1, dtype=np.int64)

    use_deg_cache = n * k <= _DEG_CACHE_ENTRIES
    deg_cache = np.zeros((n, k)) if use_deg_cache else None

    def cache_rows(rows: np.ndarray) -> np.ndarray:
        return deg_cache[rows]

    def cache_store(rows: np.ndarray, deg: np.ndarray) -> None:
        deg_cache[rows] = deg

    def cache_scatter(rows: np.ndarray, cols: np.ndarray,
                      vals: np.ndarray) -> None:
        np.add.at(deg_cache, (rows, cols), vals)
    # Rows whose deg_cache entry is current.  Volume rows with the row
    # cache are maintained *incrementally* (see delta_update): a move
    # changes a co-member's D* row in exactly two columns, so the batch
    # applies two-column scatters instead of re-gathering whole rows —
    # the full batch mirror of the scalar FM queue's delta updates.
    known = np.zeros(n, dtype=bool)
    use_delta = vstate is not None and use_deg_cache

    def delta_update(moved: np.ndarray, prevp: np.ndarray,
                     destp: np.ndarray) -> np.ndarray:
        """Two-column D* delta scatter for a conflict-free mover batch.

        Call after ``apply_moves`` (Φ holds post-move counts) and after
        clearing ``known[moved]`` (movers share no hyperedge, so a mover's
        row only changes through its own move — it gets a full re-eval).
        For a move src→dst on edge e with post-move counts φs = Φ(e,src),
        φd = Φ(e,dst), a member u with δc = [part[u] == c] sees exactly

            D*[u, src] -= hfire[e]  iff φs == δsrc
            D*[u, dst] += hfire[e]  iff φd == δdst + 1

        and no other column changes.  Nonzero deltas imply φs <= 1 or
        φd <= 2 — precisely the critical-edge filter — so non-critical
        edges are skipped wholesale.  Returns the member vertices of the
        critical edges (the rows whose targets must be re-chosen).
        """
        idx, local = _csr_gather(vstate.vxadj, moved)
        eids = vstate.vedges[idx]
        cs = prevp[local]
        cd = destp[local]
        phi_s = vstate.phi[eids, cs].astype(np.int64)
        phi_d = vstate.phi[eids, cd].astype(np.int64)
        crit = (phi_s <= 1) | (phi_d <= 2)
        eids, cs, cd = eids[crit], cs[crit], cd[crit]
        phi_s, phi_d = phi_s[crit], phi_d[crit]
        pidx, el = _csr_gather(hyper.hxadj, eids)
        mem = np.concatenate([hyper.hpins[pidx].astype(np.int64),
                              hyper.hsrc[eids].astype(np.int64)])
        j = np.concatenate([el, np.arange(eids.shape[0], dtype=np.int64)])
        pu = part[mem]
        w = vstate.hfire_f[eids]
        hit_s = phi_s[j] == (cs[j] == pu)
        hit_d = phi_d[j] == (cd[j] == pu) + 1
        ks = known[mem] & hit_s
        kd = known[mem] & hit_d
        cache_scatter(mem[ks], cs[j][ks], -w[j][ks])
        cache_scatter(mem[kd], cd[j][kd], w[j][kd])
        # Only rows that actually changed re-enter the active set; a member
        # whose both indicator thresholds were missed has a byte-identical
        # row and an exact cached gain (feasibility staleness is caught by
        # the global stale-target check).
        return mem[hit_s | hit_d]

    def choose_targets(rows_v: np.ndarray, deg: np.ndarray) -> None:
        """Refresh the (gain, target) caches of ``rows_v`` from their
        degree rows: best *feasible* foreign column under the current
        partition weights (the scalar FM queue's walk down the degree
        vector to the first partition with room, as one masked argmax).
        Cumulative capacity is still enforced exactly at admission.

        ``deg`` is always a fresh per-call matrix (an eval result or a
        row-cache gather, both already stored/copied), so the feasibility
        masking mutates it in place instead of allocating a second
        (rows, k) array via ``np.where``; uniform-weight row sets — every
        finest level — reduce it to masking the handful of *full columns*.
        """
        own = part[rows_v]
        rows = np.arange(rows_v.shape[0])
        internal = deg[rows, own]  # advanced indexing: already a copy
        w = vwgt[rows_v]
        head = cap - pweight
        if w.shape[0] and w[0] == w[-1] and (w == w[0]).all():
            bad = head < w[0]
            if bad.any():
                deg[:, bad] = -np.inf
        else:
            deg[w[:, None] > head[None, :]] = -np.inf
        deg[rows, own] = -np.inf
        t = np.argmax(deg, axis=1)
        target_full[rows_v] = t
        internal_full[rows_v] = internal
        gain_full[rows_v] = deg[rows, t] - internal

    for it in range(max_iters):
        # Evaluate rows whose cached degree row is missing or invalid, in
        # chunks so the (rows, k) matrix stays within the memory cap; rows
        # kept current by delta_update only need their target re-chosen.
        if deg_cache is not None:
            ka = known[active]
            need, cached_rows = active[~ka], active[ka]
        else:
            need, cached_rows = active, None
        for rows_v, pvec in eval_chunks(need):
            deg = eval_rows(rows_v, pvec)
            if deg_cache is not None:
                cache_store(rows_v, deg)
                known[rows_v] = True
            choose_targets(rows_v, deg)
        if cached_rows is not None and cached_rows.shape[0]:
            choose_targets(cached_rows, cache_rows(cached_rows))
        # A cached target goes stale when its partition fills up.  Degree
        # rows themselves only change when a co-member moves, so with the
        # row cache retargeting is a pure masked argmax — no re-gather;
        # without it the rows re-enter the active set for re-evaluation.
        stale = np.isfinite(gain_full) & (vwgt > (cap - pweight)[target_full])
        srows = np.nonzero(stale)[0]
        if srows.shape[0]:
            if use_deg_cache:
                choose_targets(srows, cache_rows(srows))
                srows = np.empty(0, dtype=np.int64)
            else:
                gain_full[srows] = -np.inf
        is_cand = gain_full > 0
        plateau_move = False
        if not is_cand.any():
            if srows.shape[0]:
                active = srows  # retarget the stale rows before concluding
                continue
            # Positive fixed point: spend a stall credit on a Jet-style
            # escape round of zero/bounded-negative-gain moves.  Movers on
            # cooldown sit out (oscillation guard); a vertex with no
            # external presence toward its target (gain + internal == 0)
            # never escapes — such moves only churn isolated vertices.
            if (stall >= plateau_rounds
                    or escapes >= _PLATEAU_TOTAL * plateau_rounds):
                break
            stall += 1
            escapes += 1
            plateau_move = True
            is_cand = ((gain_full >= -plateau_eps * internal_full)
                       & (gain_full + internal_full > 0)
                       & (cooled_until < it))
        cand_idx = np.nonzero(is_cand)[0]
        if cand_idx.shape[0] == 0:
            if plateau_move:
                eligible = ((gain_full >= -plateau_eps * internal_full)
                            & (gain_full + internal_full > 0))
                if eligible.any():
                    # Every escape candidate is merely on cooldown: burn
                    # the stall credit and let the cooldowns expire instead
                    # of ending refinement (still bounded by the credit and
                    # total-escape caps).
                    active = np.empty(0, dtype=np.int64)
                    continue
            break

        # Iterated Luby rounds: movers form a conflict-free set, so their
        # gains are exact and additive.  Only the candidates' own scope
        # rows are scanned, not all m edges.
        movers = select_movers(cand_idx, jitter_round=it if plateau_move else None)
        if movers.shape[0] == 0:  # unreachable: the max-priority candidate survives
            break

        # Capacity admission: per target partition, admit in gain order while
        # the cumulative moved weight fits in the pre-batch headroom.
        mt = target_full[movers]
        mg = gain_full[movers]
        order = np.lexsort((movers, -mg, mt))
        movers, mt, mg = movers[order], mt[order], mg[order]
        admit = grouped_admission(mt, vwgt[movers], cap - pweight)
        moved, dest, moved_gain = movers[admit], mt[admit], mg[admit]
        if moved.shape[0] == 0:
            # Unreachable: the stale-target filter above guarantees every
            # surviving candidate's target has headroom for it right now,
            # so the top mover per target group always admits.
            break

        moves_total += moved.shape[0]
        prev = part[moved].copy()
        np.subtract.at(pweight, prev, vwgt[moved])
        np.add.at(pweight, dest, vwgt[moved])
        part[moved] = dest
        cut -= int(round(moved_gain.sum()))
        if vstate is not None:
            vstate.apply_moves(moved, prev, dest)
        if plateau_move:
            cooled_until[moved] = it + plateau_cooldown
        if cut < best_cut:
            best_cut = cut
            best_part = part.copy()
            if cut <= credit_base - max(1.0, _PLATEAU_TOL * credit_base):
                stall = 0
                credit_base = cut

        # Next active set: the movers, everything co-scoped with one, and
        # the stale-target rows awaiting feasible retargeting.  Capacity-
        # rejected movers keep their (still exact) cached gains and re-run
        # through admission next round.
        known[moved] = False  # a mover's own row changes in every column
        if use_delta:
            touched = delta_update(moved, prev, dest)
        else:
            touched = touched_by(moved, prev, dest)
            if deg_cache is not None:
                known[touched] = False
        mask[:] = False
        mask[moved] = True
        mask[srows] = True
        mask[touched] = True
        active = np.nonzero(mask)[0]
    if stats is not None:
        # Engine introspection for tests and benchmarks (cheap counters).
        stats["iterations"] = stats.get("iterations", 0) + it + 1
        stats["escapes"] = stats.get("escapes", 0) + escapes
        stats["moves"] = stats.get("moves", 0) + moves_total
    if cut > best_cut:  # plateau walk ended below its best — roll back
        part, cut = best_part, best_cut
    return part, cut


def uncoarsen_vec(
    levels,
    coarse_part: np.ndarray,
    k: int,
    capacity: int,
    max_nonimproving: int = 64,
    use_kernel: bool | None = None,
    scalar_nk: int = _SCALAR_NK,
    scalar_max_k: int = _SCALAR_MAX_K,
    objective: str = "cut",
    plateau_rounds: int | None = None,
    shards=None,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, int]:
    """Walk levels coarse->fine, refining each level with whichever engine
    its shape favors: the scalar FM queue for small few-partition *cut*
    levels (see _SCALAR_NK/_SCALAR_MAX_K), the batched vec refiner
    otherwise.  Volume levels always use the vec refiner — with the
    incremental Φ table and the plateau walk it matches the scalar queue's
    quality at a fraction of the time (the λ-gain queue's per-move cost is
    worst exactly where delegation used to send it).  ``max_nonimproving``
    applies to the scalar-delegated levels; ``plateau_rounds`` threads
    through to ``refine_level_vec``; ``shards`` is not ported (raises).

    ``levels`` is any integer-indexable sequence of Graphs — a plain list
    or ``coarsen.LevelStore``; levels are accessed one index at a time,
    finest last, so an out-of-core store only ever holds two levels
    resident.  ``device`` is where the vec levels' kernel path runs (see
    ``refine_level_vec``).
    """
    _refuse_shards(shards)
    dev = resolve_device(device)

    def refine(g: Graph, p: np.ndarray) -> tuple[np.ndarray, int]:
        if (objective == "cut" and k <= scalar_max_k
                and g.num_vertices * k <= scalar_nk):
            return refine_level(g, p, k, capacity, max_nonimproving,
                                objective=objective)
        return refine_level_vec(g, p, k, capacity, use_kernel=use_kernel,
                                objective=objective,
                                plateau_rounds=plateau_rounds, device=dev)

    nlev = len(levels)
    part, cut = refine(levels[nlev - 1], coarse_part)
    for i in range(nlev - 2, -1, -1):
        part = project(part, levels[i + 1].cmap)
        part, cut = refine(levels[i], part)
    return part, cut
