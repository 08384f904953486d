"""Spike-weighted SNN graphs in CSR form — plus the multicast hypergraph.

The profiling phase (``repro.snn.simulate``) produces two views of the same
traffic:

* an undirected graph G(N, S): vertices are neurons, an edge (i, j) carries
  the number of spikes communicated on the synapse between i and j during
  the profiled window (paper §3.2).  ``edge_cut`` over this graph is the
  classic partitioning objective — it counts every cut *synapse*.
* a hypergraph H(N, E): one hyperedge per firing neuron, holding its
  destination pin set with per-pin spike counts.  On a real NoC a neuron
  whose spikes fan out to d destination cores injects one multicast packet
  replicated along at most d branches — not d independent unicasts — so the
  matching objective is the hMETIS-style connectivity-(λ−1) communication
  volume ``comm_volume``: each source pays its fire count once per *distinct*
  remote destination partition, not once per cut synapse.

On pure unicast traffic (every source has exactly one pin) the two
objectives coincide; on fan-out-heavy SNNs edge-cut over-counts multicast
packets and the partitioner optimizes a different quantity than the NoC
simulator measures.  All partitioning machinery accepts either objective
(see ``repro.core.partition``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Graph",
    "Hypergraph",
    "IndexCapacityError",
    "check_index_capacity",
    "ShardedGraphView",
    "build_graph",
    "build_hypergraph",
    "dedup_hyperedges",
    "edge_cut",
    "comm_volume",
    "comm_volume_sharded",
    "volume_degrees",
    "presence_degrees",
    "edge_partition_counts",
    "csr_gather",
    "grouped_admission",
    "partition_weights",
    "validate_partition",
]


class IndexCapacityError(ValueError):
    """A graph/hypergraph shape exceeds what the index dtypes can address.

    Vertex ids are stored int32 (``adjncy``/``hpins``/``hsrc``); packed
    (row, column) keys — ``edge * k + part`` and friends — are int64.  Past
    those bounds arithmetic would wrap *silently*, so the builders raise
    this named error at the boundary instead.  Checks are pure shape math:
    no allocation happens before the raise.
    """


_INT32_MAX = np.iinfo(np.int32).max
_INT64_MAX = np.iinfo(np.int64).max


def check_index_capacity(
    num_vertices: int,
    num_hyperedges: int = 0,
    k: int = 1,
) -> None:
    """Raise :class:`IndexCapacityError` if shapes overflow the index dtypes.

    Guards (shape math only, no allocation):
      * vertex ids must fit int32 — ``adjncy``/``hpins``/``hsrc`` store them
        as int32 and a 2^31-th vertex would wrap negative;
      * canonical edge keys ``lo * n + hi`` must fit int64;
      * packed Φ keys ``edge * k + part`` must fit int64 (k up to the
        partition count, edges up to max(n, E)).
    """
    n = int(num_vertices)
    ne = max(int(num_hyperedges), n)
    if n > _INT32_MAX:
        raise IndexCapacityError(
            f"num_vertices={n} exceeds int32 vertex-id capacity "
            f"({_INT32_MAX}); adjncy/hpins/hsrc store int32 ids"
        )
    if n and n > _INT64_MAX // max(n, 1):
        raise IndexCapacityError(
            f"num_vertices={n}: edge keys lo*n+hi overflow int64"
        )
    if k and ne > _INT64_MAX // max(int(k), 1):
        raise IndexCapacityError(
            f"{ne} edges x k={k} partitions: packed keys edge*k+part "
            "overflow int64"
        )


def csr_gather(xadj: np.ndarray, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather the CSR entry indices of ``rows``: (entry index, local row id).

    The ranges-to-indices expansion shared by every CSR consumer: start of
    each row repeated, plus a within-row ramp.
    """
    counts = (xadj[rows + 1] - xadj[rows]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    starts = np.repeat(xadj[rows], counts)
    ramp = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    local = np.repeat(np.arange(rows.shape[0], dtype=np.int64), counts)
    return starts + ramp, local


def grouped_admission(
    groups: np.ndarray, weights: np.ndarray, headroom: np.ndarray
) -> np.ndarray:
    """Admit entries per group while their cumulative weight fits.

    Entries must arrive pre-sorted by group (then by admission priority
    within each group); ``headroom[g]`` is group g's remaining capacity.
    Returns a boolean admit mask: within each group, the longest prefix
    whose running weight stays within headroom — the grouped-cumsum
    admission step shared by the batched refiner and the vectorized
    region grower.
    """
    m = groups.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    cw = np.cumsum(weights)
    new_grp = np.empty(m, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = groups[1:] != groups[:-1]
    grp_starts = np.nonzero(new_grp)[0]
    grp_sizes = np.diff(np.append(grp_starts, m))
    within = cw - np.repeat(cw[grp_starts] - weights[grp_starts], grp_sizes)
    return within <= headroom[groups]


@dataclass
class Graph:
    """Undirected weighted graph in CSR (symmetric adjacency, both directions stored).

    Attributes:
      xadj:   (n+1,) int64 — CSR row offsets.
      adjncy: (m,)   int32 — neighbor indices (each undirected edge appears twice).
      adjwgt: (m,)   int64 — edge weights (spike counts).
      vwgt:   (n,)   int64 — vertex weights (neuron multiplicity; 1 at level 0).
    """

    xadj: np.ndarray
    adjncy: np.ndarray
    adjwgt: np.ndarray
    vwgt: np.ndarray
    # Maps each vertex of this (coarse) graph back to vertices of the parent
    # finer graph; None at level 0.
    cmap: np.ndarray | None = field(default=None, repr=False)
    # Multicast hyperedge view of the same traffic; contracted alongside the
    # graph during coarsening when present.
    hyper: "Hypergraph | None" = field(default=None, repr=False)
    _edge_src: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def num_vertices(self) -> int:
        return int(self.vwgt.shape[0])

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.adjncy.shape[0] // 2)

    @property
    def total_vwgt(self) -> int:
        return int(self.vwgt.sum())

    @property
    def total_adjwgt(self) -> int:
        """Sum of edge weights (each undirected edge counted once)."""
        return int(self.adjwgt.sum() // 2)

    @property
    def edge_src(self) -> np.ndarray:
        """(m,) int64 CSR row index of each directed edge, computed lazily once.

        Hot loops (edge cut, batched refinement, contraction) all need the
        ``np.repeat`` source expansion; caching it here makes those calls
        O(m) gathers instead of re-materializing the expansion every time.
        """
        if self._edge_src is None:
            self._edge_src = np.repeat(
                np.arange(self.num_vertices, dtype=np.int64), np.diff(self.xadj)
            )
        return self._edge_src

    def degree(self, v: int) -> int:
        return int(self.xadj[v + 1] - self.xadj[v])

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.xadj[v], self.xadj[v + 1]
        return self.adjncy[s:e], self.adjwgt[s:e]


@dataclass
class Hypergraph:
    """Multicast traffic in CSR form: hyperedge e = source ``hsrc[e]`` + pins.

    One hyperedge per source neuron with outgoing synapses.  ``hpins`` holds
    the destination vertices (deduplicated per hyperedge, never equal to the
    source), ``hwgt`` the spikes delivered to each pin over the window, and
    ``hfire`` the source's fire count — the number of multicast packets the
    source injects toward each distinct destination partition.

    The connectivity objective weighs hyperedges by ``hfire`` alone;
    ``hwgt`` is the per-destination delivered-spike ledger (a pin that
    absorbs several parallel synapses carries their sum), kept so coarse
    levels preserve delivered-spike totals exactly — external deliveries
    are conserved under contraction and only pins collapsing into their
    source (core-local deliveries) leave the ledger.

    Attributes:
      hxadj: (E+1,) int64 — CSR offsets into hpins/hwgt.
      hpins: (P,)   int32 — destination vertex ids.
      hwgt:  (P,)   int64 — spikes delivered to that pin.
      hsrc:  (E,)   int32 — source vertex of each hyperedge.
      hfire: (E,)   int64 — spikes fired by the source (hyperedge weight).
    """

    hxadj: np.ndarray
    hpins: np.ndarray
    hwgt: np.ndarray
    hsrc: np.ndarray
    hfire: np.ndarray
    num_vertices: int
    _pin_edge: np.ndarray | None = field(default=None, repr=False, compare=False)
    _incidence: tuple[np.ndarray, np.ndarray] | None = field(
        default=None, repr=False, compare=False
    )

    @property
    def num_hyperedges(self) -> int:
        return int(self.hsrc.shape[0])

    @property
    def num_pins(self) -> int:
        return int(self.hpins.shape[0])

    @property
    def pin_edge(self) -> np.ndarray:
        """(P,) int64 hyperedge id of each pin (cached CSR row expansion)."""
        if self._pin_edge is None:
            self._pin_edge = np.repeat(
                np.arange(self.num_hyperedges, dtype=np.int64), np.diff(self.hxadj)
            )
        return self._pin_edge

    def incidence(self) -> tuple[np.ndarray, np.ndarray]:
        """Vertex → hyperedge CSR: (vxadj (n+1,), vedges) listing, for every
        vertex, the hyperedges it belongs to (as source or pin).

        Pins never equal their source and are deduplicated per hyperedge, so
        each (vertex, hyperedge) membership appears exactly once.
        """
        if self._incidence is None:
            n = self.num_vertices
            verts = np.concatenate(
                [self.hpins.astype(np.int64), self.hsrc.astype(np.int64)]
            )
            edges = np.concatenate(
                [self.pin_edge, np.arange(self.num_hyperedges, dtype=np.int64)]
            )
            order = np.argsort(verts, kind="stable")
            verts, edges = verts[order], edges[order]
            vxadj = np.zeros(n + 1, dtype=np.int64)
            np.add.at(vxadj, verts + 1, 1)
            self._incidence = (np.cumsum(vxadj), edges)
        return self._incidence

    def members(self, e: int) -> np.ndarray:
        """All vertices of hyperedge e: the source followed by its pins."""
        s, t = self.hxadj[e], self.hxadj[e + 1]
        return np.concatenate([[self.hsrc[e]], self.hpins[s:t]])

    def validate(self, check_dedup: bool = False) -> None:
        """Raise if the structural invariants every consumer relies on fail.

        Always checked: CSR offsets well-formed, array shapes consistent,
        vertex ids in range, pins strictly increasing within each hyperedge
        (which implies per-edge pin dedup), no pin equal to its source, and
        non-negative weights.  ``check_dedup=True`` additionally asserts no
        two hyperedges share the same (source, pin set) — the invariant
        ``dedup_hyperedges`` establishes and contraction preserves.
        """
        ne, p, n = self.num_hyperedges, self.num_pins, self.num_vertices
        if self.hxadj.shape != (ne + 1,) or self.hxadj[0] != 0:
            raise ValueError("hxadj must be (E+1,) starting at 0")
        if int(self.hxadj[-1]) != p or (np.diff(self.hxadj) < 0).any():
            raise ValueError("hxadj must increase monotonically to num_pins")
        if self.hwgt.shape != (p,) or self.hfire.shape != (ne,):
            raise ValueError("hwgt/hfire shapes inconsistent with pins/edges")
        if p and not (0 <= int(self.hpins.min()) <= int(self.hpins.max()) < n):
            raise ValueError("pin ids outside [0, num_vertices)")
        if ne and not (0 <= int(self.hsrc.min()) <= int(self.hsrc.max()) < n):
            raise ValueError("source ids outside [0, num_vertices)")
        if (self.hwgt < 0).any() or (self.hfire < 0).any():
            raise ValueError("negative hyperedge weights")
        pe = self.pin_edge
        if (self.hpins == self.hsrc[pe]).any():
            raise ValueError("pin equals its hyperedge's source")
        interior = np.ones(p, dtype=bool)
        if p:
            starts = self.hxadj[:-1]
            interior[starts[starts < p]] = False  # first pin of each edge
        if (np.diff(self.hpins.astype(np.int64), prepend=-1)[interior] <= 0).any():
            raise ValueError("pins not strictly increasing within a hyperedge")
        if check_dedup and ne > 1:
            deduped = dedup_hyperedges(self)
            if deduped.num_hyperedges != ne:
                raise ValueError(
                    f"{ne - deduped.num_hyperedges} duplicate (source, pin set) "
                    "hyperedges present"
                )


def build_hypergraph(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    fire_counts: np.ndarray,
) -> Hypergraph:
    """Build the multicast hypergraph from directed synapse (src, dst) pairs.

    One hyperedge per distinct source with at least one non-self pin; pin
    weights are the source's fire count (spikes delivered on that synapse),
    duplicates merged by summing.
    """
    check_index_capacity(num_vertices)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    fire_counts = np.asarray(fire_counts, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    key = src * num_vertices + dst
    uniq, counts = np.unique(key, return_counts=True)
    usrc = uniq // num_vertices
    upin = uniq % num_vertices
    uwgt = fire_counts[usrc] * counts  # duplicate synapses merge

    esrc, estart = np.unique(usrc, return_index=True)
    hxadj = np.concatenate([estart, [usrc.shape[0]]]).astype(np.int64)
    return Hypergraph(
        hxadj=hxadj,
        hpins=upin.astype(np.int32),
        hwgt=uwgt.astype(np.int64),
        hsrc=esrc.astype(np.int32),
        hfire=fire_counts[esrc].astype(np.int64),
        num_vertices=num_vertices,
    )


# Distinct splitmix64 seeds for the two independent pin-set hashes below.
_DEDUP_SEED_1 = np.uint64(0x9E3779B97F4A7C15)
_DEDUP_SEED_2 = np.uint64(0xD1B54A32D192ED03)


def _mix64(x: np.ndarray, seed: np.uint64) -> np.ndarray:
    """splitmix64 finalizer over uint64 values (vectorized, wrapping)."""
    z = x + seed
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def dedup_hyperedges(hyper: Hypergraph) -> Hypergraph:
    """Merge hyperedges with identical (source, pin set), summing weights.

    Two hyperedges with the same source and the same pin set have identical
    member sets, so they span the same partitions under *every* partition
    vector: merging them while summing ``hfire`` (and per-pin ``hwgt``)
    preserves ``comm_volume``, ``volume_degrees``, and the delivered-spike
    ledger exactly.  Contraction mass-produces such duplicates on structured
    SNNs (every source in a dense layer ends up with the same coarse pin
    set), and each duplicate removed shrinks the Φ table and every λ-gain
    evaluation at that level — see ``coarsen.contract_hypergraph``.

    Identity is established exactly: edges are grouped by (source, degree,
    two independent 64-bit pin-set hashes) and neighbors in the sorted
    order are verified pin-by-pin before merging, so a hash collision can
    only ever *miss* a merge, never create a wrong one.  Relies on pins
    being sorted within each hyperedge (a ``Hypergraph`` invariant; see
    ``validate``).  Surviving edges keep the first-occurrence order of
    their group's lowest original edge id, so the result is deterministic.
    """
    ne = hyper.num_hyperedges
    # Duplicates need at least two hyperedges sharing a source.
    if ne <= 1 or np.unique(hyper.hsrc).shape[0] == ne:
        return hyper
    d = np.diff(hyper.hxadj)
    pins64 = hyper.hpins.astype(np.uint64)
    h1 = np.zeros(ne, dtype=np.uint64)
    h2 = np.zeros(ne, dtype=np.uint64)
    nonempty = np.nonzero(d > 0)[0]
    if nonempty.shape[0]:
        starts = hyper.hxadj[:-1][nonempty]
        h1[nonempty] = np.add.reduceat(_mix64(pins64, _DEDUP_SEED_1), starts)
        h2[nonempty] = np.add.reduceat(_mix64(pins64, _DEDUP_SEED_2), starts)
    order = np.lexsort((h2, h1, d, hyper.hsrc))
    src_o, d_o = hyper.hsrc[order], d[order]
    same = np.zeros(ne, dtype=bool)
    same[1:] = (
        (src_o[1:] == src_o[:-1]) & (d_o[1:] == d_o[:-1])
        & (h1[order][1:] == h1[order][:-1]) & (h2[order][1:] == h2[order][:-1])
    )
    if same.any():
        # Verify candidate pairs pin-by-pin (positions align: equal degree,
        # both sorted).  A mismatching pair starts a new group instead.
        ci = np.nonzero(same)[0]
        ia, _ = csr_gather(hyper.hxadj, order[ci - 1])
        ib, _ = csr_gather(hyper.hxadj, order[ci])
        cnt = d[order[ci]]
        nz = np.nonzero(cnt > 0)[0]
        if nz.shape[0]:
            pos = (np.cumsum(cnt) - cnt)[nz]
            mism = np.add.reduceat(hyper.hpins[ia] != hyper.hpins[ib], pos)
            same[ci[nz[mism > 0]]] = False
    if not same.any():
        return hyper

    grp = np.cumsum(~same) - 1  # group id per sorted position
    ngrp = int(grp[-1]) + 1
    # Representative of each group: its lowest original edge id (keeps the
    # output order stable under permutations of the input).
    rep = np.full(ngrp, ne, dtype=np.int64)
    np.minimum.at(rep, grp, order)
    hfire_new = np.zeros(ngrp, dtype=np.int64)
    np.add.at(hfire_new, grp, hyper.hfire[order])

    perm = np.argsort(rep, kind="stable")  # group -> output rank
    rank = np.empty(ngrp, dtype=np.int64)
    rank[perm] = np.arange(ngrp)
    rep_out = rep[perm]
    out_d = d[rep_out]
    hxadj_new = np.concatenate([[0], np.cumsum(out_d)]).astype(np.int64)

    # Scatter every member's pins into its group's output rows; pin j of a
    # member aligns with pin j of the representative, so hwgt sums
    # positionwise and hpins writes are idempotent across members.
    idx, local = csr_gather(hyper.hxadj, order)
    within = idx - np.repeat(hyper.hxadj[:-1][order], d[order])
    out_pos = hxadj_new[:-1][rank[grp[local]]] + within
    total = int(hxadj_new[-1])
    hwgt_new = np.zeros(total, dtype=np.int64)
    np.add.at(hwgt_new, out_pos, hyper.hwgt[idx])
    hpins_new = np.zeros(total, dtype=np.int32)
    hpins_new[out_pos] = hyper.hpins[idx]
    return Hypergraph(
        hxadj=hxadj_new,
        hpins=hpins_new,
        hwgt=hwgt_new,
        hsrc=hyper.hsrc[rep_out],
        hfire=hfire_new[perm],
        num_vertices=hyper.num_vertices,
    )


def build_graph(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: np.ndarray,
    vwgt: np.ndarray | None = None,
) -> Graph:
    """Build a symmetric CSR graph from weighted (src, dst, weight) edge triples.

    Duplicate (src, dst) pairs are merged by summing weights; self-loops are
    dropped (a neuron's spike to itself never crosses the NoC).
    """
    check_index_capacity(num_vertices)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.int64)
    keep = src != dst
    src, dst, weight = src[keep], dst[keep], weight[keep]

    # Canonicalize each undirected edge to (min, max) and merge duplicates.
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * num_vertices + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, weight = key[order], lo[order], hi[order], weight[order]
    uniq, start = np.unique(key, return_index=True)
    merged_w = np.add.reduceat(weight, start) if len(key) else weight
    lo, hi = lo[start], hi[start]

    # Expand to both directions and sort by source for CSR.
    all_src = np.concatenate([lo, hi])
    all_dst = np.concatenate([hi, lo])
    all_w = np.concatenate([merged_w, merged_w])
    order = np.argsort(all_src, kind="stable")
    all_src, all_dst, all_w = all_src[order], all_dst[order], all_w[order]

    xadj = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(xadj, all_src + 1, 1)
    xadj = np.cumsum(xadj)
    if vwgt is None:
        vwgt = np.ones(num_vertices, dtype=np.int64)
    return Graph(
        xadj=xadj,
        adjncy=all_dst.astype(np.int32),
        adjwgt=all_w.astype(np.int64),
        vwgt=np.asarray(vwgt, dtype=np.int64),
    )


def edge_cut(graph: Graph, part: np.ndarray) -> int:
    """Sum of weights of edges whose endpoints lie in different partitions.

    The classic partitioning objective: the number of spikes communicated
    *between* partitions counted once per cut synapse (paper §3.3, "global
    traffic").  Over-counts multicast packets on fan-out traffic — see
    ``comm_volume`` for the NoC-faithful alternative.
    """
    cut_mask = part[graph.edge_src] != part[graph.adjncy]
    return int(graph.adjwgt[cut_mask].sum() // 2)


def comm_volume(hyper: Hypergraph, part: np.ndarray) -> int:
    """Connectivity-(λ−1) communication volume of a partition.

    For each hyperedge e let λ(e) be the number of distinct partitions its
    members (source + pins) span; the volume is sum_e hfire[e] * (λ(e) − 1):
    each firing injects one multicast packet per distinct partition beyond
    the source's own.  Equals ``edge_cut`` on pure unicast hypergraphs.
    """
    part = np.asarray(part, dtype=np.int64)
    ne = hyper.num_hyperedges
    if ne == 0:
        return 0
    k = int(part.max()) + 1
    check_index_capacity(hyper.num_vertices, ne, k)
    keys = np.concatenate(
        [
            hyper.pin_edge * k + part[hyper.hpins],
            np.arange(ne, dtype=np.int64) * k + part[hyper.hsrc],
        ]
    )
    uniq = np.unique(keys)
    lam = np.bincount(uniq // k, minlength=ne)
    return int((hyper.hfire * (lam - 1)).sum())


class ShardedGraphView:
    """Vertex-block sharded view of a :class:`Graph` (and its hypergraph).

    Built from a ``VertexShardPlan`` (``repro.sharding.planner``) — here the
    plan is duck-typed (``bounds``/``num_shards``/``block``) so the numpy
    core never imports jax.  Each shard owns a contiguous vertex block;
    because CSR rows are contiguous, a shard's adjacency slice
    ``adjncy[xadj[lo]:xadj[hi]]`` is a zero-copy view.  The view's job is
    the *halo* bookkeeping: for each shard, the set of non-local vertices
    whose partition labels the shard's gain evaluations read.  Halos are
    static (they depend on structure, not on the partition), so they are
    computed once and the per-round "halo exchange" is a single gather of
    ``part`` at the halo indices.

    ``local_part`` assembles a full-length partition array holding only
    block + halo values, everything else poisoned with ``fill`` — any
    evaluation that reads outside its declared halo hits the poison and
    fails loudly, which is how the metamorphic tests prove halo
    sufficiency.
    """

    def __init__(self, graph: Graph, plan) -> None:
        self.graph = graph
        self.plan = plan
        self._halos: dict[tuple[int, str], np.ndarray] = {}

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    def halo(self, s: int, mode: str = "cut") -> np.ndarray:
        """Sorted non-local vertex ids shard ``s`` reads (computed once).

        ``mode="cut"``: neighbors of the block across graph edges.
        ``mode="volume"``: co-members (source + pins) of every hyperedge
        incident to the block — the multicast pin halo.
        ``mode="local"``: empty — for evaluations that read only
        block-local labels (e.g. D* rows from a live Φ table).
        """
        key = (s, mode)
        if key not in self._halos:
            lo, hi = self.plan.block(s)
            g = self.graph
            if mode == "local":
                self._halos[key] = np.empty(0, dtype=np.int64)
                return self._halos[key]
            if mode == "cut":
                ext = np.unique(g.adjncy[g.xadj[lo]:g.xadj[hi]].astype(np.int64))
            elif mode == "volume":
                hyper = g.hyper
                if hyper is None:
                    raise ValueError("volume halo needs graph.hyper")
                vxadj, vedges = hyper.incidence()
                ue = np.unique(vedges[vxadj[lo]:vxadj[hi]])
                if ue.shape[0]:
                    pidx, _ = csr_gather(hyper.hxadj, ue)
                    ext = np.unique(np.concatenate([
                        hyper.hpins[pidx].astype(np.int64),
                        hyper.hsrc[ue].astype(np.int64),
                    ]))
                else:
                    ext = np.empty(0, dtype=np.int64)
            else:
                raise ValueError(f"unknown halo mode {mode!r}")
            self._halos[key] = ext[(ext < lo) | (ext >= hi)]
        return self._halos[key]

    def local_part(self, s: int, part: np.ndarray, mode: str = "cut",
                   fill: int = -1) -> np.ndarray:
        """Assemble shard ``s``'s view of ``part``: block + halo, rest poisoned."""
        lo, hi = self.plan.block(s)
        lpart = np.full(part.shape[0], fill, dtype=part.dtype)
        lpart[lo:hi] = part[lo:hi]
        halo = self.halo(s, mode)
        lpart[halo] = part[halo]  # the halo exchange: one gather per round
        return lpart


def comm_volume_sharded(hyper: Hypergraph, part: np.ndarray, plan) -> int:
    """``comm_volume`` computed shard-by-shard through halo-local views.

    Each hyperedge is owned by the shard holding its source vertex; a shard
    computes λ over its own edges reading only block + volume-halo partition
    labels, and the partial volumes sum to the global objective for *every*
    shard count — the halo-exchange correctness property the sharded engine
    relies on.  Reads outside the declared halo raise (poison check) rather
    than silently mis-counting.
    """
    part = np.asarray(part, dtype=np.int64)
    ne = hyper.num_hyperedges
    if ne == 0:
        return 0
    k = int(part.max()) + 1
    check_index_capacity(hyper.num_vertices, ne, k)
    g = Graph(
        xadj=np.zeros(hyper.num_vertices + 1, dtype=np.int64),
        adjncy=np.empty(0, dtype=np.int32),
        adjwgt=np.empty(0, dtype=np.int64),
        vwgt=np.ones(hyper.num_vertices, dtype=np.int64),
        hyper=hyper,
    )
    view = ShardedGraphView(g, plan)
    owner = np.searchsorted(np.asarray(plan.bounds), hyper.hsrc,
                            side="right") - 1
    total = 0
    for s in range(plan.num_shards):
        eids = np.nonzero(owner == s)[0].astype(np.int64)
        if eids.shape[0] == 0:
            continue
        lpart = view.local_part(s, part, mode="volume")
        pidx, plocal = csr_gather(hyper.hxadj, eids)
        pin_p = lpart[hyper.hpins[pidx]]
        src_p = lpart[hyper.hsrc[eids]]
        if (pin_p < 0).any() or (src_p < 0).any():
            raise AssertionError(
                f"shard {s} read a partition label outside its halo")
        keys = np.concatenate([
            plocal * k + pin_p,
            np.arange(eids.shape[0], dtype=np.int64) * k + src_p,
        ])
        lam = np.bincount(np.unique(keys) // k, minlength=eids.shape[0])
        total += int((hyper.hfire[eids] * (lam - 1)).sum())
    return total


def edge_partition_counts(hyper: Hypergraph, part: np.ndarray, k: int) -> np.ndarray:
    """(E, k) member counts Φ(e, p): how many members (source + pins) of each
    hyperedge lie in each partition.  λ(e) is the number of nonzero columns
    of row e; refiners maintain this table incrementally across moves.
    int32 — counts are bounded by an edge's pin count, and the dense table
    is the volume refiners' dominant allocation on large graphs."""
    part = np.asarray(part, dtype=np.int64)
    ne = hyper.num_hyperedges
    check_index_capacity(hyper.num_vertices, ne, k)
    keys = np.concatenate([
        hyper.pin_edge * k + part[hyper.hpins].astype(np.int64),
        np.arange(ne, dtype=np.int64) * k + part[hyper.hsrc].astype(np.int64),
    ])
    return np.bincount(keys, minlength=ne * k).reshape(ne, k).astype(np.int32)


def presence_degrees(
    phi_pairs: np.ndarray,
    w: np.ndarray,
    counts: np.ndarray,
    local: np.ndarray,
    own: np.ndarray,
    k: int,
) -> np.ndarray:
    """Shared D* accumulation over (row, incident hyperedge) pairs.

    Given, per pair, the member counts Φ(e, ·) of the incident hyperedge
    (``phi_pairs``, (P, k)) and its weight (``w``, (P,)), plus the pair→row
    CSR structure (``counts`` per row, ``local`` row id per pair — grouped
    by row, as ``csr_gather`` emits) and each row vertex's own partition,
    returns the (R, k) matrix D*[v, p] = Σ_e w_e [Φ(e, p) > (p == own[v])]:
    presence of *any* member for foreign columns, of a *second* member for
    the own column (the row vertex itself always sits there).  Both the
    from-scratch ``volume_degrees`` and the refiner's live-Φ-table variant
    reduce to this epilogue; keep the threshold logic here only.

    Pairs must be grouped by row so the per-row sums are two
    ``np.add.reduceat`` segment reductions (``np.add.at`` is unbuffered
    and an order of magnitude slower here).
    """
    nr = counts.shape[0]
    out = np.zeros((nr, k), dtype=np.float64)
    if phi_pairs.shape[0] == 0:
        return out
    nonempty = np.nonzero(counts > 0)[0]
    starts = (np.cumsum(counts) - counts)[nonempty]
    out[nonempty] = np.add.reduceat(w[:, None] * (phi_pairs > 0), starts, axis=0)
    own_fix = np.add.reduceat(
        w * (phi_pairs[np.arange(local.shape[0]), own[local]] > 1), starts
    )
    out[np.arange(nr), own] = 0.0
    out[nonempty, own[nonempty]] = own_fix
    return out


def volume_degrees(
    hyper: Hypergraph,
    part: np.ndarray,
    k: int,
    rows: np.ndarray | None = None,
) -> np.ndarray:
    """(R, k) float64 connectivity degree matrix D* for the volume objective.

    D*[v, p] = sum over hyperedges e containing v of hfire[e] * [e has a
    member other than v in partition p].  The exact λ-gain of moving v from
    its partition a to b is then D*[v, b] − D*[v, a] — the same shape as the
    edge-cut refiners' (external − internal) degree arithmetic, so both the
    scalar FM queue and the batched vec refiner consume this matrix
    unchanged.  Entries are integer-valued (exact in float64).
    """
    part = np.asarray(part, dtype=np.int64)
    if rows is None:
        rows = np.arange(hyper.num_vertices, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    nr = rows.shape[0]
    out = np.zeros((nr, k), dtype=np.float64)
    if hyper.num_hyperedges == 0 or nr == 0:
        return out

    vxadj, vedges = hyper.incidence()
    idx, local = csr_gather(vxadj, rows)
    if idx.shape[0] == 0:
        return out
    eids = vedges[idx]  # incident hyperedge per (row, edge) pair

    # Partition member counts Φ(e, p) for the distinct incident hyperedges.
    ue, einv = np.unique(eids, return_inverse=True)
    hu = ue.shape[0]
    pidx, pin_local = csr_gather(hyper.hxadj, ue)
    keys = np.concatenate(
        [
            pin_local * k + part[hyper.hpins[pidx]],
            np.arange(hu, dtype=np.int64) * k + part[hyper.hsrc[ue]],
        ]
    )
    phi = np.bincount(keys, minlength=hu * k).reshape(hu, k)

    counts = (vxadj[rows + 1] - vxadj[rows]).astype(np.int64)
    return presence_degrees(phi[einv], hyper.hfire[eids].astype(np.float64),
                            counts, local, part[rows], k)


def partition_weights(graph: Graph, part: np.ndarray, k: int) -> np.ndarray:
    """(k,) vertex weight (neuron count) per partition."""
    w = np.zeros(k, dtype=np.int64)
    np.add.at(w, part, graph.vwgt)
    return w


def validate_partition(graph: Graph, part: np.ndarray, k: int, capacity: int) -> None:
    """Raise if `part` is not a valid k-way partition within core capacity."""
    if part.shape != (graph.num_vertices,):
        raise ValueError(f"partition vector shape {part.shape} != ({graph.num_vertices},)")
    if part.min() < 0 or part.max() >= k:
        raise ValueError(f"partition ids outside [0, {k})")
    w = partition_weights(graph, part, k)
    if (w > capacity).any():
        bad = np.nonzero(w > capacity)[0]
        raise ValueError(f"partitions {bad.tolist()} exceed capacity {capacity}: {w[bad].tolist()}")
