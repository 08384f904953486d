"""Placement objectives for the mapping phase (paper §3.4, unified engine).

Every mapping search (`repro.core.mapping`) scores candidate placements
through one of the objectives defined here, so the search engines are
objective-agnostic and the quantity the mapper minimizes can be chosen to
match the NoC traffic model the evaluation phase simulates:

* ``PairwiseObjective`` — the paper's Eq. 2: total hop-weighted pairwise
  traffic ``sum_{i,j} d(M(i), M(j)) * C[i, j]``.  Exact for unicast
  replay, but under multicast it double-counts shared XY-tree prefixes.
* ``TreeHopObjective`` — the hfire-weighted XY multicast-tree link count:
  each hyperedge (source partition, destination-partition set) pays its
  fire count once per *link of its multicast tree*, the same accounting
  the tree-fork replay charges per (firing, tree link) traversal
  (`repro.nocsim.xy.multicast_tree_sizes`).  Minimizing it minimizes the
  replay's ``link_traversals`` — and with it dynamic energy — directly.

Both objectives expose the same engine-facing contract:

  ``attach(placement)``          bind a placement, return its exact cost;
  ``swap_delta(a, b)``           incremental cost change of one swap;
  ``swap_delta_batch(aa, bb)``   (B,) independent candidate deltas;
  ``apply_swaps(pairs)``         commit disjoint swaps, return exact cost;
  ``total(placement)``           stateless full evaluation.

The tree objective keeps its incremental state as a per-hyperedge tree-size
cache plus a CSR partition→hyperedge incidence index, so a swap re-evaluates
only the hyperedges incident to the two swapped partitions.  Identical
(source partition, destination set) hyperedges are merged at construction
(their trees are congruent under every placement), which collapses the
neuron-granularity hypergraph to at most one entry per distinct
partition-level multicast pattern.

`evaluate_placement` is the single post-search reporting path: every
toolchain method's ``avg_hop`` (pairwise, Fig. 5 comparability) and
``tree_hop`` come from here, regardless of which objective drove — or
didn't drive — the search.
"""
from __future__ import annotations

import numpy as np

from repro_torch.nocsim.xy import multicast_tree_sizes, segment_extrema2, span_to

from .graph import Hypergraph, csr_gather
from .hopcost import hop_distance_matrix, swap_delta

__all__ = [
    "PairwiseObjective",
    "TreeHopObjective",
    "MigrationAwareObjective",
    "make_objective",
    "validate_objective",
    "evaluate_placement",
    "PLACE_OBJECTIVES",
]


def _sorted_isect(kx: np.ndarray, ky: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Membership masks of the intersection of two ascending key arrays.

    Both inputs must be sorted with no internal duplicates (the incidence
    keys are: candidate-major gathers over edge-sorted CSR rows, and a
    position holds a given role in an edge at most once) — one
    `searchsorted` merge then marks, on each side, the entries whose key
    appears on the other side.
    """
    mx = np.zeros(kx.shape[0], dtype=bool)
    my = np.zeros(ky.shape[0], dtype=bool)
    if kx.shape[0] and ky.shape[0]:
        ins = np.searchsorted(ky, kx)
        ok = np.flatnonzero(ins < ky.shape[0])
        mx[ok] = ky[ins[ok]] == kx[ok]
        my[ins[mx]] = True
    return mx, my


class PairwiseObjective:
    """Eq. 2 hop-weighted pairwise traffic (the paper's mapping objective).

    Owns the shared search preamble — zero-padding the (k, k) traffic
    matrix to the core count, symmetrizing it, and building the hop
    distance matrix — that used to be copied across ``sa_search``,
    ``tabu_search`` and ``pso_search``.
    """

    name = "pairwise"

    def __init__(
        self,
        traffic: np.ndarray,
        num_cores: int,
        mesh_w: int,
        torus: bool = False,
    ):
        k = int(traffic.shape[0])
        if k > num_cores:
            raise ValueError(f"{k} partitions > {num_cores} cores")
        padded = np.zeros((num_cores, num_cores), dtype=np.float64)
        padded[:k, :k] = traffic
        self.num_partitions = k
        self.num_positions = num_cores
        self.mesh_w = mesh_w
        self.torus = torus
        self.sym = padded + padded.T
        self.dist = hop_distance_matrix(num_cores, mesh_w, torus=torus).astype(
            np.float64
        )
        self._placement: np.ndarray | None = None
        # Placement-permuted distance columns, attached-state cache:
        # _dist_p[c, j] = dist[c, placement[j]].  Lets the batch scorer use
        # contiguous row gathers instead of broadcast fancy indexing (the
        # difference between ~5 ms and ~0.3 ms per 512-candidate batch at
        # 256 cores); a committed swap of positions (a, b) just swaps
        # columns a and b.
        self._dist_p: np.ndarray | None = None
        self._total = 0.0

    # -- stateless ---------------------------------------------------------
    def total(self, placement: np.ndarray) -> float:
        """Exact Eq. 2 total of a placement.

        Accepts the full ``num_cores`` permutation or any prefix covering
        the real partitions (virtual-partition traffic is zero, so the
        truncated sum is identical) — which is what lets the shared
        evaluator score a (k,)-length finished placement directly.
        """
        m = placement.shape[0]
        if m < self.num_partitions:
            raise ValueError(f"placement covers {m} < {self.num_partitions} partitions")
        d = self.dist[placement[:, None], placement[None, :]]
        return float((d * self.sym[:m, :m]).sum() / 2.0)

    # -- engine-facing incremental API ------------------------------------
    def attach(self, placement: np.ndarray) -> float:
        self._placement = placement
        self._dist_p = np.ascontiguousarray(self.dist[:, placement])
        self._total = self.total(placement)
        return self._total

    def swap_delta(self, a: int, b: int) -> float:
        return swap_delta(self.sym, self._placement, self.dist, a, b)

    def swap_delta_batch(self, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
        """Vectorized `hopcost.swap_delta_batch` over the attached placement.

        Same formula, but the placed distances come from the cached
        ``_dist_p`` columns so both distance operands are plain row
        gathers.
        """
        aa = np.asarray(aa, dtype=np.int64)
        bb = np.asarray(bb, dtype=np.int64)
        p, dp = self._placement, self._dist_p
        diff = (self.sym[aa] - self.sym[bb]) * (dp[p[bb]] - dp[p[aa]])
        rows = np.arange(aa.shape[0])
        return diff.sum(axis=1) - diff[rows, aa] - diff[rows, bb]

    def apply_swaps(self, pairs: np.ndarray, total_delta: float | None = None) -> float:
        """Commit position-disjoint swaps to the attached placement.

        A single swap updates the cached total with the O(K) incremental
        delta (``total_delta`` lets the engine hand back the delta it
        already scored, skipping the recompute); larger batches swap all
        positions at once and re-evaluate the O(K^2) total exactly (one
        row gather + reduction — still far cheaper per proposal than
        scoring the batch), so the returned cost is exact either way and
        incremental drift cannot accumulate past the final re-evaluation.
        """
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        p = self._placement
        if pairs.shape[0] == 0:
            return self._total
        aa, bb = pairs[:, 0], pairs[:, 1]
        if pairs.shape[0] == 1:
            a, b = int(aa[0]), int(bb[0])
            self._total += (self.swap_delta(a, b) if total_delta is None
                            else total_delta)
            p[a], p[b] = p[b], p[a]
        else:
            p[aa], p[bb] = p[bb].copy(), p[aa].copy()
        self._dist_p[:, aa], self._dist_p[:, bb] = (
            self._dist_p[:, bb].copy(), self._dist_p[:, aa].copy()
        )
        if pairs.shape[0] > 1:
            self._total = float(
                (self.sym * self._dist_p[p]).sum() / 2.0
            )
        return self._total


class TreeHopObjective:
    """hfire-weighted XY multicast-tree link count (tree-hop objective).

    cost(M) = sum_e  w_e * |tree(M(src_e), {M(d) : d in dests_e})|

    where e ranges over the distinct partition-level multicast patterns of
    ``hyper`` under ``part`` (hyperedges with identical source partition
    and destination-partition set merged, ``w_e`` their summed fire
    counts) and ``tree`` is the union of deterministic XY routes — exactly
    the per-firing link set the tree-fork replay traverses, so
    ``total(placement)`` equals the multicast replay's ``link_traversals``
    for that placement.

    Swaps are scored incrementally: a CSR index maps each placement
    position (partition) to the hyperedges it is source or destination of,
    and each incident tree is re-priced in O(1) from member-level
    aggregates instead of being re-measured member by member.

    Aggregate invariants (maintained for the attached placement; all
    quantities integer, so incremental sizes are *exact*, never drift):

    * ``_cnt[e, c]`` — number of destination members of hyperedge ``e``
      placed in mesh column ``c``.  Members are distinct partitions and a
      placement is a permutation, so within one column of one edge the
      member *rows* are distinct.
    * ``_rmin1/_rmin2/_rmax1/_rmax2[e, c]`` — the two extreme (and
      strictly distinct) destination rows of edge ``e`` in column ``c``,
      with sentinels ``mesh_h``/``-1`` when fewer than two members occupy
      the column (`repro.nocsim.xy.segment_extrema2`).
    * ``_cmin1/_cmin2/_cmax1/_cmax2[e]`` — the two extreme *distinct
      occupied* columns of edge ``e`` (sentinels ``mesh_w``/``-1``).

    A tree's size is then the closed form (`repro.nocsim.xy.span_to`)

      ``size(e) = span_to(sx, _cmin1[e], _cmax1[e])
                + sum_c  [_cnt[e, c] > 0] * span_to(sy, _rmin1[e,c], _rmax1[e,c])``

    with ``(sx, sy)`` the source partition's core coordinates — the same
    horizontal-segment + per-column-vertical-segment algebra
    `multicast_tree_sizes` evaluates by sorting route offsets, pinned
    equal by the engine tests.  Because the aggregates do not involve the
    source position at all, a candidate that moves only the *source* of an
    edge re-evaluates this form over unchanged aggregates (O(mesh_w));
    a candidate that moves one *destination* member re-prices the edge in
    O(1): top-2 extremes make removal of a non-extreme member free and
    extreme removal a fallback to the runner-up, insertion is a min/max
    against the new coordinate.  Only candidates touching two members (or
    a member and the source) of the same edge fall back to the exact
    route-expansion re-measure.

    The aggregates are maintained *lazily*: they are built on the first
    `swap_delta_batch` call and commits only mark their member-touched
    edges dirty, so the one batched rebuild reduction per search step is
    amortized over the whole candidate batch — and the scalar
    propose-then-commit chain (`swap_delta` + pending reuse), which never
    scores batches, never pays for aggregates at all.  Any accepted-swap
    sequence leaves the synced aggregates identical to a from-scratch
    attach.
    """

    name = "tree"

    def __init__(
        self,
        hyper: Hypergraph,
        part: np.ndarray,
        num_cores: int,
        mesh_w: int,
        mesh_h: int | None = None,
    ):
        part = np.asarray(part, dtype=np.int64)
        k = int(part.max()) + 1 if part.shape[0] else 0
        if k > num_cores:
            raise ValueError(f"{k} partitions > {num_cores} cores")
        self.num_partitions = k
        self.num_positions = num_cores
        # Construction inputs, kept for `validate_objective`: the derived
        # tables are bound to exactly this (hyper, part) pair, so reuse
        # under a different partitioning must be detectable.
        self._part = part.copy()
        self._hyper = hyper
        self.mesh_w = mesh_w
        self.mesh_h = (
            mesh_h if mesh_h is not None else -(-num_cores // mesh_w)
        )
        if self.mesh_w * self.mesh_h < num_cores:
            raise ValueError("mesh smaller than num_cores")

        # Partition-level destination sets: distinct dest partitions per
        # hyperedge, excluding the source's own partition (core-local
        # deliveries never enter the NoC).
        ps_all = part[hyper.hsrc.astype(np.int64)]
        pp = part[hyper.hpins.astype(np.int64)]
        pe = hyper.pin_edge
        remote = pp != ps_all[pe]
        ukey = np.unique(pe[remote] * np.int64(max(k, 1)) + pp[remote])
        uedge, dpart = ukey // max(k, 1), ukey % max(k, 1)
        eids, ecount = np.unique(uedge, return_counts=True)

        # Merge hyperedges whose (source partition, dest set) coincide:
        # their multicast trees are congruent under every placement, so
        # only the summed fire count matters.  Dest sets are compared
        # exactly as k-bit bitset rows.
        ne = eids.shape[0]
        ps = ps_all[eids]
        fire = hyper.hfire[eids].astype(np.float64)
        nb = (k + 63) // 64 if k else 1
        bits = np.zeros((ne, nb), dtype=np.uint64)
        row = np.repeat(np.arange(ne, dtype=np.int64), ecount)
        np.bitwise_or.at(
            bits, (row, dpart >> 6), np.uint64(1) << (dpart & 63).astype(np.uint64)
        )
        sig = np.concatenate([ps[:, None].astype(np.uint64), bits], axis=1)
        _, rep, inv = np.unique(sig, axis=0, return_index=True, return_inverse=True)
        t = rep.shape[0]
        self.tw = np.bincount(inv, weights=fire, minlength=t)
        self.tsrc = ps[rep]
        lens = ecount[rep]
        self.tptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        ent, _ = csr_gather(
            np.concatenate([[0], np.cumsum(ecount)]).astype(np.int64), rep
        )
        self.tdst = dpart[ent]
        self.num_hyperedges = t
        self.lens = lens.astype(np.int64)

        # Split CSR incidence indexes: position -> hyperedges it is a
        # destination member of (`imlist`/`imptr`) and position ->
        # hyperedges it is the source of (`islist`/`isptr`).  Positions
        # >= k (virtual partitions) have empty rows, so swaps among them
        # are free, exactly as the pairwise objective's zero-padded
        # traffic makes them.  Keeping the roles in separate indexes lets
        # the batch scorer run the O(1) member-move and O(w) source-move
        # paths over homogeneous record arrays with no per-record role
        # masking; rows are edge-sorted (a position holds a given role in
        # an edge at most once, so ids within a row are strictly
        # increasing), so a candidate-major gather yields globally
        # ascending (candidate, edge) keys and edges incident to *both*
        # swapped positions fall out of `searchsorted` merges instead of
        # per-batch argsorts.
        meid = np.repeat(np.arange(t, dtype=np.int64), lens)
        order = np.lexsort((meid, self.tdst))
        self.imlist = meid[order]
        imptr = np.zeros(num_cores + 1, dtype=np.int64)
        np.add.at(imptr, self.tdst + 1, 1)
        self.imptr = np.cumsum(imptr)
        order = np.argsort(self.tsrc, kind="stable")
        self.islist = np.arange(t, dtype=np.int64)[order]
        isptr = np.zeros(num_cores + 1, dtype=np.int64)
        np.add.at(isptr, self.tsrc + 1, 1)
        self.isptr = np.cumsum(isptr)

        self._placement: np.ndarray | None = None
        self._sizes: np.ndarray | None = None
        self._total = 0.0
        # Member-level aggregate tables (see the class docstring), built
        # lazily by the first `swap_delta_batch` and re-synced from the
        # `_dirty` edge list a commit leaves behind.
        self._cnt: np.ndarray | None = None
        self._rmin1 = self._rmin2 = self._rmax1 = self._rmax2 = None
        self._cmin1 = self._cmin2 = self._cmax1 = self._cmax2 = None
        self._dirty: list[np.ndarray] = []
        self._dirty_src: list[np.ndarray] = []
        # Last single-pair proposal scored by `swap_delta`: (a, b, edges,
        # their re-measured sizes).  `apply_swaps` of that same pair
        # reuses the measurement instead of paying the geometry twice —
        # the propose-then-commit pattern of the scalar SA chain.
        self._pending: tuple | None = None

    # -- geometry ----------------------------------------------------------
    def _tree_sizes(
        self, edges: np.ndarray, src_core: np.ndarray, dst_core: np.ndarray,
        inst: np.ndarray, n: int,
    ) -> np.ndarray:
        return multicast_tree_sizes(
            src_core, dst_core, inst, self.mesh_w, self.mesh_h, n
        )

    def _sizes_of(self, edges: np.ndarray, placement: np.ndarray) -> np.ndarray:
        """Tree-link count of each listed hyperedge under ``placement``."""
        ent, inst = csr_gather(self.tptr, edges)
        src_core = placement[self.tsrc[edges]][inst]
        dst_core = placement[self.tdst[ent]]
        return self._tree_sizes(edges, src_core, dst_core, inst, edges.shape[0])

    # -- stateless ---------------------------------------------------------
    def total(self, placement: np.ndarray) -> float:
        edges = np.arange(self.num_hyperedges, dtype=np.int64)
        return float((self.tw * self._sizes_of(edges, placement)).sum())

    # -- aggregate maintenance ---------------------------------------------
    def _agg_rebuild(self, edges: np.ndarray) -> None:
        """Recompute the member-level aggregates of ``edges`` from scratch.

        One batched top-2 reduction over the listed edges' members under
        the attached placement — the vectorized form of the per-column
        rescan an extreme-member removal needs, applied wholesale to the
        touched edges of a commit.
        """
        w, h = self.mesh_w, self.mesh_h
        ent, inst = csr_gather(self.tptr, edges)
        d = self._placement[self.tdst[ent]]
        c, r = d % w, d // w
        # Sentinel-reset the listed edges' cells, then scatter the sparse
        # top-2 reduction back over just the occupied ones — at larger
        # meshes most (edge, column) cells are empty, and never
        # materializing them keeps a commit's rebuild proportional to the
        # members gathered, not the mesh width.
        self._cnt[edges] = 0
        self._rmin1[edges] = h
        self._rmin2[edges] = h
        self._rmax1[edges] = -1
        self._rmax2[edges] = -1
        self._cmin1[edges] = w
        self._cmin2[edges] = w
        self._cmax1[edges] = -1
        self._cmax2[edges] = -1
        useg, cnt, rmin1, rmin2, rmax1, rmax2 = segment_extrema2(
            inst * w + c, r, h
        )
        if useg.shape[0] == 0:
            return
        ue, uc = useg // w, useg % w
        gfi = edges[ue] * w + uc
        self._cntf[gfi] = cnt
        self._rmin1f[gfi] = rmin1
        self._rmin2f[gfi] = rmin2
        self._rmax1f[gfi] = rmax1
        self._rmax2f[gfi] = rmax2
        # Top-2 distinct occupied columns per edge, off the same sparse
        # run: `useg` ascends, so each edge's occupied columns form one
        # contiguous ascending slice whose boundary entries are the
        # extremes and their runners-up.
        m = ue.shape[0]
        lastc = np.empty(m, dtype=bool)
        lastc[-1] = True
        np.not_equal(ue[1:], ue[:-1], out=lastc[:-1])
        firstc = np.empty(m, dtype=bool)
        firstc[0] = True
        firstc[1:] = lastc[:-1]
        fidx = np.flatnonzero(firstc)
        lidx = np.flatnonzero(lastc)
        eid = edges[ue[fidx]]
        self._cmin1[eid] = uc[fidx]
        self._cmax1[eid] = uc[lidx]
        has2 = lidx > fidx
        self._cmin2[eid[has2]] = uc[fidx[has2] + 1]
        self._cmax2[eid[has2]] = uc[lidx[has2] - 1]

    def _sizes_from_agg(self, edges: np.ndarray) -> np.ndarray:
        """Closed-form tree sizes of ``edges`` from the synced span caches."""
        return (self._hsp[edges] + self._vsp[edges].sum(axis=1)).astype(np.int64)

    # -- engine-facing incremental API ------------------------------------
    def attach(self, placement: np.ndarray) -> float:
        edges = np.arange(self.num_hyperedges, dtype=np.int64)
        self._placement = placement
        self._sizes = self._sizes_of(edges, placement)
        self._total = float((self.tw * self._sizes).sum())
        self._pending = None
        # Aggregates are placement-derived: invalidate wholesale, the
        # first batch scoring against this placement rebuilds them.
        self._cnt = None
        self._dirty = []
        self._dirty_src = []
        return self._total

    def _span_refresh(self, edges: np.ndarray) -> None:
        """Refresh the derived per-edge span caches of ``edges``.

        ``_srcx/_srcy`` are the source core's coordinates, ``_hsp`` the
        edge's current horizontal span and ``_vsp[:, c]`` its current
        vertical span in column ``c`` (0 for unoccupied columns, by the
        sentinel algebra) — all derived from the aggregate tables plus the
        attached placement, so the member-move path reads the *current*
        spans as gathers and computes only the changed ones.
        """
        s = self._placement[self.tsrc[edges]]
        w = self.mesh_w
        sx = (s % w).astype(np.int32)
        sy = (s // w).astype(np.int32)
        self._srcx[edges] = sx
        self._srcy[edges] = sy
        self._hsp[edges] = span_to(sx, self._cmin1[edges], self._cmax1[edges])
        self._vsp[edges] = span_to(
            sy[:, None], self._rmin1[edges], self._rmax1[edges]
        )

    def _agg_sync(self) -> None:
        """Bring the aggregate tables up to date with the placement.

        The first call allocates and builds every table; later calls
        rebuild only what commits marked dirty since the last sync — a
        full member reduction for edges whose *members* moved, just the
        derived span caches for edges whose *source* moved — one batched
        pass per search step, amortized over the whole candidate batch
        scored against it.
        """
        t, w = self.num_hyperedges, self.mesh_w
        if self._cnt is None:
            self._cnt = np.zeros((t, w), dtype=np.int32)
            self._rmin1 = np.empty((t, w), dtype=np.int32)
            self._rmin2 = np.empty((t, w), dtype=np.int32)
            self._rmax1 = np.empty((t, w), dtype=np.int32)
            self._rmax2 = np.empty((t, w), dtype=np.int32)
            self._cmin1 = np.empty(t, dtype=np.int32)
            self._cmin2 = np.empty(t, dtype=np.int32)
            self._cmax1 = np.empty(t, dtype=np.int32)
            self._cmax2 = np.empty(t, dtype=np.int32)
            self._vsp = np.empty((t, w), dtype=np.int32)
            self._hsp = np.empty(t, dtype=np.int32)
            self._srcx = np.empty(t, dtype=np.int32)
            self._srcy = np.empty(t, dtype=np.int32)
            # Raveled views of the per-(edge, column) tables: the
            # member-move path gathers at computed flat indices, cheaper
            # than 2D fancy indexing (the tables are written in place by
            # `_agg_rebuild`, so the views stay valid).
            self._cntf = self._cnt.ravel()
            self._rmin1f = self._rmin1.ravel()
            self._rmin2f = self._rmin2.ravel()
            self._rmax1f = self._rmax1.ravel()
            self._rmax2f = self._rmax2.ravel()
            self._vspf = self._vsp.ravel()
            edges = np.arange(t, dtype=np.int64)
            self._agg_rebuild(edges)
            self._span_refresh(edges)
        else:
            mem = None
            if self._dirty:
                d = self._dirty
                mem = d[0] if len(d) == 1 else np.unique(np.concatenate(d))
                self._agg_rebuild(mem)
            d = self._dirty_src + ([mem] if mem is not None else [])
            if d:
                edges = d[0] if len(d) == 1 else np.unique(np.concatenate(d))
                self._span_refresh(edges)
        self._dirty = []
        self._dirty_src = []

    def _incident(self, positions: np.ndarray) -> np.ndarray:
        """Deduplicated hyperedges incident to any of ``positions``."""
        me, _ = csr_gather(self.imptr, positions)
        se, _ = csr_gather(self.isptr, positions)
        return np.unique(np.concatenate([self.imlist[me], self.islist[se]]))

    def swap_delta(self, a: int, b: int) -> float:
        e = self._incident(np.array([a, b], dtype=np.int64))
        if e.shape[0] == 0:
            self._pending = None
            return 0.0
        p2 = self._placement.copy()
        p2[a], p2[b] = p2[b], p2[a]
        new_sizes = self._sizes_of(e, p2)
        self._pending = (int(a), int(b), e, new_sizes)
        return float((self.tw[e] * (new_sizes - self._sizes[e])).sum())

    def swap_delta_batch(self, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
        """(B,) independent candidate deltas against the attached placement.

        Aggregate-priced: each candidate re-prices only the hyperedges
        incident to its two positions — O(1) per edge whose destination
        *member* moves, O(mesh_w) per edge whose *source* moves, and the
        exact route-expansion fallback only for the rare edges incident
        to both swapped positions.  Every contribution is an integer
        tree-size change times the integer fire weight, each delta a sum
        of exactly representable floats — so batched deltas equal the
        scalar `swap_delta` values bitwise, not approximately.
        """
        aa = np.asarray(aa, dtype=np.int64)
        bb = np.asarray(bb, dtype=np.int64)
        nb = aa.shape[0]
        self._agg_sync()
        p = self._placement
        t, w = self.num_hyperedges, self.mesh_w
        mea, mca = csr_gather(self.imptr, aa)
        meb, mcb = csr_gather(self.imptr, bb)
        sea, sca = csr_gather(self.isptr, aa)
        seb, scb = csr_gather(self.isptr, bb)
        ma_e, mb_e = self.imlist[mea], self.imlist[meb]
        sa_e, sb_e = self.islist[sea], self.islist[seb]
        if (ma_e.shape[0] + mb_e.shape[0] + sa_e.shape[0] + sb_e.shape[0]) == 0:
            return np.zeros(nb, dtype=np.float64)
        paa, pbb = p[aa], p[bb]
        p32a, p32b = paa.astype(np.int32), pbb.astype(np.int32)

        # Dual incidence — an edge touching both swapped positions — comes
        # out of sorted-key merges between the four role-homogeneous
        # incidence gathers.  Member+member duals just exchange two dest
        # cores: the dest multiset (and so the tree) is unchanged and the
        # contribution exactly zero, so both records are dropped.  Only
        # source+member duals need the exact route-expansion fallback.
        mm_a, mm_b = _sorted_isect(mca * t + ma_e, mcb * t + mb_e)
        sm_a, sm_b = _sorted_isect(sca * t + sa_e, mcb * t + mb_e)
        ms_a, ms_b = _sorted_isect(mca * t + ma_e, scb * t + sb_e)
        fb_e = fb_c = None
        if sm_a.any() or ms_a.any():
            fb_e = np.concatenate([sa_e[sm_a], ma_e[ms_a]])
            fb_c = np.concatenate([sca[sm_a], mca[ms_a]])
            sa_e, sca = sa_e[~sm_a], sca[~sm_a]
            sb_e, scb = sb_e[~ms_b], scb[~ms_b]
        drop = mm_a | ms_a
        if drop.any():
            keep = ~drop
            ma_e, mca = ma_e[keep], mca[keep]
        drop = mm_b | sm_b
        if drop.any():
            keep = ~drop
            mb_e, mcb = mb_e[keep], mcb[keep]

        # One single-sided record per remaining (candidate, edge): that
        # candidate moves the record's incident position from core `o`
        # to core `n2`, the other position doesn't touch this edge.
        # Coordinates and spans are int32 throughout — half the memory
        # traffic of the default int64, which is what bounds this path.

        # Destination-member move: O(1) re-pricing from the top-2
        # extremes — remove (old column, old row), insert (new column,
        # new row), re-span only the one or two affected segments against
        # the cached current spans.
        cand = np.concatenate([mca, mcb])
        deltas = np.zeros(nb, dtype=np.float64)
        if cand.shape[0]:
            e = np.concatenate([ma_e, mb_e])
            o = np.concatenate([p32a[mca], p32b[mcb]])
            n2 = np.concatenate([p32b[mca], p32a[mcb]])
            c, r = o % w, o // w
            c2, r2 = n2 % w, n2 // w
            sx, sy = self._srcx[e], self._srcy[e]
            fi = e * w + c
            fi2 = e * w + c2
            cmax1, cmax2 = self._cmax1[e], self._cmax2[e]
            cmin1, cmin2 = self._cmin1[e], self._cmin2[e]
            gone = self._cntf[fi] == 1  # removal empties column c
            cmax_rm = np.where(gone & (c == cmax1), cmax2, cmax1)
            cmin_rm = np.where(gone & (c == cmin1), cmin2, cmin1)
            hs = span_to(
                sx, np.minimum(cmin_rm, c2), np.maximum(cmax_rm, c2)
            ) - self._hsp[e]
            # Old column: rows are distinct within a column, so removing
            # the extreme falls back to the runner-up exactly.
            rmax1c, rmax2c = self._rmax1f[fi], self._rmax2f[fi]
            rmin1c, rmin2c = self._rmin1f[fi], self._rmin2f[fi]
            rmax_rm = np.where(r == rmax1c, rmax2c, rmax1c)
            rmin_rm = np.where(r == rmin1c, rmin2c, rmin1c)
            same = c2 == c
            prmax = np.where(same, np.maximum(rmax_rm, r2), rmax_rm)
            prmin = np.where(same, np.minimum(rmin_rm, r2), rmin_rm)
            v_c = span_to(sy, prmin, prmax) - self._vspf[fi]
            # New column (when different): plain insertion against the
            # current extremes (sentinels make the empty case exact).
            rmax1c2, rmin1c2 = self._rmax1f[fi2], self._rmin1f[fi2]
            v_c2 = np.where(
                same,
                0,
                span_to(sy, np.minimum(rmin1c2, r2), np.maximum(rmax1c2, r2))
                - self._vspf[fi2],
            )
            contrib = self.tw[e] * (hs + v_c + v_c2)
            # (the cast is for numpy's empty-weighted-bincount int64 quirk)
            deltas += np.bincount(cand, weights=contrib, minlength=nb).astype(
                np.float64, copy=False
            )

        # Source move: aggregates are source-independent, so the new size
        # is the closed form over unchanged tables at the new source core
        # (sentinel columns span 0, so no occupancy mask is needed).
        cand = np.concatenate([sca, scb])
        if cand.shape[0]:
            e = np.concatenate([sa_e, sb_e])
            s2 = np.concatenate([p32b[sca], p32a[scb]])
            sx, sy = s2 % w, s2 // w
            hspan = span_to(sx, self._cmin1[e], self._cmax1[e])
            vspan = span_to(sy[:, None], self._rmin1[e], self._rmax1[e]).sum(
                axis=1, dtype=np.int64
            )
            contrib = self.tw[e] * (hspan + vspan - self._sizes[e])
            deltas += np.bincount(cand, weights=contrib, minlength=nb).astype(
                np.float64, copy=False
            )

        if fb_e is not None:
            ci = fb_c
            ent2, inst2 = csr_gather(self.tptr, fb_e)

            def swapped_core(x, i):
                px = p[x]
                px = np.where(x == aa[i], pbb[i], px)
                return np.where(x == bb[i], paa[i], px)

            src_core = swapped_core(self.tsrc[fb_e], ci)[inst2]
            dst_core = swapped_core(self.tdst[ent2], ci[inst2])
            ns = self._tree_sizes(fb_e, src_core, dst_core, inst2, fb_e.shape[0])
            deltas += np.bincount(
                ci, weights=self.tw[fb_e] * (ns - self._sizes[fb_e]), minlength=nb
            )
        return deltas

    def apply_swaps(self, pairs: np.ndarray, total_delta: float | None = None) -> float:
        """Commit position-disjoint swaps; re-measure incident trees once.

        Exact: hyperedges not incident to any swapped position keep their
        cached tree size, incident ones are re-measured under the final
        placement, so the returned total is the true cost — no incremental
        drift even though the batch was *scored* with per-candidate
        deltas.  Committing the single pair `swap_delta` just scored
        reuses its measurement (``total_delta`` itself is ignored here:
        the size cache must be refreshed regardless, and the pending
        measurement already carries the delta).  When the lazy aggregate
        tables are live, edges whose *members* moved are marked dirty for
        the next `swap_delta_batch` sync; source-only edges stay clean —
        the aggregates never involve the source position.
        """
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if pairs.shape[0] == 0:
            return self._total
        p = self._placement
        aa, bb = pairs[:, 0], pairs[:, 1]
        pending = self._pending
        self._pending = None
        p[aa], p[bb] = p[bb].copy(), p[aa].copy()
        use_pending = (pairs.shape[0] == 1 and pending is not None
                       and pending[0] == int(aa[0]) and pending[1] == int(bb[0]))
        if use_pending:
            _, _, touched, new_sizes = pending
        if not use_pending or self._cnt is not None:
            pos = np.concatenate([aa, bb])
            me, _ = csr_gather(self.imptr, pos)
            se, _ = csr_gather(self.isptr, pos)
            mem = self.imlist[me]
            srcd = self.islist[se]
            if not use_pending:
                touched = np.unique(np.concatenate([mem, srcd]))
        if self._cnt is not None:
            if mem.shape[0]:
                self._dirty.append(np.unique(mem))
            # Source-touched edges keep their aggregates but the derived
            # span caches read the source coordinates — refresh those.
            # (Each edge has one source and commits swap distinct
            # positions, so this list is duplicate-free as built.)
            if srcd.shape[0]:
                self._dirty_src.append(srcd)
            # Sync here rather than at the next batch scoring call: the
            # refreshed span caches then price the touched trees in
            # closed form, cheaper than the route-expansion re-measure.
            self._agg_sync()
            if not use_pending:
                new_sizes = (self._sizes_from_agg(touched) if touched.shape[0]
                             else self._sizes[touched])
        elif not use_pending:
            new_sizes = (self._sizes_of(touched, p) if touched.shape[0]
                         else self._sizes[touched])
        if touched.shape[0]:
            self._total += float(
                (self.tw[touched] * (new_sizes - self._sizes[touched])).sum()
            )
            self._sizes[touched] = new_sizes
        return self._total


class MigrationAwareObjective:
    """Wrap a placement objective with per-position migration pricing.

    Used by the incremental re-mapper (`repro.core.remap`): the search
    starts from the *live* placement and every candidate is charged, on
    top of the base hop/tree-hop cost, for the neurons it would move:

      penalty(M) = sum_j  move_cost[j] * [M(j) != live(j)]
                 + forbid * sum_j [w_j > 0] * dead[M(j)]

    where ``move_cost[j] = migration_cost * move_weight[j]`` (the neuron
    count of partition j — virtual positions weigh zero, so parking them
    anywhere is free) and the ``forbid`` term makes placing a *real*
    partition on a failed core worse than any achievable hop gain while
    staying finite, so swap deltas remain exactly the difference of
    totals and the metamorphic delta tests hold on faulty meshes too.

    The wrapper satisfies the same engine contract as the base objective
    and shares the attached placement array with it (``attach`` binds the
    identical object to both), so the base's committed swaps are visible
    here without synchronization.  ``name`` is ``"mig+<base>"`` — never a
    bare objective name, so reporting paths that special-case
    ``"pairwise"``/``"tree"`` re-score through a clean objective instead
    of leaking the penalty into avg_hop.
    """

    def __init__(
        self,
        base,
        live_placement: np.ndarray,
        move_weight: np.ndarray,
        migration_cost: float,
        dead_cores: np.ndarray | None = None,
        forbid_penalty: float = 0.0,
    ):
        n = base.num_positions
        live = np.asarray(live_placement, dtype=np.int64)
        if live.shape[0] != n:
            raise ValueError(
                f"live placement covers {live.shape[0]} != {n} positions"
            )
        w = np.zeros(n, dtype=np.float64)
        mw = np.asarray(move_weight, dtype=np.float64)
        w[: mw.shape[0]] = mw
        self.base = base
        self.name = f"mig+{base.name}"
        self.num_positions = n
        self.num_partitions = base.num_partitions
        self.live = live.copy()
        self.move_cost = w * float(migration_cost)
        self.real = w > 0
        self.dead = (
            np.zeros(n, dtype=bool) if dead_cores is None
            else np.asarray(dead_cores, dtype=bool).copy()
        )
        self.forbid_penalty = float(forbid_penalty)
        self._placement: np.ndarray | None = None
        self._pen_total = 0.0

    # -- penalty geometry --------------------------------------------------
    def _pen(self, pos: np.ndarray, core: np.ndarray) -> np.ndarray:
        """Penalty of placing partition(s) ``pos`` on core(s) ``core``."""
        moved = self.move_cost[pos] * (core != self.live[pos])
        forbid = self.forbid_penalty * (self.real[pos] & self.dead[core])
        return moved + forbid

    def penalty_total(self, placement: np.ndarray) -> float:
        pos = np.arange(placement.shape[0], dtype=np.int64)
        return float(self._pen(pos, placement).sum())

    # -- stateless ---------------------------------------------------------
    def total(self, placement: np.ndarray) -> float:
        return self.base.total(placement) + self.penalty_total(placement)

    # -- engine-facing incremental API ------------------------------------
    def attach(self, placement: np.ndarray) -> float:
        base_total = self.base.attach(placement)
        self._placement = self.base._placement
        self._pen_total = self.penalty_total(self._placement)
        return base_total + self._pen_total

    def _swap_pen_delta(self, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
        p = self._placement
        return (
            self._pen(aa, p[bb]) + self._pen(bb, p[aa])
            - self._pen(aa, p[aa]) - self._pen(bb, p[bb])
        )

    def swap_delta(self, a: int, b: int) -> float:
        aa = np.array([a], dtype=np.int64)
        bb = np.array([b], dtype=np.int64)
        return self.base.swap_delta(a, b) + float(self._swap_pen_delta(aa, bb)[0])

    def swap_delta_batch(self, aa: np.ndarray, bb: np.ndarray) -> np.ndarray:
        aa = np.asarray(aa, dtype=np.int64)
        bb = np.asarray(bb, dtype=np.int64)
        return self.base.swap_delta_batch(aa, bb) + self._swap_pen_delta(aa, bb)

    def apply_swaps(self, pairs: np.ndarray, total_delta: float | None = None) -> float:
        # The engine's total_delta includes the penalty part, which the
        # base must not fold into its hop total — commit through the base
        # with its own exact accounting and refresh the O(K) penalty.
        base_total = self.base.apply_swaps(pairs)
        self._pen_total = self.penalty_total(self._placement)
        return base_total + self._pen_total


PLACE_OBJECTIVES = ("pairwise", "tree")


def make_objective(
    kind: str,
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    mesh_h: int | None = None,
    torus: bool = False,
    hyper: Hypergraph | None = None,
    part: np.ndarray | None = None,
):
    """Build a placement objective by name.

    ``"pairwise"`` needs only the (k, k) traffic matrix; ``"tree"``
    additionally needs the profiled multicast hypergraph and the partition
    vector (to form destination-partition sets), and is mesh-only (XY
    trees have no torus form).
    """
    if kind == "pairwise":
        return PairwiseObjective(traffic, num_cores, mesh_w, torus=torus)
    if kind == "tree":
        if hyper is None or part is None:
            raise ValueError("tree objective needs hyper= and part=")
        if torus:
            raise ValueError("tree objective is mesh-only (no torus XY trees)")
        return TreeHopObjective(hyper, part, num_cores, mesh_w, mesh_h)
    raise ValueError(f"unknown placement objective {kind!r}")


def validate_objective(
    obj,
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int | None = None,
    mesh_h: int | None = None,
    part: np.ndarray | None = None,
    hyper: Hypergraph | None = None,
    torus: bool = False,
    strict: bool = True,
) -> bool:
    """Check that ``obj`` was built for this run's (traffic, partition, mesh).

    Objective instances are stateful *and* construction-bound: a
    ``PairwiseObjective`` bakes in the symmetrized traffic matrix, a
    ``TreeHopObjective`` its partition-level multicast patterns.  Reusing
    one across runs whose partition or traffic differ (the sweep hazard:
    one ``mapper_kwargs={"objective": ...}`` dict shared over a config
    grid) silently scores the wrong quantity.  Returns True when the
    instance matches; on mismatch raises ``ValueError`` naming the
    mismatched facet (``strict=True``, the search-time behavior) or
    returns False (``strict=False``, the reporting-time behavior —
    `evaluate_placement` then rebuilds a fresh objective instead).

    Content comparisons run only when the identity fast path fails, so
    the common flow — one objective built and consumed inside one run —
    validates at pointer-compare cost.
    """
    def fail(msg: str) -> bool:
        if strict:
            raise ValueError(
                f"reused {obj.name!r} objective does not match this run: "
                f"{msg}; build a fresh objective per (traffic, partition, "
                f"mesh) — see make_objective()"
            )
        return False

    name = getattr(obj, "name", None)
    if name not in ("pairwise", "tree"):
        return fail(f"unexpected objective name {name!r}")
    if obj.num_positions != num_cores:
        return fail(f"built for {obj.num_positions} cores, run has {num_cores}")
    if mesh_w is not None and obj.mesh_w != mesh_w:
        return fail(f"built for mesh_w={obj.mesh_w}, run has {mesh_w}")
    k = int(traffic.shape[0])
    if name == "pairwise":
        if obj.torus != torus:
            return fail(f"built with torus={obj.torus}, run has {torus}")
        if obj.num_partitions != k:
            return fail(f"built for k={obj.num_partitions}, run has k={k}")
        sym = np.asarray(traffic, dtype=np.float64)
        if not np.array_equal(obj.sym[:k, :k], sym + sym.T):
            return fail("traffic matrix content differs")
        return True
    if torus:
        return fail("tree objective is mesh-only, run is torus")
    if mesh_h is not None and obj.mesh_h != mesh_h:
        return fail(f"built for mesh_h={obj.mesh_h}, run has {mesh_h}")
    if part is not None:
        part = np.asarray(part, dtype=np.int64)
        if obj._part is not part and not np.array_equal(obj._part, part):
            return fail("partition vector content differs")
    if hyper is not None and obj._hyper is not hyper:
        h0 = obj._hyper
        same = (
            np.array_equal(h0.hxadj, hyper.hxadj)
            and np.array_equal(h0.hpins, hyper.hpins)
            and np.array_equal(h0.hsrc, hyper.hsrc)
            and np.array_equal(h0.hfire, hyper.hfire)
        )
        if not same:
            return fail("hypergraph content differs")
    return True


def evaluate_placement(
    placement: np.ndarray,
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    mesh_h: int | None = None,
    hyper: Hypergraph | None = None,
    part: np.ndarray | None = None,
    torus: bool = False,
    reuse=None,
) -> tuple[float, float | None]:
    """Score a finished placement under both objectives: (avg_hop, tree_hop).

    The one reporting path every toolchain method goes through (SA/tabu/PSO
    searches, device mappers, and SCO's sequential placement alike), so
    cross-method comparisons are never an artifact of who computed the
    metric.  ``avg_hop`` is the paper's Eq. 2 average (pairwise hops per
    packet of the run's traffic model); ``tree_hop`` is the multicast
    tree-link traversals per packet under the same normalization, or None
    when no hypergraph is available (or on torus meshes, which have no XY
    trees).  ``reuse`` accepts an already-built objective instance (either
    kind — e.g. the one that drove the search) so its construction cost is
    not paid twice; it is *validated* against this call's traffic/
    partition/mesh first (`validate_objective`) and silently replaced by a
    fresh build on mismatch, so an objective carried over from a different
    run can never skew the reported stats; scoring through a matching one
    is stateless (``total``), so its attached search state is irrelevant.
    """
    placement = np.asarray(placement, dtype=np.int64)
    denom = max(trace_length, 1)

    def usable(kind: str) -> bool:
        return (reuse is not None and getattr(reuse, "name", None) == kind
                and validate_objective(reuse, traffic, num_cores, mesh_w,
                                       mesh_h=mesh_h, part=part, hyper=hyper,
                                       torus=torus, strict=False))

    pw = (reuse if usable("pairwise")
          else PairwiseObjective(traffic, num_cores, mesh_w, torus=torus))
    avg_hop = pw.total(placement) / denom
    tree_hop = None
    if usable("tree"):
        tree_hop = reuse.total(placement) / denom
    elif hyper is not None and part is not None and not torus:
        tree = TreeHopObjective(hyper, part, num_cores, mesh_w, mesh_h)
        tree_hop = tree.total(placement) / denom
    return avg_hop, tree_hop
