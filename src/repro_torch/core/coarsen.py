"""Coarsening step of the multilevel partitioning paradigm (paper §3.3).

Heavy-edge matching: vertices are visited in random order; an unmatched
vertex m is folded with the unmatched neighbor n maximizing the weight of
edge (m, n).  Matched pairs become single vertices of the next-coarser
graph; parallel edges merge by summing weights.  Coarsening repeats level
by level until the graph is small or stops shrinking.

Two matching engines share the `match[v] = partner` contract:

* ``heavy_edge_matching`` — the paper's sequential visit-in-random-order
  loop (reference implementation, O(n) Python iterations).
* ``heavy_edge_matching_vec`` — round-based propose–accept matching with
  a random proposer/acceptor role split per round: proposers pick their
  heaviest free acceptor neighbor via one vectorized segment-argmax over
  the CSR arrays, acceptors lock in their heaviest proposer, and the
  disjoint roles keep accepted pairs conflict-free.  A few rounds reach a
  near-maximal matching with no per-vertex Python work (details and the
  tie-breaking rationale on the function itself).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from .graph import Graph, Hypergraph, _mix64, dedup_hyperedges

__all__ = [
    "heavy_edge_matching",
    "heavy_edge_matching_vec",
    "contract",
    "contract_hypergraph",
    "coarsen",
    "LevelStore",
]


def _shard_bounds(n: int, shards) -> np.ndarray | None:
    """Contiguous vertex-block bounds from a shard count or plan.

    Accepts ``None`` (single-host mode), an int shard count, or any object
    with a ``bounds`` attribute (``sharding.planner.VertexShardPlan``); the
    core stays numpy-only by never importing the planner.
    """
    if shards is None:
        return None
    if hasattr(shards, "bounds"):
        return np.asarray(shards.bounds, dtype=np.int64)
    s = max(1, int(shards))
    return (np.arange(s + 1, dtype=np.int64) * n) // s


def heavy_edge_matching(graph: Graph, rng: np.random.Generator) -> np.ndarray:
    """Return match[v] = partner vertex (or v itself if unmatched)."""
    n = graph.num_vertices
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    xadj, adjncy, adjwgt = graph.xadj, graph.adjncy, graph.adjwgt
    for v in order:
        if match[v] != -1:
            continue
        s, e = xadj[v], xadj[v + 1]
        nbrs = adjncy[s:e]
        wgts = adjwgt[s:e]
        free = match[nbrs] == -1
        if free.any():
            cand_n = nbrs[free]
            cand_w = wgts[free]
            u = int(cand_n[np.argmax(cand_w)])
            match[v] = u
            match[u] = v
        else:
            match[v] = v
    return match


_TIE_BITS = 20  # per-edge random tie-break key width


def heavy_edge_matching_vec(
    graph: Graph,
    rng: np.random.Generator | None = None,
    max_vwgt: int | None = None,
    max_rounds: int = 64,
    shards=None,
) -> np.ndarray:
    """Array-parallel heavy-edge matching (same contract as the scalar loop).

    ``shards`` (None, int, or a plan with ``bounds``) selects the sharded
    engine: per-round work proceeds over per-shard *edge-range slices* of
    the CSR arrays (rows are contiguous, so a vertex block's edges are one
    zero-copy slice), proposals commit into global (n,)-sized arrays, and
    acceptance runs once globally — the halo exchange is implicit in the
    free/proposer lookups at boundary neighbors.  Peak per-shard memory is
    O(block edges), not O(m).  Tie keys come from a splitmix64 hash of the
    *global* edge index (not per-call rng draws), so the matching is
    invariant under the shard count: ``shards=1`` and ``shards=8`` produce
    bitwise-identical matchings.  ``shards=None`` keeps the original
    rng-tie path (and its recorded benchmark results) byte-for-byte.

    Propose-accept rounds with a random role split: each round every free
    vertex is coin-flipped into proposer or acceptor; proposers pick their
    heaviest free acceptor neighbor via one segment-argmax over the CSR
    arrays, and each acceptor locks in its heaviest proposer.  Because the
    two roles are disjoint, accepted pairs never conflict — no sequential
    tie-breaking is needed and the whole round is whole-array numpy.

    Weight ties break by fresh per-edge random keys each round.  That
    matters: profiled SNN graphs carry many equal spike counts, and any
    deterministic tie-break points whole neighborhoods at one vertex, so a
    round locks in O(1) pairs instead of O(n) (dense equal-weight layers
    degrade worst — mutual-proposal matching stalls outright there).

    Each round runs a "second chance" pass: proposers that lost the
    acceptance step (their target locked in a heavier proposer) re-propose
    to their best *still unmatched* acceptor neighbor under the same role
    split.  That recovers most of the matched-weight gap vs. the sequential
    loop, which never wastes a visit on an already-taken neighbor.

    ``max_vwgt`` filters candidate edges up front so merged vertices never
    exceed the cap.
    """
    bounds = _shard_bounds(graph.num_vertices, shards)
    if bounds is not None:
        return _matching_vec_sharded(graph, rng, max_vwgt, max_rounds, bounds)
    n = graph.num_vertices
    match = np.full(n, -1, dtype=np.int64)
    xadj, adjncy, adjwgt, vwgt = graph.xadj, graph.adjncy, graph.adjwgt, graph.vwgt
    m = adjncy.shape[0]
    if m:
        if rng is None:
            rng = np.random.default_rng(0)
        # Both int64 packings must fit: the (weight << tie) proposal key and
        # the (weight * n + vertex) acceptance key.
        if int(adjwgt.max()) >= min(1 << (62 - _TIE_BITS), (1 << 62) // max(n, 1)):
            raise OverflowError("edge weights too large for the packed match keys")
        src = graph.edge_src
        nbr = adjncy.astype(np.int64)
        nonempty = xadj[:-1] < xadj[1:]
        starts = xadj[:-1][nonempty]
        cap_ok = True
        if max_vwgt is not None:
            cap_ok = (vwgt[src] + vwgt[nbr]) <= max_vwgt
        for _ in range(max_rounds):
            free = match == -1
            if not (free[src] & free[nbr] & cap_ok).any():
                break
            proposer = rng.random(n) < 0.5
            # Two passes per round: the second gives proposers that lost the
            # acceptance step a chance to re-propose to a still-free acceptor.
            for _pass in range(2):
                free = match == -1
                ok = free[src] & free[nbr] & cap_ok & proposer[src] & ~proposer[nbr]
                if not ok.any():
                    break  # unlucky coin flips or round exhausted
                # Lexicographic (weight, random tie) as one int64 key; CSR rows
                # are contiguous, so one reduceat over non-empty rows is the
                # whole segment-max.
                key = np.where(
                    ok,
                    (adjwgt << _TIE_BITS) + rng.integers(0, 1 << _TIE_BITS, m),
                    -1,
                )
                rowmax = np.full(n, -1, dtype=np.int64)
                rowmax[nonempty] = np.maximum.reduceat(key, starts)
                hit = ok & (key == rowmax[src])
                proposal = np.full(n, n, dtype=np.int64)
                np.minimum.at(proposal, src[hit], nbr[hit])
                prop_from = np.nonzero(proposal < n)[0]
                # Acceptance: each target keeps its heaviest proposer; the
                # (weight, proposer-id) key makes the winner recoverable as
                # key % n.
                pw = rowmax[prop_from] >> _TIE_BITS
                acc = np.full(n, -1, dtype=np.int64)
                np.maximum.at(acc, proposal[prop_from], pw * n + prop_from)
                targets = np.nonzero(acc >= 0)[0]
                winners = acc[targets] % n
                match[targets] = winners
                match[winners] = targets
    unmatched = match == -1
    match[unmatched] = np.nonzero(unmatched)[0]
    return match


def _matching_vec_sharded(
    graph: Graph,
    rng: np.random.Generator | None,
    max_vwgt: int | None,
    max_rounds: int,
    bounds: np.ndarray,
) -> np.ndarray:
    """Sharded propose–accept matching (see ``heavy_edge_matching_vec``).

    Per pass, each shard scans only its own edge slice and commits local
    proposals; the single global acceptance step then resolves every
    cross-shard collision at once.  All randomness is shard-count
    independent: proposer coin flips are one global ``rng.random(n)`` per
    round, and tie keys hash the global edge index with one per-pass seed.
    """
    n = graph.num_vertices
    match = np.full(n, -1, dtype=np.int64)
    xadj, adjncy, adjwgt, vwgt = graph.xadj, graph.adjncy, graph.adjwgt, graph.vwgt
    if adjncy.shape[0] == 0:
        match[:] = np.arange(n)
        return match
    if rng is None:
        rng = np.random.default_rng(0)
    if int(adjwgt.max()) >= min(1 << (62 - _TIE_BITS), (1 << 62) // max(n, 1)):
        raise OverflowError("edge weights too large for the packed match keys")
    nshards = bounds.shape[0] - 1
    tie_mask = np.uint64((1 << _TIE_BITS) - 1)

    def shard_slices(s: int):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        return lo, hi, int(xadj[lo]), int(xadj[hi])

    for _ in range(max_rounds):
        free = match == -1
        alive = False
        for s in range(nshards):
            lo, hi, e0, e1 = shard_slices(s)
            if e0 == e1:
                continue
            deg = np.diff(xadj[lo:hi + 1])
            nbr_s = adjncy[e0:e1]
            ok = np.repeat(free[lo:hi], deg) & free[nbr_s]
            if max_vwgt is not None:
                ok &= (np.repeat(vwgt[lo:hi], deg) + vwgt[nbr_s]) <= max_vwgt
            if ok.any():
                alive = True
                break
        if not alive:
            break
        proposer = rng.random(n) < 0.5
        # Two passes per round, like the single-host engine: the second
        # lets proposers that lost acceptance re-propose to a still-free
        # acceptor.
        for _pass in range(2):
            tie_seed = np.uint64(int(rng.integers(1 << 62)))
            free = match == -1
            proposal = np.full(n, n, dtype=np.int64)
            best_w = np.zeros(n, dtype=np.int64)
            for s in range(nshards):
                lo, hi, e0, e1 = shard_slices(s)
                if e0 == e1:
                    continue
                deg = np.diff(xadj[lo:hi + 1])
                nbr_s = adjncy[e0:e1].astype(np.int64)
                loc_src = np.repeat(np.arange(hi - lo), deg)
                ok = (np.repeat(free[lo:hi] & proposer[lo:hi], deg)
                      & free[nbr_s] & ~proposer[nbr_s])
                if max_vwgt is not None:
                    ok &= (np.repeat(vwgt[lo:hi], deg) + vwgt[nbr_s]) <= max_vwgt
                if not ok.any():
                    continue
                tie = (_mix64(np.arange(e0, e1, dtype=np.uint64), tie_seed)
                       & tie_mask).astype(np.int64)
                key = np.where(ok, (adjwgt[e0:e1] << _TIE_BITS) + tie, -1)
                nonempty = deg > 0
                rowmax = np.full(hi - lo, -1, dtype=np.int64)
                rowmax[nonempty] = np.maximum.reduceat(
                    key, (xadj[lo:hi] - e0)[nonempty])
                hit = ok & (key == rowmax[loc_src])
                np.minimum.at(proposal, loc_src[hit] + lo, nbr_s[hit])
                best_w[lo:hi] = np.where(rowmax >= 0, rowmax >> _TIE_BITS, 0)
            prop_from = np.nonzero(proposal < n)[0]
            if prop_from.shape[0] == 0:
                break
            acc = np.full(n, -1, dtype=np.int64)
            np.maximum.at(acc, proposal[prop_from],
                          best_w[prop_from] * n + prop_from)
            targets = np.nonzero(acc >= 0)[0]
            winners = acc[targets] % n
            match[targets] = winners
            match[winners] = targets
    unmatched = match == -1
    match[unmatched] = np.nonzero(unmatched)[0]
    return match


def contract_hypergraph(hyper: Hypergraph, cmap: np.ndarray, nc: int) -> Hypergraph:
    """Contract hyperedges through a fine→coarse vertex map.

    Pins remap through ``cmap`` and merge within each hyperedge (weights
    summed); pins that collapse into their own source are dropped (their
    deliveries became core-local), as are hyperedges left with no pins.
    Because a partition of the coarse graph induces the same member
    partition sets, ``comm_volume`` is preserved exactly under projection —
    which is what makes λ-gains exact at every level of refinement.

    Hyperedges whose (source, pin set) became identical under the remap are
    merged by ``graph.dedup_hyperedges`` (hfire and per-pin hwgt summed) —
    also volume-preserving, since identical member sets span identical
    partition sets.  On structured SNNs (dense layers) most hyperedges
    collapse this way after a few levels, shrinking the Φ table and every
    λ-gain evaluation during refinement.
    """
    hsrc = cmap[hyper.hsrc.astype(np.int64)]
    pins = cmap[hyper.hpins.astype(np.int64)]
    pe = hyper.pin_edge
    keep = pins != hsrc[pe]
    pe, pins, wgt = pe[keep], pins[keep], hyper.hwgt[keep]

    # Merge duplicate pins within each hyperedge (np.unique sorts the packed
    # key, so merged pins come out grouped by hyperedge — CSR-ready).
    key = pe * nc + pins
    order = np.argsort(key, kind="stable")
    key, wgt = key[order], wgt[order]
    uniq, start = np.unique(key, return_index=True)
    merged_w = np.add.reduceat(wgt, start) if len(key) else wgt
    mpe = uniq // nc
    mpins = uniq % nc

    # Compact away empty hyperedges.
    ne = hyper.num_hyperedges
    counts = np.bincount(mpe, minlength=ne)
    nonempty = counts > 0
    hxadj = np.concatenate([[0], np.cumsum(counts[nonempty])]).astype(np.int64)
    return dedup_hyperedges(Hypergraph(
        hxadj=hxadj,
        hpins=mpins.astype(np.int32),
        hwgt=merged_w.astype(np.int64),
        hsrc=hsrc[nonempty].astype(np.int32),
        hfire=hyper.hfire[nonempty],
        num_vertices=nc,
    ))


def contract(graph: Graph, match: np.ndarray, contract_hyper: bool = True) -> Graph:
    """Contract matched pairs into the next-coarser graph.

    Returns a Graph whose ``cmap`` maps fine vertices -> coarse vertices;
    an attached ``hyper`` view is contracted alongside unless
    ``contract_hyper=False`` (the edge-cut objective never reads coarse
    hypergraphs, so cut-path callers skip the per-level pin merge).
    """
    n = graph.num_vertices
    # Assign coarse ids: the lower-numbered endpoint of each pair owns the id.
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = uniq.shape[0]

    cvwgt = np.zeros(nc, dtype=np.int64)
    np.add.at(cvwgt, cmap, graph.vwgt)

    src = graph.edge_src
    csrc = cmap[src]
    cdst = cmap[graph.adjncy]
    keep = csrc != cdst  # internal (matched) edges disappear
    csrc, cdst, cw = csrc[keep], cdst[keep], graph.adjwgt[keep]

    # Merge parallel edges (both directions are present symmetrically).
    key = csrc.astype(np.int64) * nc + cdst
    order = np.argsort(key, kind="stable")
    key, csrc, cdst, cw = key[order], csrc[order], cdst[order], cw[order]
    uniq_key, start = np.unique(key, return_index=True)
    merged_w = np.add.reduceat(cw, start) if len(key) else cw
    msrc = (uniq_key // nc).astype(np.int64)
    mdst = (uniq_key % nc).astype(np.int64)

    xadj = np.zeros(nc + 1, dtype=np.int64)
    np.add.at(xadj, msrc + 1, 1)
    xadj = np.cumsum(xadj)
    return Graph(
        xadj=xadj,
        adjncy=mdst.astype(np.int32),
        adjwgt=merged_w.astype(np.int64),
        vwgt=cvwgt,
        cmap=cmap,
        hyper=(contract_hypergraph(graph.hyper, cmap, nc)
               if contract_hyper and graph.hyper is not None else None),
    )


def coarsen(
    graph: Graph,
    rng: np.random.Generator,
    coarsen_to: int = 128,
    max_vwgt: int | None = None,
    shrink_floor: float = 0.95,
    max_levels: int = 40,
    impl: str = "scalar",
    contract_hyper: bool = True,
    shards=None,
    store: "LevelStore | None" = None,
):
    """Coarsen level by level; returns [G_0, G_1, ..., G_c] (fine -> coarse).

    Stops when the graph has <= ``coarsen_to`` vertices, stops shrinking
    (|G_{i+1}| > shrink_floor * |G_i|), or ``max_levels`` is hit.
    ``max_vwgt`` bounds the merged vertex weight so that coarse vertices
    stay placeable within a core's neuron capacity.  ``impl`` selects the
    matching engine: ``"scalar"`` (sequential reference) or ``"vec"``
    (round-based array-parallel matching).  ``contract_hyper=False`` skips
    the per-level hypergraph contraction (see ``contract``).

    ``shards`` threads through to ``heavy_edge_matching_vec`` (vec impl
    only; the scalar reference loop ignores it).  ``store`` selects
    out-of-core streaming: each level is appended to the ``LevelStore``
    (spilled to disk) as soon as it is contracted, and only the current
    level stays resident — the returned object is the store itself, which
    ``uncoarsen_vec`` walks one index at a time.  With ``store=None`` the
    in-memory list of levels is returned as before.
    """
    if impl not in ("scalar", "vec"):
        raise ValueError(f"unknown coarsening impl {impl!r}")
    out = store if store is not None else []
    out.append(graph)
    prev = graph
    for _ in range(max_levels):
        g = prev
        if g.num_vertices <= coarsen_to or g.num_edges == 0:
            break
        if impl == "vec":
            match = heavy_edge_matching_vec(g, rng, max_vwgt=max_vwgt,
                                            shards=shards)
        else:
            match = heavy_edge_matching(g, rng)
        if max_vwgt is not None:
            # Undo matches whose merged weight would exceed the cap.
            v = np.arange(g.num_vertices)
            over = (g.vwgt + g.vwgt[match]) > max_vwgt
            bad = over & (match != v)
            match = match.copy()
            match[bad] = v[bad]
            partner_bad = bad[match]
            match[partner_bad] = v[partner_bad]
        coarse = contract(g, match, contract_hyper=contract_hyper)
        if coarse.num_vertices > shrink_floor * g.num_vertices:
            break
        out.append(coarse)
        prev = coarse
    return out


class LevelStore:
    """Disk-backed sequence of level graphs for out-of-core uncoarsening.

    ``append`` spills a level (Graph plus any attached Hypergraph) to one
    ``.npz`` file and drops the reference; ``__getitem__`` reloads on
    demand through a two-entry cache.  That is exactly the access pattern
    of ``uncoarsen_vec``'s coarse→fine walk — ``levels[i + 1].cmap`` then
    ``levels[i]`` — so a full multilevel hierarchy never holds more than
    two levels resident, regardless of depth.  Supports ``len`` and
    negative indices like the plain list ``coarsen`` builds in memory.
    """

    _CACHE_SLOTS = 2

    def __init__(self, directory: str | None = None):
        self._own = directory is None
        self._dir = (tempfile.mkdtemp(prefix="sneap_levels_")
                     if directory is None else str(directory))
        os.makedirs(self._dir, exist_ok=True)
        self._count = 0
        self._cache: dict[int, Graph] = {}

    def __len__(self) -> int:
        return self._count

    def _path(self, i: int) -> str:
        return os.path.join(self._dir, f"level_{i:04d}.npz")

    def append(self, g: Graph) -> None:
        arrays = {"xadj": g.xadj, "adjncy": g.adjncy, "adjwgt": g.adjwgt,
                  "vwgt": g.vwgt}
        if g.cmap is not None:
            arrays["cmap"] = g.cmap
        if g.hyper is not None:
            h = g.hyper
            arrays.update(hxadj=h.hxadj, hpins=h.hpins, hwgt=h.hwgt,
                          hsrc=h.hsrc, hfire=h.hfire,
                          hyper_nv=np.int64(h.num_vertices))
        np.savez(self._path(self._count), **arrays)
        self._count += 1

    def __getitem__(self, i: int) -> Graph:
        if i < 0:
            i += self._count
        if not 0 <= i < self._count:
            raise IndexError(f"level {i} of {self._count}")
        if i in self._cache:
            return self._cache[i]
        with np.load(self._path(i)) as z:
            hyper = None
            if "hxadj" in z:
                hyper = Hypergraph(hxadj=z["hxadj"], hpins=z["hpins"],
                                   hwgt=z["hwgt"], hsrc=z["hsrc"],
                                   hfire=z["hfire"],
                                   num_vertices=int(z["hyper_nv"]))
            g = Graph(xadj=z["xadj"], adjncy=z["adjncy"], adjwgt=z["adjwgt"],
                      vwgt=z["vwgt"],
                      cmap=z["cmap"] if "cmap" in z else None,
                      hyper=hyper)
        while len(self._cache) >= self._CACHE_SLOTS:
            self._cache.pop(next(iter(self._cache)))
        self._cache[i] = g
        return g

    def close(self) -> None:
        """Drop the cache and, for store-owned temp dirs, the spill files."""
        self._cache.clear()
        if not self._own:
            return
        for i in range(self._count):
            try:
                os.remove(self._path(i))
            except OSError:
                pass
        try:
            os.rmdir(self._dir)
        except OSError:
            pass
