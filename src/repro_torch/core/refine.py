"""Uncoarsening + boundary refinement (paper §3.3).

The partitioning of the coarsest graph is projected back level by level.
At every level a refinement pass runs with a single global priority queue:
vertices whose total external degree (ED) is >= their internal degree (ID)
enter the queue with gain = max_b ED[v]_b − ID[v]; the highest-gain vertex
moves to its best partition b (subject to core capacity).  Moves continue
until `x` consecutive moves fail to decrease the objective, at which point
the trailing non-improving moves are undone.

Two objectives share the queue machinery (selected by ``objective``):

* ``"cut"`` — spikes on cut synapses; per-vertex degrees come from one
  ``np.bincount`` over the CSR neighborhood.
* ``"volume"`` — connectivity-(λ−1) communication volume over the graph's
  attached multicast hypergraph; the degree row is ``graph.volume_degrees``
  and the λ-gain of a move is exactly D*[v, target] − D*[v, own] (see
  ``repro.core.graph.volume_degrees``).

As the paper notes, this single-queue / boundary-only scheme has weaker
hill-climbing than full Kernighan–Lin, but is dramatically faster — that
trade is the point of the multilevel paradigm.

This is the *scalar* refinement engine: best quality, O(n) Python
iterations per pass.  ``refine_vec.refine_level_vec`` is the batched
array-parallel alternative for large graphs; ``uncoarsen_vec`` picks
between the two per level (see `repro.core.partition` for the engine
overview).
"""
from __future__ import annotations

import heapq
import itertools

import numpy as np

from repro_torch import spans

from .graph import (
    Graph,
    comm_volume,
    csr_gather,
    edge_cut,
    edge_partition_counts,
    presence_degrees,
)

__all__ = ["refine_level", "project", "uncoarsen", "CutState", "VolumeState"]

# Cap on rows * k entries a batched degree evaluation materializes at once
# (~128 MB of float64); larger batches are swept in row chunks.  Shared
# with the vec refiner.
_MAX_DEG_ENTRIES = 16_000_000


class CutState:
    """Stateless per-vertex (ID, ED) degrees for the edge-cut objective."""

    def __init__(self, graph: Graph, part: np.ndarray, k: int):
        self.graph = graph
        self.k = k
        self.eval_chunk = max(1, _MAX_DEG_ENTRIES // max(k, 1))

    def score(self, part: np.ndarray) -> int:
        return edge_cut(self.graph, part)

    def degrees(self, part: np.ndarray, v: int) -> tuple[int, np.ndarray]:
        nbrs, wgts = self.graph.neighbors(v)
        per_part = np.bincount(part[nbrs], weights=wgts, minlength=self.k)
        own = part[v]
        internal = per_part[own]
        per_part = per_part.copy()
        per_part[own] = 0
        return int(internal), per_part

    def degrees_rows(self, part: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(R, k) degree matrix for a batch of vertices (own column included)."""
        g = self.graph
        eidx, local = csr_gather(g.xadj, rows)
        deg = np.bincount(
            local * self.k + part[g.adjncy[eidx]].astype(np.int64),
            weights=g.adjwgt[eidx],
            minlength=rows.shape[0] * self.k,
        )
        return deg.reshape(rows.shape[0], self.k)

    @staticmethod
    def admissible(internal: int, ext: np.ndarray) -> bool:
        """Paper's boundary filter: total external degree >= internal."""
        s = ext.sum()
        return s >= internal and s > 0

    @staticmethod
    def admissible_rows(internal: np.ndarray, ext: np.ndarray) -> np.ndarray:
        s = ext.sum(axis=1)
        return (s >= internal) & (s > 0)

    def apply_move(self, v: int, src: int, dst: int) -> None:
        pass  # degrees derive from `part` alone

    def touched(self, v: int, src: int, dst: int) -> np.ndarray:
        return self.graph.neighbors(v)[0]


class VolumeState:
    """Incremental λ-gain degrees for the communication-volume objective.

    Maintains the (E, k) member-count table Φ(e, p) across moves so each
    queue operation is a small gather over the vertex's incident hyperedges
    instead of a from-scratch recount: D*[v, b] = Σ_{e ∋ v} hfire[e] ×
    [Φ(e, b) > (b == part[v])], and the exact λ-gain of moving v from a to
    b is D*[v, b] − D*[v, a] (see ``graph.volume_degrees``).
    """

    # Below this n*k the queue churn of full FM exploration is affordable
    # and its hill-climbing (tentative negative-gain moves + undo) matters
    # most; above it, only non-negative-gain vertices enter the queue.
    _EXPLORE_NK = 1 << 14

    def __init__(self, graph: Graph, part: np.ndarray, k: int):
        if graph.hyper is None:
            raise ValueError("objective='volume' requires graph.hyper")
        self.hyper = graph.hyper
        self.k = k
        self.vxadj, self.vedges = self.hyper.incidence()
        self.phi = edge_partition_counts(self.hyper, part, k)
        self.hfire_f = self.hyper.hfire.astype(np.float64)
        self.explore = graph.num_vertices * k <= self._EXPLORE_NK
        # A batch's dense product scales with its incidence degree, not its
        # row count — bound the chunk by the expansion (see presence_degrees).
        avg_inc = ((self.hyper.num_pins + self.hyper.num_hyperedges)
                   / max(graph.num_vertices, 1))
        self.eval_chunk = max(1, int(_MAX_DEG_ENTRIES / (k * max(avg_inc, 1.0))))

    def score(self, part: np.ndarray) -> int:
        return comm_volume(self.hyper, part)

    def _incident(self, v: int) -> np.ndarray:
        return self.vedges[self.vxadj[v]:self.vxadj[v + 1]]

    def degrees(self, part: np.ndarray, v: int) -> tuple[int, np.ndarray]:
        eids = self._incident(v)
        own = int(part[v])
        if eids.shape[0] == 0:
            return 0, np.zeros(self.k)
        sub = self.phi[eids]
        pres = sub > 0
        pres[:, own] = sub[:, own] > 1  # v itself always sits in its own column
        row = self.hfire_f[eids] @ pres
        internal = row[own]
        row[own] = 0
        return int(internal), row

    def degrees_rows(self, part: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(R, k) D* matrix for a batch of vertices from the live Φ table."""
        idx, local = csr_gather(self.vxadj, rows)
        eids = self.vedges[idx]
        counts = (self.vxadj[rows + 1] - self.vxadj[rows]).astype(np.int64)
        return presence_degrees(self.phi[eids], self.hfire_f[eids], counts,
                                local, part[rows], self.k)

    def admissible(self, internal: int, ext: np.ndarray) -> bool:
        """Queue filter.  The cut filter's ED-sum over k−1 presence columns
        almost always exceeds the own column, so it admits every vertex and
        the queue churns.  On small instances (``explore``) any vertex with
        external presence is queued — full FM hill-climbing via tentative
        negative-gain moves, where quality is seed-sensitive; at scale only
        non-negative best λ-gains enter (the undo window still explores
        plateaus via zero-gain moves)."""
        m = ext.max()
        if self.explore:
            return m > 0
        return m > 0 and m >= internal

    def admissible_rows(self, internal: np.ndarray, ext: np.ndarray) -> np.ndarray:
        m = ext.max(axis=1)
        if self.explore:
            return m > 0
        return (m > 0) & (m >= internal)

    def apply_move(self, v: int, src: int, dst: int) -> None:
        eids = self._incident(v)  # unique per vertex, so fancy-index is safe
        self.phi[eids, src] -= 1
        self.phi[eids, dst] += 1

    def apply_moves(self, movers: np.ndarray, srcs: np.ndarray,
                    dsts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batch Φ update for a simultaneous mover set.

        Movers may share hyperedges — the fat conflict rounds admit several
        movers per edge when no presence indicator is at risk — so the same
        (hyperedge, column) slot can receive multiple ±1 updates.  Plain
        fancy indexing would silently drop the duplicates; instead the
        updates are merged per unique flat slot key (``edge * k + column``)
        and applied buffered, which is both exact and faster than the
        unbuffered ``np.add.at`` scatter.

        Returns the updates it applied, for a mirror of Φ to replay: the
        flat slot keys (int64) and their signed counts (int64).  A key may
        appear twice, once as a source and once as a destination slot.
        """
        idx, local = csr_gather(self.vxadj, movers)
        eids = self.vedges[idx]
        flat = self.phi.reshape(-1)
        sk, sc = np.unique(eids * self.k + srcs[local], return_counts=True)
        flat[sk] -= sc.astype(np.int32)
        dk, dc = np.unique(eids * self.k + dsts[local], return_counts=True)
        flat[dk] += dc.astype(np.int32)
        return (np.concatenate([sk, dk]).astype(np.int64),
                np.concatenate([-sc, dc]).astype(np.int64))

    def touched_moves(self, movers: np.ndarray, srcs: np.ndarray,
                      dsts: np.ndarray) -> np.ndarray:
        """Batch form of ``touched`` for a simultaneous mover set.

        Call *after* ``apply_moves``; returns every vertex whose cached D*
        row may have changed, applying the same critical-edge filter (only
        hyperedges where a move crossed a presence threshold invalidate
        their members — see ``touched``).  Valid for fat batches too: the
        fat conflict predicate only admits multiple movers on a slot whose
        post-batch count stays >= 2, so any slot that can cross a presence
        threshold has exactly one mover and the per-move filter is exact;
        multi-mover slots stay at >= 2 members, which the ``<= 1`` /
        ``<= 2`` tests conservatively cover.
        """
        idx, local = csr_gather(self.vxadj, movers)
        eids = self.vedges[idx]
        critical = ((self.phi[eids, srcs[local]] <= 1)
                    | (self.phi[eids, dsts[local]] <= 2))
        eids = eids[critical]
        pidx, _ = csr_gather(self.hyper.hxadj, eids)
        return np.concatenate([self.hyper.hpins[pidx].astype(np.int64),
                               self.hyper.hsrc[eids].astype(np.int64)])

    def touched(self, v: int, src: int, dst: int) -> np.ndarray:
        """Members whose D* rows changed when v moved src→dst.

        Call *after* ``apply_move``.  A co-member's presence term for an
        edge e only flips when the move crossed a threshold: Φ(e, src)
        dropped to 0 or 1 (some member lost its last other-member there) or
        Φ(e, dst) rose to 1 or 2 (some member gained its first).  Edges
        between well-populated partitions are skipped entirely — most of
        them, on plateau-heavy volume landscapes.
        """
        eids = self._incident(v)
        critical = (self.phi[eids, src] <= 1) | (self.phi[eids, dst] <= 2)
        eids = eids[critical]
        pidx, _ = csr_gather(self.hyper.hxadj, eids)
        return np.concatenate([self.hyper.hpins[pidx].astype(np.int64),
                               self.hyper.hsrc[eids].astype(np.int64)])


_STATES = {"cut": CutState, "volume": VolumeState}


def refine_level(
    graph: Graph,
    part: np.ndarray,
    k: int,
    capacity: int,
    max_nonimproving: int = 64,
    max_passes: int = 4,
    objective: str = "cut",
) -> tuple[np.ndarray, int]:
    """Refine `part` in place over up to `max_passes` FM-style passes.

    Returns (part, objective value) — edge cut or communication volume.
    """
    from .graph import partition_weights

    if objective not in _STATES:
        raise ValueError(f"unknown objective {objective!r}")
    part = part.astype(np.int64)
    state = _STATES[objective](graph, part, k)
    pweight = partition_weights(graph, part, k)
    cut = state.score(part)
    counter = itertools.count()

    _NOT_QUEUED = np.iinfo(np.int64).min

    for _ in range(max_passes):
        start_cut = cut
        locked = np.zeros(graph.num_vertices, dtype=bool)
        heap: list[tuple[int, int, int]] = []
        # Latest gain queued per vertex; pops whose entry disagrees are
        # stale and skipped without a degree recount, and re-evaluations
        # that leave the gain unchanged push no duplicate entry.
        queued_gain = np.full(graph.num_vertices, _NOT_QUEUED, dtype=np.int64)

        def push_chunk(rows: np.ndarray) -> None:
            deg = state.degrees_rows(part, rows)
            own = part[rows]
            r = np.arange(rows.shape[0])
            internal = deg[r, own].copy()
            deg[r, own] = 0
            adm = state.admissible_rows(internal, deg)
            targets = np.argmax(deg, axis=1)
            gains = (deg[r, targets] - internal).astype(np.int64)
            queued_gain[rows[~adm]] = _NOT_QUEUED  # invalidate old entries
            fresh = adm & (gains != queued_gain[rows])
            queued_gain[rows[fresh]] = gains[fresh]
            for v, gain in zip(rows[fresh], gains[fresh]):
                heapq.heappush(heap, (-int(gain), next(counter), int(v)))

        def push_many(rows: np.ndarray) -> None:
            """Batch-evaluate candidate rows and queue the admissible ones.

            One (R, k) degree matrix replaces R per-vertex recounts — the
            λ-gain path touches every member of every incident hyperedge,
            so the per-vertex form would dominate refinement time.
            Evaluated in chunks so the dense matrix (and the volume path's
            (incidence, k) product behind it) stays within the memory cap.
            """
            for lo in range(0, rows.shape[0], state.eval_chunk):
                push_chunk(rows[lo:lo + state.eval_chunk])

        push_many(np.arange(graph.num_vertices, dtype=np.int64))

        history: list[tuple[int, int, int]] = []  # (vertex, from, to)
        best_cut = cut
        best_len = 0
        since_best = 0

        while heap and since_best < max_nonimproving:
            neg_gain, _, v = heapq.heappop(heap)
            if locked[v] or queued_gain[v] != -neg_gain:
                continue  # locked, superseded, or invalidated entry
            internal, ext = state.degrees(part, v)
            if not state.admissible(internal, ext):
                queued_gain[v] = _NOT_QUEUED
                continue
            # Re-derive the best target under the capacity constraint.
            order = np.argsort(-ext, kind="stable")
            target = -1
            for b in order:
                if ext[b] <= 0:
                    break
                if pweight[b] + graph.vwgt[v] <= capacity:
                    target = int(b)
                    break
            if target < 0:
                # Invalidate so a later push_many (after capacity frees up)
                # re-queues the same gain instead of deduping it away.
                queued_gain[v] = _NOT_QUEUED
                continue
            gain = int(ext[target]) - internal
            if -neg_gain != gain:
                # Capacity rerouted the target — requeue with the real gain.
                queued_gain[v] = gain
                heapq.heappush(heap, (-gain, next(counter), v))
                continue

            src = int(part[v])
            part[v] = target
            pweight[src] -= graph.vwgt[v]
            pweight[target] += graph.vwgt[v]
            state.apply_move(v, src, target)
            cut -= gain
            locked[v] = True
            history.append((v, src, target))
            if cut < best_cut:
                best_cut = cut
                best_len = len(history)
                since_best = 0
            else:
                since_best += 1
            stale = np.unique(state.touched(v, src, target).astype(np.int64))
            push_many(stale[~locked[stale]])

        # Undo the trailing non-improving moves (paper: "the last x moves are undone").
        for v, src, target in reversed(history[best_len:]):
            part[v] = src
            pweight[src] += graph.vwgt[v]
            pweight[target] -= graph.vwgt[v]
            state.apply_move(v, target, src)
        cut = best_cut

        if cut >= start_cut:
            break
    return part, cut


def project(coarse_part: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    """Project a coarse partition vector onto the finer graph via cmap."""
    return coarse_part[cmap]


def uncoarsen(
    levels: list[Graph],
    coarse_part: np.ndarray,
    k: int,
    capacity: int,
    max_nonimproving: int = 64,
    objective: str = "cut",
) -> tuple[np.ndarray, int]:
    """Walk levels coarse→fine, projecting and refining at each level."""

    def refine(g: Graph, p: np.ndarray, level: int) -> tuple[np.ndarray, int]:
        with spans.span("sneap.partition.refine", level=level,
                        vertices=g.num_vertices, k=k, engine="scalar"):
            return refine_level(g, p, k, capacity, max_nonimproving,
                                objective=objective)

    part, cut = refine(levels[-1], coarse_part, len(levels) - 1)
    for i in range(len(levels) - 2, -1, -1):
        part = project(part, levels[i + 1].cmap)
        part, cut = refine(levels[i], part, i)
    return part, cut
