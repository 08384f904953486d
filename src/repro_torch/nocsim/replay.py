"""Batched two-tier queued NoC replay (the fast path behind ``simulate_noc``).

The scalar reference engine (`sim._queued_ref`) replays one SNN time-step
window at a time with a Python ``while`` loop and several lexsorts per NoC
cycle.  This module replaces it with a two-tier engine built on the one
structural fact XY routing gives us for free: routes are static, so the
*unobstructed* schedule of every packet — which link it wants at which
cycle — is known up front.

Tier 1 (contention screens, no cycle stepping):
  * Overloaded pairs.  An XY route crosses a directed link at most once,
    so a (window, link) pair's per-cycle demand is bounded by its
    whole-window load no matter how blocked packets repeat requests.
    Pairs at or under ``link_capacity`` can therefore never block, and a
    packet whose route avoids every overloaded pair is exact
    analytically: latency = injection stagger + hops.  Loads come from a
    ``bincount`` over the vectorized route expansion, or — with
    ``screen="linkload"`` — from the ``kernels/link_load`` route histogram
    on the run's device via ``window_link_loads`` (per-window
    core-to-core traffic matrices), in which case routes are only expanded
    for windows that have an overloaded pair at all.
  * Static schedule screen.  Packet ``p`` crosses the ``j``-th link of its
    route at cycle ``inject(p) + j`` when nothing blocks; a window where
    no (cycle, link) bucket exceeds ``link_capacity`` under that schedule
    is self-consistent and contention-free even though some pair is
    overloaded in total (injection stagger diffuses it).  Those windows
    are scored analytically too.

Tier 2 (joint congested stepping): the surviving packets of all contending
windows are simulated in *one* vectorized cycle loop.  Packets from
different windows cannot interact, so links are tagged with a compact
window offset and arbitration runs across the concatenated packet set —
one numpy pass per cycle over every congested window instead of a Python
loop per window.  The loop keeps per-cycle work at a handful of O(active)
passes: packets are pre-sorted by the static arbitration priority (active
set = a row prefix, grants = one stable argsort over oversubscribed links
only), remaining (window, link) loads are maintained incrementally so a
window whose last overloaded pair drains finishes analytically mid-flight,
and windows that stay block-free for `_RESCREEN_EVERY` cycles are
re-screened against their remaining forward schedule and finished once it
fits capacity.

Every tier reproduces the reference engine's arbitration (per-link grants
to the ``link_capacity`` oldest-injected packets, stable order) exactly,
so unicast stats are bit-identical to ``_queued_ref``.

Multicast replays use true tree-fork flits (`queued_multicast_tree`): a
firing injects *one* flit that forks at branch routers — state is one
entity per (firing, tree link), each tree link is traversed once, and a
child link becomes ready the cycle after its parent is granted.  This
replaces the replica-based upper bound (ROADMAP item 2): latency and
congestion are those of a real multicast router, and the engine simulates
``tree links`` flit-hops instead of ``sum of replica routes`` — the
faithful model is also the faster one.  Link loads and dynamic energy keep
the exact tree accounting both engines already shared.

The reference's optional device stepper (``stepper="jax"``) is not ported
yet (ROADMAP queue 1, item 6); the numpy stepper is the only one.
"""
from __future__ import annotations

import numpy as np
import torch

from .energy import EnergyModel
from .stats import NoCStats, edge_stats
from .xy import (
    link_count,
    link_endpoints,
    link_ids_for_routes,
    multicast_tree_links,
    route_hops,
)

__all__ = ["queued_unicast", "queued_multicast_tree"]

_INF = np.iinfo(np.int64).max // 4
# Attempt the exact (cycle, link) schedule screen at a blocking-free cycle
# at most every this many cycles (it re-expands remaining routes; cheap but
# not per-cycle cheap — the load-based over_cnt exit is the per-cycle one).
_RESCREEN_EVERY = 8
# Saturation detector (see queued_unicast): windows whose peak link load
# provably exceeds what any schedule could grant (load > capacity x the
# unobstructed cycle span — pigeonhole) are marked congested outright and
# bypass the static schedule screen; the screen's (window, cycle, link)
# sort runs only over the remaining screenable windows.  On saturated
# traces it admits (almost) nothing, so classifying those windows by the
# O(traversals) load bound instead closes the `saturated_unicast` speed
# gap without giving up the screen's pruning on merely-bursty traces.
# Results are unchanged either way: the detector only decides *who* is
# stepped, and the stepper reproduces the reference arbitration exactly.


# --------------------------------------------------------------- shared


def _window_ids(t: np.ndarray) -> tuple[np.ndarray, int]:
    """Compact window id per record of a t-sorted trace."""
    if t.shape[0] == 0:
        return np.empty(0, dtype=np.int64), 0
    new = np.empty(t.shape[0], dtype=bool)
    new[0] = True
    np.not_equal(t[1:], t[:-1], out=new[1:])
    win = np.cumsum(new) - 1
    return win, int(win[-1]) + 1


def _group_ranks(key: np.ndarray) -> np.ndarray:
    """Stable 0-based rank of each element within its key group."""
    n = key.shape[0]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    new = np.empty(n, dtype=bool)
    new[0] = True
    np.not_equal(sk[1:], sk[:-1], out=new[1:])
    start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - start
    return rank


def _inject_cycles(win: np.ndarray, src: np.ndarray, ncores: int,
                   inject_capacity: int) -> np.ndarray:
    """Crossbar egress stagger: the r-th injection from a core this window
    enters the NoC at cycle r // inject_capacity (reference semantics)."""
    return _group_ranks(win * np.int64(ncores) + src) // inject_capacity


def _capacity_grants(sorted_keys: np.ndarray, link_capacity: int) -> np.ndarray:
    """Grant mask over a key-sorted request array: True for the first
    ``link_capacity`` requests of each key group (the shared arbitration
    rule of both steppers — callers sort so that within a group the oldest
    requests come first)."""
    m = sorted_keys.shape[0]
    new = np.empty(m, dtype=bool)
    new[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=new[1:])
    start = np.maximum.accumulate(np.where(new, np.arange(m), 0))
    return (np.arange(m) - start) < link_capacity


def _hot_pairs(
    wl_key: np.ndarray,
    n_win: int,
    nl: int,
    link_capacity: int,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Overloaded (window * nl + link) keys from per-traversal keys.

    Returns (sorted hot keys, dense per-key counts or None).  Only links
    whose *whole-window* load exceeds capacity can ever block: an XY route
    crosses a directed link at most once, so a link's per-cycle demand is
    bounded by its distinct-packet total no matter how requests repeat.
    """
    space = n_win * nl
    if space <= _DENSE_SCREEN_SPACE:
        counts = np.bincount(wl_key, minlength=space)
        return np.flatnonzero(counts > link_capacity), counts
    keys, counts = np.unique(wl_key, return_counts=True)
    return keys[counts > link_capacity], None


def _member(sorted_keys: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Boolean membership of ``query`` values in a sorted key array."""
    if sorted_keys.shape[0] == 0:
        return np.zeros(query.shape[0], dtype=bool)
    pos = np.minimum(np.searchsorted(sorted_keys, query),
                     sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == query


def _window_loads_linkload(
    win: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    n_win: int,
    w: int,
    h: int,
    device: torch.device,
) -> np.ndarray:
    """Per-window (n_win, nl) link loads via the kernels/link_load machinery.

    Builds per-window core-to-core traffic matrices on the host and runs
    the link-load route histogram batched over windows on ``device`` — the
    device alternative to histogramming the route expansion.  For multicast this
    is fed replica packets, whose pairwise loads upper-bound the tree
    loads — a sound (if looser) overload screen.
    """
    from repro_torch.kernels.link_load import window_link_loads

    k = w * h
    nl = link_count(w, h)
    out = np.empty((n_win, nl), dtype=np.int64)
    # Chunk windows so the host-side (B, K, K) histogram stays bounded.
    step = max(1, (1 << 24) // (k * k))
    for lo in range(0, n_win, step):
        m = (win >= lo) & (win < lo + step)
        b = min(step, n_win - lo)
        key = ((win[m] - lo) * k + src_core[m]) * k + dst_core[m]
        counts = np.bincount(key, minlength=b * k * k).reshape(b, k, k)
        out[lo:lo + b] = window_link_loads(counts, w, h, device=device)
    return out


# Below this (window * cycle * link) key-space size the demand screen uses a
# dense bincount (O(n + space)); above it, a sort-based unique.
_DENSE_SCREEN_SPACE = 1 << 26


def _schedule_congested(
    sched_win: np.ndarray,
    sched_cycle: np.ndarray,
    sched_link: np.ndarray,
    nl: int,
    link_capacity: int,
) -> np.ndarray:
    """Window ids whose unobstructed (cycle, link) demand exceeds capacity."""
    if sched_win.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    span = int(sched_cycle.max()) + 1
    space = (int(sched_win.max()) + 1) * span * nl
    if space >= _INF:
        raise OverflowError("window/cycle/link key space too large to pack")
    key = (sched_win * span + sched_cycle) * nl + sched_link
    if space <= _DENSE_SCREEN_SPACE:
        counts = np.bincount(key, minlength=space)
        return np.unique(np.flatnonzero(counts > link_capacity) // (span * nl))
    keys, counts = np.unique(key, return_counts=True)
    return np.unique(keys[counts > link_capacity] // (span * nl))


def _per_window_max(values: np.ndarray, win: np.ndarray, n_win: int) -> np.ndarray:
    out = np.zeros(n_win, dtype=np.int64)
    np.maximum.at(out, win, values)
    return out


# ------------------------------------------------------------- unicast


def queued_unicast(
    trace_t: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    w: int,
    h: int,
    link_capacity: int,
    inject_capacity: int,
    energy: EnergyModel,
    n_local: int,
    max_cycles_per_window: int = 100_000,
    stepper: str = "numpy",
    screen: str = "numpy",
    order: np.ndarray | None = None,
    device: "torch.device | str" = "cuda",
) -> NoCStats:
    """Batched unicast queued replay; bit-identical to ``sim._queued_ref``.

    Inputs are the NoC-bound (remote) records only, t-sorted; ``n_local``
    carries the core-local delivery count for energy accounting.
    ``order`` flags records routed YX (fault-escape detours; numpy screen
    and stepper only) — ``None`` is the pure XY replay.  ``device`` is
    where ``screen="linkload"`` computes the window loads.
    """
    if stepper != "numpy":
        raise NotImplementedError(
            f"stepper={stepper!r} is not ported yet (ROADMAP queue 1, item 6: "
            "device stepper); use stepper='numpy'")
    nl = link_count(w, h)
    ncores = w * h
    n = int(trace_t.shape[0])
    if n == 0:
        return _stats(np.empty(0, np.int64), 0, 0, np.zeros(nl, np.int64),
                      np.zeros(nl, np.int64), 0, n_local, energy, "unicast", 0)
    if order is not None and screen == "linkload":
        raise ValueError("fault-escape routes require numpy stepper/screen")
    win, n_win = _window_ids(trace_t)
    inject = _inject_cycles(win, src_core, ncores, inject_capacity)
    hops = route_hops(src_core, dst_core, w)
    total_hops = int(hops.sum())

    # Tier 1: whole-window (window, link) loads -> overloaded pairs.  Only
    # packets whose route crosses an overloaded pair can ever be blocked
    # (or delay anything), so everything else is scored analytically.
    sids = spkt = sstep = None
    if screen == "linkload":
        # Device path: per-window load maps via the link_load kernel; the
        # route expansion is only materialized for dirty windows.
        loads = _window_loads_linkload(win, src_core, dst_core, n_win, w, h,
                                       device)
        per_link = loads.sum(axis=0)
        hot_keys = np.flatnonzero(loads.ravel() > link_capacity)
        stepped = np.zeros(n, dtype=bool)
        if hot_keys.shape[0]:
            dirty = np.zeros(n_win, dtype=bool)
            dirty[hot_keys // nl] = True
            sel = np.flatnonzero(dirty[win])
            ids, pkt = link_ids_for_routes(src_core[sel], dst_core[sel], w, h)
            pm = _member(hot_keys, win[sel[pkt]] * np.int64(nl) + ids)
            stepped[sel[np.unique(pkt[pm])]] = True
    else:
        # One route expansion serves both tiers: the (window, link) load
        # screen below and — via boolean masking that preserves the exact
        # h-runs-then-v-runs traversal order a subset re-expansion would
        # produce — the stepped packets' link/step arrays.  On saturated
        # traces (stepped ~= everything) this halves the expansion work,
        # the dominant cold-start cost of the batched engine.
        ids, pkt, steps = link_ids_for_routes(src_core, dst_core, w, h,
                                              order=order, with_steps=True)
        per_link = np.bincount(ids, minlength=nl)
        wl_key = win[pkt] * np.int64(nl) + ids
        hot_keys, counts = _hot_pairs(wl_key, n_win, nl, link_capacity)
        stepped = np.zeros(n, dtype=bool)
        if hot_keys.shape[0]:
            pm = (counts[wl_key] > link_capacity if counts is not None
                  else _member(hot_keys, wl_key))
            stepped[pkt[pm]] = True
            if stepped.any():
                tm = stepped[pkt]
                sids, sstep = ids[tm], steps[tm]
                spkt = (np.cumsum(stepped) - 1)[pkt[tm]]
    lat = inject + hops  # analytic fast path (exact off overloaded pairs)
    congestion = 0
    if stepped.any():
        sidx = np.flatnonzero(stepped)
        if sids is None:  # device screen materialized only dirty windows
            sids, spkt, sstep = link_ids_for_routes(
                src_core[sidx], dst_core[sidx], w, h, with_steps=True,
                order=order[sidx] if order is not None else None)
        # Static schedule screen: windows whose stepped packets never
        # oversubscribe any (cycle, link) bucket under the unobstructed
        # schedule (inject + step) cannot block — their overload is
        # diffused by injection stagger.  Keep only truly contending ones.
        # Saturation detector: a window whose peak link load exceeds
        # capacity x its unobstructed cycle span is congested by
        # pigeonhole — no schedule can grant that demand — so it skips
        # the screen's (window, cycle, link) sort; on fully saturated
        # traces that empties the screen entirely (the old
        # `saturated_unicast` 0.8x gap), while merely-bursty windows
        # still get screened (where the pruning pays for itself).
        uwin0 = np.unique(win[sidx])
        cwin0 = np.searchsorted(uwin0, win[sidx])
        nw0 = uwin0.shape[0]
        cw_t = cwin0[spkt]
        sched = inject[sidx[spkt]] + sstep
        span_w = np.zeros(nw0, dtype=np.int64)
        np.maximum.at(span_w, cw_t, sched)
        span_w += 1
        lkey = cw_t * np.int64(nl) + sids
        if nw0 * nl <= _DENSE_SCREEN_SPACE:
            loadmax_w = np.bincount(
                lkey, minlength=nw0 * nl).reshape(nw0, nl).max(axis=1)
        else:
            loadmax_w = np.zeros(nw0, dtype=np.int64)
            uk, uc = np.unique(lkey, return_counts=True)
            np.maximum.at(loadmax_w, uk // nl, uc)
        hopeless = loadmax_w > link_capacity * span_w
        if hopeless.all():
            bad = np.arange(nw0, dtype=np.int64)
        else:
            sub = ~hopeless[cw_t]
            bad = _schedule_congested(cw_t[sub], sched[sub], sids[sub],
                                      nl, link_capacity)
            bad = np.union1d(np.flatnonzero(hopeless), bad)
        if bad.shape[0] < nw0:
            keep_w = np.zeros(nw0, dtype=bool)
            keep_w[bad] = True
            keep_p = keep_w[cwin0]
            keep_t = keep_p[spkt]
            remap = np.cumsum(keep_p) - 1
            sids, sstep = sids[keep_t], sstep[keep_t]
            spkt = remap[spkt[keep_t]]
            sidx = sidx[keep_p]
        if sidx.shape[0]:
            uwin = np.unique(win[sidx])
            cwin = np.searchsorted(uwin, win[sidx])
            lat_s, congestion = _joint_stepper(
                sids, spkt, sstep, hops[sidx], inject[sidx], cwin,
                nl, link_capacity, max_cycles_per_window)
            lat[sidx] = lat_s

    cycles_total = int(_per_window_max(lat, win, n_win).sum())
    return _stats(lat, total_hops, congestion, per_link, per_link,
                  cycles_total, n_local, energy, "unicast", n)


def _joint_stepper(
    ids: np.ndarray,
    pkt: np.ndarray,
    step: np.ndarray,
    hops: np.ndarray,
    inject: np.ndarray,
    win: np.ndarray,
    nl: int,
    link_capacity: int,
    max_cycles: int,
) -> tuple[np.ndarray, int]:
    """Step all congested windows jointly; returns (latencies, blocked count).

    Takes the packets of the congested windows as a pre-expanded route set
    ((ids, pkt, step) traversals with ``pkt`` compact) so no XY geometry is
    recomputed while stepping.  ``win`` must be compact (0..c-1) so
    (window, link) tags stay bincountable.

    Reproduces the reference per-window arbitration exactly: a packet is
    active once injected, requests its next route link each cycle, and
    each link grants its ``link_capacity`` oldest-injected packets (stable
    by record order).  Three structural accelerations keep every cycle a
    handful of O(active) passes:

      * packets are pre-sorted by (inject, record order) — the static
        arbitration priority — so the active set is always a row prefix
        (one ``searchsorted``) and per-link grants need a single stable
        argsort over oversubscribed links only;
      * uncontended links (demand <= capacity) grant without sorting;
      * whenever a cycle blocks nothing the remaining forward schedule is
        re-screened, and the whole tail is finished analytically once it
        fits capacity.

    Packets are compacted away as they arrive.
    """
    n = hops.shape[0]
    n_cwin = int(win.max()) + 1 if n else 0
    # Static priority order (ascending inject, stable by record order).
    prio = np.argsort(inject, kind="stable")
    inject, win, hops = inject[prio], win[prio], hops[prio]
    newpos = np.empty(n, dtype=np.int64)
    newpos[prio] = np.arange(n)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(hops, out=off[1:])
    seq = np.empty(ids.shape[0], dtype=np.int64)  # links in traversal order
    seq[off[newpos[pkt]] + step] = ids
    wtag = np.repeat(win * np.int64(nl), hops)  # window tag per traversal
    space = n_cwin * nl
    # Remaining (window, link) loads of unfinished traversals and the
    # per-window count of still-overloaded pairs, both maintained
    # incrementally: a window whose last pair drains to <= capacity can
    # never block again and finishes analytically mid-flight.
    rem_loads = np.bincount(wtag + seq, minlength=space)
    over_pairs = np.flatnonzero(rem_loads > link_capacity)
    wover = np.bincount(over_pairs // nl, minlength=n_cwin)

    ptr = off[:-1].copy()  # next traversal of each packet
    end = off[1:].copy()
    orig = prio  # row -> caller's record index
    lat = np.zeros(n, dtype=np.int64)
    congestion = 0
    cycle = 0
    next_screen = _RESCREEN_EVERY  # entry screen already ran in the caller
    # Last cycle each window blocked a packet (or failed a screen): only
    # windows quiet for _RESCREEN_EVERY cycles are screen candidates.
    wlast = np.zeros(n_cwin, dtype=np.int64)

    def finish_windows(wmask: np.ndarray) -> None:
        """Analytically finish every alive packet of the flagged windows
        (their remaining pairs all fit capacity: nothing blocks again)."""
        nonlocal ptr, end, inject, win, orig
        m = wmask[win]
        if m.any():
            lat[orig[m]] = np.maximum(inject[m], cycle) + (end[m] - ptr[m])
            keep = ~m
            ptr, end, inject, win, orig = (
                ptr[keep], end[keep], inject[keep], win[keep], orig[keep])

    while orig.shape[0]:
        if cycle >= max_cycles:
            raise RuntimeError("NoC window failed to drain — capacity too low?")
        na = int(np.searchsorted(inject, cycle, side="right"))
        drained: np.ndarray | None = None
        if na:
            tag = wtag[ptr[:na]] + seq[ptr[:na]]
            demand = np.bincount(tag, minlength=space)
            go = np.ones(na, dtype=bool)
            hot = np.flatnonzero(demand[tag] > link_capacity)
            if hot.shape[0]:
                # Arbitrate only oversubscribed links: rows are already in
                # priority order, so a stable argsort on the tag alone
                # groups each link's requesters oldest-first.
                key = np.argsort(tag[hot], kind="stable")
                allow = np.empty(hot.shape[0], dtype=bool)
                allow[key] = _capacity_grants(tag[hot][key], link_capacity)
                go[hot] = allow
                nb = int(hot.shape[0] - allow.sum())
                congestion += nb
                if nb:
                    wlast[win[hot[~allow]]] = cycle
            granted_tags = tag[go]
            if granted_tags.shape[0]:
                dec = np.bincount(granted_tags, minlength=0)
                touched = np.flatnonzero(dec)
                before = rem_loads[touched]
                after = before - dec[touched]
                rem_loads[touched] = after
                crossed = touched[(before > link_capacity)
                                  & (after <= link_capacity)]
                if crossed.shape[0]:
                    cw = crossed // nl
                    wover -= np.bincount(cw, minlength=n_cwin)
                    drained = np.unique(cw)
                    drained = drained[wover[drained] == 0]
            ptr[:na] += go
            arr = np.flatnonzero(ptr[:na] == end[:na])
            if arr.shape[0]:
                lat[orig[arr]] = cycle + 1
                keep = np.ones(orig.shape[0], dtype=bool)
                keep[arr] = False
                ptr, end, inject, win, orig = (
                    ptr[keep], end[keep], inject[keep], win[keep], orig[keep])
        cycle += 1
        if drained is not None and drained.shape[0] and orig.shape[0]:
            wmask = np.zeros(n_cwin, dtype=bool)
            wmask[drained] = True
            finish_windows(wmask)
        if orig.shape[0] and cycle >= next_screen:
            # Exact (cycle, link) schedule screen over the remaining routes
            # of *quiet* windows (no block for _RESCREEN_EVERY cycles):
            # residual overloads diffused over cycles (stagger, queue
            # tails) never contend again and finish now — the load-based
            # drain exit cannot see those.  A window that fails the screen
            # is treated like a fresh block so it is not re-screened until
            # quiet again.
            next_screen = cycle + _RESCREEN_EVERY
            cand = wlast <= cycle - _RESCREEN_EVERY
            rows = np.flatnonzero(cand[win])
            if rows.shape[0]:
                start_c = np.maximum(inject[rows], cycle)
                rem = end[rows] - ptr[rows]
                rpkt = np.repeat(np.arange(rows.shape[0]), rem)
                cum = np.zeros(rows.shape[0] + 1, dtype=np.int64)
                np.cumsum(rem, out=cum[1:])
                within = np.arange(int(cum[-1])) - np.repeat(cum[:-1], rem)
                bad = _schedule_congested(win[rows[rpkt]],
                                          start_c[rpkt] + within,
                                          seq[ptr[rows[rpkt]] + within], nl,
                                          link_capacity)
                wlast[bad] = cycle
                wmask = cand.copy()
                wmask[bad] = False
                finish_windows(wmask)
    return lat, congestion


# ----------------------------------------------------------- multicast


def queued_multicast_tree(
    trace_t: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    group: np.ndarray,
    w: int,
    h: int,
    link_capacity: int,
    inject_capacity: int,
    energy: EnergyModel,
    n_local: int,
    max_cycles_per_window: int = 100_000,
    screen: str = "numpy",
    order: np.ndarray | None = None,
    device: "torch.device | str" = "cuda",
) -> NoCStats:
    """True tree-fork multicast replay over deduplicated (firing, dst) packets.

    One flit per firing is injected (so the crossbar egress stagger counts
    firings, not replicas) and forks along the XY multicast tree; each
    (firing, tree link) is traversed exactly once.  A destination's latency
    is the grant cycle of the tree link entering it, plus one.  Compared to
    the replica-based reference this is strictly tighter: fewer flits
    contend (tree links <= summed replica hops) and a firing occupies one
    injection slot instead of one per destination.

    ``order`` flags packets routed YX (fault escape; numpy screen only).
    Groups must then be order-pure — the fault layer splits each firing
    into an XY and a YX subgroup, so an escape copy is its own flit with
    its own tree and injection slot.
    """
    nl = link_count(w, h)
    ncores = w * h
    n = int(trace_t.shape[0])
    if n == 0:
        return _stats(np.empty(0, np.int64), 0, 0, np.zeros(nl, np.int64),
                      np.zeros(nl, np.int64), 0, n_local, energy,
                      "multicast", 0)
    if order is not None and screen == "linkload":
        raise ValueError("fault-escape routes require the numpy screen")
    win, n_win = _window_ids(trace_t)
    hops = route_hops(src_core, dst_core, w)
    total_hops = int(hops.sum())

    # Firing entities (canonical order: ascending firing id).
    uf, finv = np.unique(group, return_inverse=True)
    f_src = np.zeros(uf.shape[0], dtype=np.int64)
    f_win = np.zeros(uf.shape[0], dtype=np.int64)
    f_src[finv] = src_core  # every packet of a firing shares (t, src core)
    f_win[finv] = win
    f_inject = _inject_cycles(f_win, f_src, ncores, inject_capacity)

    # Tree-link entities, canonically sorted by (firing, link id).
    tids, tgrp = multicast_tree_links(src_core, dst_core, group, w, h,
                                      order=order)
    tf = np.searchsorted(uf, tgrp)
    tail, head = link_endpoints(tids, w, h)
    depth = route_hops(f_src[tf], tail, w)
    per_link = np.bincount(tids, minlength=nl)
    e_win = f_win[tf]

    # XY trees enter each node at most once per firing, so (firing, head)
    # is unique: one sorted key array serves parent pointers and the
    # packet -> terminal-link lookup.
    hkey = tf * np.int64(ncores) + head
    horder = np.argsort(hkey)
    hsorted = hkey[horder]

    def entity_of(firing_idx: np.ndarray, node: np.ndarray) -> np.ndarray:
        """Tree-link entity entering ``node`` in ``firing_idx``'s tree
        (-1 when the node is the firing's source)."""
        q = firing_idx * np.int64(ncores) + node
        pos = np.minimum(np.searchsorted(hsorted, q), hsorted.shape[0] - 1)
        return np.where(hsorted[pos] == q, horder[pos], -1)

    par = entity_of(tf, tail)

    # Tier 1: overloaded (window, link) pairs over *tree* loads.  Only a
    # firing whose tree touches an overloaded pair can see queueing (or
    # shift anyone else's timing), so all other firings deliver on the
    # unobstructed schedule: depth-d links cross at inject + d.
    if screen == "linkload":
        # Replica pairwise loads upper-bound tree loads: a sound (looser)
        # overload screen — extra firings get stepped, results identical.
        loads = _window_loads_linkload(win, src_core, dst_core, n_win, w, h,
                                       device)
        hot_keys = np.flatnonzero(loads.ravel() > link_capacity)
        pm = _member(hot_keys, e_win * np.int64(nl) + tids)
    else:
        wl_key = e_win * np.int64(nl) + tids
        hot_keys, counts = _hot_pairs(wl_key, n_win, nl, link_capacity)
        pm = (counts[wl_key] > link_capacity if counts is not None
              else _member(hot_keys, wl_key))

    lat = f_inject[finv] + hops  # analytic fast path
    congestion = 0
    if pm.any():
        fstep = np.zeros(uf.shape[0], dtype=bool)
        fstep[tf[pm]] = True
        sub = np.flatnonzero(fstep[tf])  # every entity of a stepped firing
        # Static schedule screen: windows whose stepped tree links never
        # oversubscribe any (cycle, link) bucket at inject + depth cannot
        # block (stagger-diffused overloads); keep truly contending ones.
        uwin0 = np.unique(e_win[sub])
        cwin0 = np.searchsorted(uwin0, e_win[sub])
        bad = _schedule_congested(cwin0, f_inject[tf[sub]] + depth[sub],
                                  tids[sub], nl, link_capacity)
        if bad.shape[0] < uwin0.shape[0]:
            badw = np.zeros(n_win, dtype=bool)
            badw[uwin0[bad]] = True
            fstep &= badw[f_win]
            sub = np.flatnonzero(fstep[tf])
    if pm.any() and sub.shape[0]:
        remap = np.full(tf.shape[0], -1, dtype=np.int64)
        remap[sub] = np.arange(sub.shape[0])
        par_sub = np.where(par[sub] >= 0, remap[par[sub]], -1)
        uwin = np.unique(e_win[sub])
        cwin = np.searchsorted(uwin, e_win[sub])
        grant_sub, congestion = _tree_stepper(
            cwin * np.int64(nl) + tids[sub],
            f_inject[tf[sub]], par_sub, depth[sub],
            uwin.shape[0] * nl, nl, link_capacity, max_cycles_per_window)
        grant = np.full(tf.shape[0], -1, dtype=np.int64)
        grant[sub] = grant_sub
        pmask = fstep[finv]
        term = entity_of(finv[pmask], dst_core[pmask])
        lat[pmask] = grant[term] + 1

    cycles_total = int(_per_window_max(lat, win, n_win).sum())
    return _stats(lat, total_hops, congestion, per_link, per_link,
                  cycles_total, n_local, energy, "multicast", n)


def _tree_stepper(
    tag: np.ndarray,
    prio: np.ndarray,
    par: np.ndarray,
    depth: np.ndarray,
    n_tags: int,
    nl: int,
    link_capacity: int,
    max_cycles: int,
) -> tuple[np.ndarray, int]:
    """Cycle-step tree-fork flits of all congested windows jointly.

    One entity per (firing, tree link): ``tag`` is the window-tagged link
    (compact window * nl + link), ``prio`` the firing's injection cycle
    (root availability and the arbitration age), ``par`` the entity index
    of the parent link (-1 at the source).  A child becomes requestable
    the cycle after its parent is granted.  Every ``_RESCREEN_EVERY``
    cycles the pending forward schedule is re-screened per window and
    windows that can no longer contend are granted analytically.  Returns
    (grant cycle per entity, blocked flit-cycle count).
    """
    ne = tag.shape[0]
    n_cwin = n_tags // nl
    done = np.zeros(ne, dtype=bool)
    avail = np.where(par < 0, prio, _INF)
    grant = np.full(ne, -1, dtype=np.int64)
    congestion = 0
    cycle = 0
    next_screen = _RESCREEN_EVERY  # entry screen already ran in the caller
    wlast = np.zeros(n_cwin, dtype=np.int64)  # last blocked cycle per window
    remaining = ne
    while remaining:
        if cycle >= max_cycles:
            raise RuntimeError("NoC window failed to drain — capacity too low?")
        aidx = np.flatnonzero(~done & (avail <= cycle))
        if aidx.shape[0]:
            tagi = tag[aidx]
            demand = np.bincount(tagi, minlength=n_tags)
            hot = np.flatnonzero(demand[tagi] > link_capacity)
            go = np.ones(aidx.shape[0], dtype=bool)
            if hot.shape[0]:
                key = np.lexsort((prio[aidx[hot]], tagi[hot]))
                allow = np.empty(hot.shape[0], dtype=bool)
                allow[key] = _capacity_grants(tagi[hot][key], link_capacity)
                go[hot] = allow
                nb = int(hot.shape[0] - allow.sum())
                congestion += nb
                if nb:
                    wlast[tagi[hot[~allow]] // nl] = cycle
            granted = aidx[go]
            done[granted] = True
            grant[granted] = cycle
            remaining -= granted.shape[0]
            # Fork: children of a just-granted parent request from the next
            # cycle (avail is written exactly once per entity).
            upd = np.flatnonzero((par >= 0) & (avail == _INF))
            if upd.shape[0]:
                ready = done[par[upd]]
                avail[upd[ready]] = cycle + 1
        cycle += 1
        if remaining and cycle >= next_screen:
            # Per-window exact (cycle, link) screen over the pending
            # forward schedule of *quiet* windows: those that can no
            # longer oversubscribe any bucket finish analytically.
            next_screen = cycle + _RESCREEN_EVERY
            cand = wlast <= cycle - _RESCREEN_EVERY
            pend = np.flatnonzero(~done & cand[tag // nl])
            if pend.shape[0]:
                est = _tree_forward_schedule(avail, par, depth, done, cycle)
                bad = _schedule_congested(tag[pend] // nl, est[pend],
                                          tag[pend] % nl, nl, link_capacity)
                wlast[bad] = cycle
                wmask = cand.copy()
                wmask[bad] = False
                fin = pend[wmask[tag[pend] // nl]]
                if fin.shape[0]:
                    grant[fin] = est[fin]
                    done[fin] = True
                    remaining -= fin.shape[0]
    return grant, congestion


def _tree_forward_schedule(
    avail: np.ndarray,
    par: np.ndarray,
    depth: np.ndarray,
    done: np.ndarray,
    cycle: int,
) -> np.ndarray:
    """Earliest unobstructed grant cycle of each pending entity from ``cycle``.

    An entity with a known availability requests at max(avail, cycle); one
    still waiting on its parent goes one cycle after the parent's estimate.
    Resolved by ascending depth (a parent is always one level shallower).
    """
    est = np.full(avail.shape[0], _INF, dtype=np.int64)
    known = avail != _INF
    est[known] = np.maximum(avail[known], cycle)
    pending_unknown = ~known & ~done
    if pending_unknown.any():
        for lvl in range(int(depth[pending_unknown].min()),
                         int(depth[pending_unknown].max()) + 1):
            m = pending_unknown & (depth == lvl)
            if m.any():
                est[m] = est[par[m]] + 1
    return est


# --------------------------------------------------------------- stats


def _stats(
    lat: np.ndarray,
    total_hops: int,
    congestion: int,
    per_link: np.ndarray,
    traversal_link: np.ndarray,
    cycles_total: int,
    n_local: int,
    energy: EnergyModel,
    cast: str,
    n_noc: int,
) -> NoCStats:
    traversals = int(traversal_link.sum())
    return NoCStats(
        avg_latency=float(lat.mean()) if n_noc else 0.0,
        max_latency=int(lat.max()) if n_noc else 0,
        avg_hop=float(total_hops / max(n_noc, 1)),
        total_hops=total_hops,
        congestion_count=congestion,
        edge_variance=edge_stats(per_link),
        dynamic_energy_pj=energy.dynamic_energy_pj(traversals, n_local),
        num_noc_spikes=n_noc,
        num_local_spikes=n_local,
        cycles_simulated=cycles_total,
        per_link_hops=per_link,
        cast=cast,
        link_traversals=traversals,
    )
