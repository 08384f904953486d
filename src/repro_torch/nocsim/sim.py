"""Trace-driven NoC simulation (evaluation phase, Noxim++ substitute).

Mode x cast matrix (what each combination computes):

  * ``queued`` / ``unicast`` — cycle-stepped replay, one packet per spike
    transmission.  The default ``engine="batched"`` is a two-tier replay
    (`repro_torch.nocsim.replay`): windows whose per-cycle link demand
    provably fits ``link_capacity`` — screened from whole-window link loads
    and the static XY schedule (latency = injection stagger + hops),
    optionally via the ``kernels/link_load`` route histogram — are scored
    analytically with zero cycle stepping; all congested windows are then
    stepped *jointly* in one vectorized loop (window-tagged link
    arbitration, hot-link-only sorting, analytic tail finish).  Stats are
    bit-identical to the scalar reference engine, kept as ``engine="ref"``
    (`_queued_ref`).
  * ``queued`` / ``multicast`` — true tree-fork flits: one flit per firing
    forks at branch routers (state per (firing, tree link); a child link
    becomes requestable the cycle after its parent is granted; one
    traversal per tree link).  Latency and congestion are those of a real
    multicast router — strictly tighter than ``engine="ref"``, which
    simulates every (firing, destination core) replica individually and is
    retained as the documented upper bound.  Link loads and dynamic energy
    use exact tree accounting under both engines.
  * ``analytic`` / either cast — fully vectorized, no queueing: latency =
    hop count, congestion per Eq. 3 from per-window link loads, edge
    variance from static route expansion.  Used for property tests and
    fast sweeps.

Queued replays canonicalize record order within each time step before
simulating (and deduplicate into firings under multicast), so every
reported stat is invariant to how the profiler ordered simultaneous
spikes.  Each SNN time step opens a fresh window; all spikes of the step
are injected (subject to the crossbar's per-step egress limit) and
simulated until drained, mirroring how Noxim++ replays a spike trace when
the SNN time step is much longer than the NoC clock.

Metrics (paper §4.3): average latency, dynamic energy, congestion count,
edge variance.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.trace import dedupe_firings

from .energy import EnergyModel
from .replay import queued_multicast_tree, queued_unicast
from .stats import NoCStats, edge_stats
from .xy import (
    link_count,
    link_ids_for_routes,
    multicast_tree_links,
    next_link,
    route_hops,
    routes_blocked,
)

__all__ = ["NoCStats", "dedupe_firings", "simulate_noc"]


def _analytic(
    trace_t: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    w: int,
    h: int,
    link_capacity: int,
    energy: EnergyModel = EnergyModel(),
    group: np.ndarray | None = None,
    chunk_links: int = 20_000_000,
    route_order: np.ndarray | None = None,
) -> NoCStats:
    nl = link_count(w, h)
    local = src_core == dst_core
    n_local = int(local.sum())
    t, s, d = trace_t[~local], src_core[~local], dst_core[~local]
    g = group[~local] if group is not None else None
    o = route_order[~local] if route_order is not None else None
    hops = route_hops(s, d, w)
    total_hops = int(hops.sum())

    per_link = np.zeros(nl, dtype=np.int64)
    congestion = 0
    # Chunk over windows to bound route-expansion memory.
    order = np.argsort(t, kind="stable")
    t, s, d = t[order], s[order], d[order]
    if g is not None:
        g = g[order]
    if o is not None:
        o = o[order]
    bounds = np.flatnonzero(np.diff(t)) + 1
    windows = np.split(np.arange(t.shape[0]), bounds)
    batch: list[np.ndarray] = []
    batch_size = 0

    def flush(idxs: list[np.ndarray]) -> int:
        nonlocal per_link
        cong = 0
        for widx in idxs:
            ow = o[widx] if o is not None else None
            if g is None:
                ids, _ = link_ids_for_routes(s[widx], d[widx], w, h, order=ow)
            else:
                ids, _ = multicast_tree_links(s[widx], d[widx], g[widx], w, h,
                                              order=ow)
            loads = np.bincount(ids, minlength=nl)
            per_link += loads
            cong += int(np.maximum(loads - link_capacity, 0).sum())
        return cong

    for widx in windows:
        batch.append(widx)
        batch_size += widx.shape[0]
        if batch_size * 8 >= chunk_links:
            congestion += flush(batch)
            batch, batch_size = [], 0
    congestion += flush(batch)

    n_noc = int(t.shape[0])
    traversals = int(per_link.sum())  # == total_hops when unicast
    return NoCStats(
        avg_latency=float(hops.mean()) if n_noc else 0.0,
        max_latency=int(hops.max()) if n_noc else 0,
        avg_hop=float(total_hops / max(n_noc, 1)),
        total_hops=total_hops,
        congestion_count=congestion,
        edge_variance=edge_stats(per_link),
        dynamic_energy_pj=energy.dynamic_energy_pj(traversals, n_local),
        num_noc_spikes=n_noc,
        num_local_spikes=n_local,
        cycles_simulated=0,
        per_link_hops=per_link,
        cast="unicast" if group is None else "multicast",
        link_traversals=traversals,
    )


def _queued_ref(
    trace_t: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    w: int,
    h: int,
    link_capacity: int,
    inject_capacity: int,
    energy: EnergyModel,
    group: np.ndarray | None = None,
    max_cycles_per_window: int = 100_000,
    route_order: np.ndarray | None = None,
) -> NoCStats:
    """Scalar reference engine: Python loop per window, lexsorts per cycle.

    Kept verbatim as the parity oracle for the batched replay
    (`repro.nocsim.replay`) and as the replica-based multicast upper bound
    the tree-fork engine is measured against.  ``route_order`` flags
    records routed YX (fault-escape detours); ``None`` is pure XY.
    """
    nl = link_count(w, h)
    local = src_core == dst_core
    n_local = int(local.sum())
    t, s, d = trace_t[~local], src_core[~local], dst_core[~local]
    g = group[~local] if group is not None else None
    o = route_order[~local] if route_order is not None else None
    order = np.argsort(t, kind="stable")
    t, s, d = t[order], s[order], d[order]
    if g is not None:
        g = g[order]
    if o is not None:
        o = o[order]

    per_link = np.zeros(nl, dtype=np.int64)
    tree_per_link = np.zeros(nl, dtype=np.int64) if g is not None else None
    total_hops = int(route_hops(s, d, w).sum())
    congestion = 0
    latencies = np.zeros(t.shape[0], dtype=np.int64)
    cycles_total = 0

    bounds = np.flatnonzero(np.diff(t)) + 1
    for widx in np.split(np.arange(t.shape[0]), bounds):
        if widx.shape[0] == 0:
            continue
        ws, wd = s[widx], d[widx]
        wo = o[widx] if o is not None else None
        if g is not None:
            # Static tree accounting, chunked per window like the analytic
            # path (firing ids never span windows, so per-window dedup is
            # exact and the route expansion stays bounded).
            tids, _ = multicast_tree_links(ws, wd, g[widx], w, h, order=wo)
            tree_per_link += np.bincount(tids, minlength=nl)
        n = ws.shape[0]
        # Crossbar egress limit: the r-th spike from a core this step
        # injects at cycle r // inject_capacity.
        order_src = np.argsort(ws, kind="stable")
        rank = np.empty(n, dtype=np.int64)
        sorted_src = ws[order_src]
        grp_new = np.concatenate([[True], sorted_src[1:] != sorted_src[:-1]])
        grp_start = np.maximum.accumulate(np.where(grp_new, np.arange(n), 0))
        rank[order_src] = np.arange(n) - grp_start
        inject_cycle = rank // inject_capacity

        cur = ws.copy()
        arrived = cur == wd  # zero-hop impossible here (local removed)
        lat = np.zeros(n, dtype=np.int64)
        cycle = 0
        while not arrived.all():
            if cycle >= max_cycles_per_window:
                raise RuntimeError("NoC window failed to drain — capacity too low?")
            active = (~arrived) & (inject_cycle <= cycle)
            idx = np.flatnonzero(active)
            if idx.shape[0]:
                nxt, link = next_link(cur[idx], wd[idx], w, h,
                                      yx=wo[idx] if wo is not None else None)
                # Per-link arbitration: oldest (earliest inject, stable) first.
                key = np.lexsort((inject_cycle[idx], link))
                sl = link[key]
                grp_new = np.concatenate([[True], sl[1:] != sl[:-1]])
                grp_start = np.maximum.accumulate(np.where(grp_new, np.arange(sl.shape[0]), 0))
                rnk = np.arange(sl.shape[0]) - grp_start
                go = np.zeros(idx.shape[0], dtype=bool)
                go[key] = rnk < link_capacity
                moved = idx[go]
                per_link += np.bincount(link[go], minlength=nl)
                congestion += int(idx.shape[0] - moved.shape[0])  # Eq. 3: blocked this cycle
                cur[moved] = nxt[go]
                newly = moved[cur[moved] == wd[moved]]
                arrived[newly] = True
                lat[newly] = cycle + 1
            cycle += 1
        latencies[widx] = lat
        cycles_total += cycle

    n_noc = int(t.shape[0])
    if g is not None:
        # Static tree accounting overrides the replica-based link loads:
        # link traversals and energy depend only on the XY routes, not on
        # queueing, and a branch link carries one flit per firing.
        per_link = tree_per_link
    traversals = int(per_link.sum())
    return NoCStats(
        avg_latency=float(latencies.mean()) if n_noc else 0.0,
        max_latency=int(latencies.max()) if n_noc else 0,
        avg_hop=float(total_hops / max(n_noc, 1)),
        total_hops=total_hops,
        congestion_count=congestion,
        edge_variance=edge_stats(per_link),
        dynamic_energy_pj=energy.dynamic_energy_pj(traversals, n_local),
        num_noc_spikes=n_noc,
        num_local_spikes=n_local,
        cycles_simulated=cycles_total,
        per_link_hops=per_link,
        cast="unicast" if group is None else "multicast",
        link_traversals=traversals,
    )


def simulate_noc(
    trace_t: np.ndarray,
    trace_src: np.ndarray,
    trace_dst: np.ndarray,
    part: np.ndarray,
    placement: np.ndarray,
    mesh_w: int,
    mesh_h: int,
    link_capacity: int = 4,
    inject_capacity: int = 256,
    mode: str = "queued",
    cast: str = "unicast",
    energy: EnergyModel = EnergyModel(),
    engine: str = "batched",
    stepper: str = "numpy",
    screen: str = "numpy",
    max_cycles_per_window: int = 100_000,
    faults=None,
    device: "str | torch.device" = "cuda",
) -> NoCStats:
    """Replay a spike trace through the mapped NoC.

    Args:
      part: (num_neurons,) partition id per neuron.
      placement: (k,) core id per partition (the mapping M).
      mode: "queued" (cycle-accurate-style) or "analytic" (vectorized).
      cast: "unicast" (one packet per transmission) or "multicast" (one
        packet per (firing, destination core), tree link accounting).
      engine: "batched" (two-tier vectorized replay; tree-fork flits under
        multicast) or "ref" (scalar reference loop; replica-based
        multicast upper bound).  Queued mode only.
      stepper: "numpy" — substrate for the batched engine's joint
        congested-window cycle loop.  The reference's "jax" device stepper
        is not ported yet (ROADMAP queue 1, item 6) and raises
        NotImplementedError.
      screen: "numpy" (bincount over route expansion) or "linkload"
        (per-window loads from the ``kernels/link_load`` route histogram
        on ``device``) — backend for the batched engine's whole-window
        contention screen.  The choice never changes results, only where
        the screening work runs.
      faults: optional `repro.runtime.faults.FaultState` of dead cores and
        links.  Packets with a dead endpoint are dropped; packets whose XY
        route crosses a dead link/core detour via the YX escape order when
        that route is clean, and are dropped otherwise.  Drops and detours
        are reported in ``NoCStats.spikes_dropped`` / ``detour_hops``
        (detour hops count the escape routes' per-packet route hops; both
        orders are minimal, so a detour changes *which* links are crossed,
        not how many).  ``None`` — or a state with no failures — is
        bit-identical to the fault-free engines.  Fault-aware replay is
        host-only: it requires the default ``stepper="numpy"`` and
        ``screen="numpy"`` backends.
      device: where ``screen="linkload"`` runs (the card by default;
        raises where CUDA is absent unless ``device="cpu"``).
    """
    if mode not in ("queued", "analytic"):
        raise ValueError(f"unknown mode {mode!r}")
    if engine not in ("batched", "ref"):
        raise ValueError(f"unknown engine {engine!r}")
    if stepper == "jax":
        raise NotImplementedError(
            "stepper='jax' is not ported yet (ROADMAP queue 1, item 6: "
            "device stepper); use stepper='numpy'")
    if stepper != "numpy":
        raise ValueError(f"unknown stepper {stepper!r}")
    if screen not in ("numpy", "linkload"):
        raise ValueError(f"unknown screen {screen!r}")
    dev = resolve_device(device)
    fault_on = faults is not None and faults.any()
    if fault_on:
        if (faults.w, faults.h) != (mesh_w, mesh_h):
            raise ValueError(
                f"fault state built for {faults.w}x{faults.h}, "
                f"mesh is {mesh_w}x{mesh_h}")
        if stepper != "numpy":
            raise ValueError("fault-aware replay requires stepper='numpy'")
        if screen != "numpy":
            raise ValueError("fault-aware replay requires screen='numpy'")
        dead = faults.dead_cores
        blocked = faults.blocked_links()
    core_of_neuron = placement[part]
    src_core = core_of_neuron[trace_src]
    dst_core = core_of_neuron[trace_dst]
    # Canonical record order within each time step: queued stats must
    # depend on the multiset of simultaneous records, not on the order the
    # profiler emitted them (injection-stagger and arbitration tie-breaks
    # would otherwise leak emission order into latencies).
    ncores = mesh_w * mesh_h
    tmax = int(trace_t.max()) + 1 if trace_t.shape[0] else 1
    if tmax * ncores * ncores < np.iinfo(np.int64).max // 4:
        packed = ((trace_t.astype(np.int64) * ncores + src_core) * ncores
                  + dst_core)
        order = np.argsort(packed, kind="stable")
    else:
        order = np.lexsort((dst_core, src_core, trace_t))
    trace_t = trace_t[order]
    trace_src = trace_src[order]
    src_core = src_core[order]
    dst_core = dst_core[order]
    local = src_core == dst_core
    n_local = int(local.sum())
    keep_local = local
    dropped = 0
    detour_hops = 0
    if fault_on:
        # A core-local delivery on a dead core is lost with the core.
        keep_local = local & ~dead[src_core]
        dropped += n_local - int(keep_local.sum())
        n_local = int(keep_local.sum())

    def _fates(s: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(deliver, detour) per remote packet under the fault masks:
        dead endpoint -> drop; XY route clean -> direct; else YX escape
        route clean -> detour; else drop."""
        ep_dead = dead[s] | dead[d]
        xy_bad = routes_blocked(s, d, mesh_w, mesh_h, blocked)
        yx_ok = ~routes_blocked(s, d, mesh_w, mesh_h, blocked,
                                order=np.ones(s.shape[0], dtype=bool))
        deliver = ~ep_dead & (~xy_bad | yx_ok)
        return deliver, deliver & xy_bad

    def _with_faults(stats: NoCStats) -> NoCStats:
        stats.spikes_dropped = dropped
        stats.detour_hops = detour_hops
        return stats

    if cast == "multicast":
        # Only NoC-bound transmissions deduplicate into packets: a
        # core-local delivery is a synaptic event, not a packet, so every
        # local record keeps its unicast-model energy accounting.
        rt, rsrc, rdst, firing = dedupe_firings(
            trace_t[~local], trace_src[~local], dst_core[~local],
            int(part.shape[0]), mesh_w * mesh_h,
        )
        rsrc_core = core_of_neuron[rsrc]
        route_order = None
        if fault_on:
            deliver, yx = _fates(rsrc_core, rdst)
            dropped += int((~deliver).sum())
            detour_hops = int(route_hops(rsrc_core[yx], rdst[yx], mesh_w).sum())
            rt, rsrc_core, rdst = rt[deliver], rsrc_core[deliver], rdst[deliver]
            route_order = yx[deliver]
            # Escape copies fork their own tree: splitting each firing into
            # an XY and a YX subgroup keeps every group's route union a
            # tree entered at most once per node — the invariant both the
            # tree-fork engine and the static tree accounting rely on.
            firing = firing[deliver] * 2 + route_order.astype(np.int64)
        if mode == "analytic" or engine == "ref":
            # Replica-record layout (locals first; they are filtered on a
            # src_core == dst_core test inside, so any group label works).
            trace_t = np.concatenate([trace_t[keep_local], rt])
            src_core = np.concatenate([src_core[keep_local], rsrc_core])
            dst_core = np.concatenate([dst_core[keep_local], rdst])
            group = np.concatenate([np.full(n_local, -1, dtype=np.int64),
                                    firing])
            order_cat = None
            if route_order is not None:
                order_cat = np.concatenate(
                    [np.zeros(n_local, dtype=bool), route_order])
        if mode == "analytic":
            return _with_faults(_analytic(
                trace_t, src_core, dst_core, mesh_w, mesh_h,
                link_capacity, energy, group, route_order=order_cat))
        if engine == "ref":
            return _with_faults(_queued_ref(
                trace_t, src_core, dst_core, mesh_w, mesh_h,
                link_capacity, inject_capacity, energy, group,
                max_cycles_per_window, route_order=order_cat))
        return _with_faults(queued_multicast_tree(
            rt, rsrc_core, rdst, firing, mesh_w, mesh_h, link_capacity,
            inject_capacity, energy, n_local, max_cycles_per_window,
            screen=screen, order=route_order, device=dev))
    if cast != "unicast":
        raise ValueError(f"unknown cast {cast!r}")
    route_order = None
    if fault_on:
        rt2 = trace_t[~local]
        rs, rd = src_core[~local], dst_core[~local]
        deliver, yx = _fates(rs, rd)
        dropped += int((~deliver).sum())
        detour_hops = int(route_hops(rs[yx], rd[yx], mesh_w).sum())
        route_order = yx[deliver]
        trace_t = np.concatenate([trace_t[keep_local], rt2[deliver]])
        src_core = np.concatenate([src_core[keep_local], rs[deliver]])
        dst_core = np.concatenate([dst_core[keep_local], rd[deliver]])
        order_cat = np.concatenate([np.zeros(n_local, dtype=bool),
                                    route_order])
        local = src_core == dst_core
    else:
        order_cat = None
    if mode == "analytic":
        return _with_faults(_analytic(
            trace_t, src_core, dst_core, mesh_w, mesh_h,
            link_capacity, energy, route_order=order_cat))
    if engine == "ref":
        return _with_faults(_queued_ref(
            trace_t, src_core, dst_core, mesh_w, mesh_h,
            link_capacity, inject_capacity, energy, None,
            max_cycles_per_window, route_order=order_cat))
    return _with_faults(queued_unicast(
        trace_t[~local], src_core[~local], dst_core[~local], mesh_w, mesh_h,
        link_capacity, inject_capacity, energy, n_local,
        max_cycles_per_window, stepper=stepper, screen=screen,
        order=route_order, device=dev))
