"""Plain cycle-stepped replay of a spike trace on a 2-D mesh NoC.

The semantics the toolchain's queued unicast replay documents, written from
its rules and not from its code:

* one packet per transmission whose source and destination neurons sit on
  different cores; a core-local delivery never enters the NoC;
* each SNN time step is a window of its own, injected at its start and
  drained before the next; within a step, records are taken in the order
  (source core, destination core);
* a core injects at most ``inject_capacity`` packets a cycle, in that order;
* XY routing: a packet moves along x to its destination column, then along
  y, one link a cycle;
* each directed link passes at most ``link_capacity`` packets a cycle, the
  earliest injected first and, among those, the first in record order; a
  packet that asks for a link and is refused counts once toward congestion
  (Eq. 3 of the paper);
* a packet's latency is the cycle after its last hop.

Every window is stepped at once, so one cycle of the loop advances every
window by one cycle.  ``energy`` is (pJ a link traversal, pJ a local
delivery).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["replay"]


def _links(cur: torch.Tensor, dst: torch.Tensor, w: int, h: int):
    """The next core and the directed link id of one XY step (east, west,
    south, north blocks of ids)."""
    cx, cy = cur % w, cur // w
    dx, dy = dst % w, dst // w
    east, west = cx < dx, cx > dx
    south = (cx == dx) & (cy < dy)
    nxt = torch.where(east, cur + 1, torch.where(
        west, cur - 1, torch.where(south, cur + w, cur - w)))
    horiz = (w - 1) * h
    link = torch.where(
        east, cy * (w - 1) + cx, torch.where(
            west, horiz + cy * (w - 1) + cx - 1, torch.where(
                south, 2 * horiz + cx * (h - 1) + cy,
                2 * horiz + w * (h - 1) + cx * (h - 1) + cy - 1)))
    return nxt, link


def replay(trace_t: np.ndarray, src_core: np.ndarray, dst_core: np.ndarray,
           w: int, h: int, link_capacity: int, inject_capacity: int,
           energy: tuple[float, float], device: torch.device,
           max_cycles: int = 100_000) -> dict:
    """NoC statistics of one replay (the fields named as in the paper)."""
    n_links = 2 * (w - 1) * h + 2 * w * (h - 1)
    ncores = w * h
    remote = src_core != dst_core
    n_local = int((~remote).sum())
    t = torch.as_tensor(trace_t[remote], dtype=torch.int64, device=device)
    s = torch.as_tensor(src_core[remote], dtype=torch.int64, device=device)
    d = torch.as_tensor(dst_core[remote], dtype=torch.int64, device=device)
    n = int(t.shape[0])
    order = torch.sort((t * ncores + s) * ncores + d, stable=True).indices
    t, s, d = t[order], s[order], d[order]
    hops = (s % w - d % w).abs() + (s // w - d // w).abs()
    # Injection slot: the packet's rank among its window's packets from
    # the same core, over the core's injections a cycle.
    idx = torch.arange(n, device=device)
    key = t * ncores + s
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values
    inject = (idx - start) // inject_capacity
    max_inject = int(inject.max()) + 1 if n else 1
    cur = s.clone()
    lat = torch.zeros(n, dtype=torch.int64, device=device)
    per_link = torch.zeros(n_links, dtype=torch.int64, device=device)
    alive = idx  # packets still in flight, in record order
    congestion = 0
    cycle = 0
    while alive.numel():
        if cycle >= max_cycles:
            raise RuntimeError("reference replay did not drain")
        ready = alive[inject[alive] <= cycle]
        if ready.numel():
            nxt, link = _links(cur[ready], d[ready], w, h)
            group = t[ready] * n_links + link
            rank_key = group * max_inject + inject[ready]
            srt = torch.sort(rank_key, stable=True).indices  # record order kept
            g = group[srt]
            pos = torch.arange(g.shape[0], device=device)
            new = torch.ones_like(g, dtype=torch.bool)
            new[1:] = g[1:] != g[:-1]
            gstart = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)), 0).values
            granted = torch.zeros(ready.shape[0], dtype=torch.bool, device=device)
            granted[srt] = (pos - gstart) < link_capacity
            moved = ready[granted]
            congestion += int(ready.shape[0] - moved.shape[0])
            per_link += torch.bincount(link[granted], minlength=n_links)
            cur[moved] = nxt[granted]
            done = moved[cur[moved] == d[moved]]
            lat[done] = cycle + 1
            alive = alive[cur[alive] != d[alive]]
        cycle += 1
    total_hops = int(hops.sum())
    traversals = int(per_link.sum())
    windows = torch.zeros(int(t.max()) + 1 if n else 1, dtype=torch.int64,
                          device=device)
    windows.scatter_reduce_(0, t, lat, reduce="amax")
    per_link_np = per_link.cpu().numpy()
    return {
        "avg_latency": float(lat.double().mean()) if n else 0.0,
        "max_latency": int(lat.max()) if n else 0,
        "avg_hop": total_hops / max(n, 1),
        "total_hops": total_hops,
        "congestion_count": congestion,
        "edge_variance": float(np.var(per_link_np)),
        "dynamic_energy_pj": (float(traversals) * energy[0]
                              + float(n_local) * energy[1]),
        "num_noc_spikes": n,
        "num_local_spikes": n_local,
        "cycles_simulated": int(windows.sum()),
    }
