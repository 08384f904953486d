"""Plain multicast reference: the tree-fork replay of a spike trace, and the
recounts of the multicast traffic model over a network's synapses.

The semantics the toolchain documents for its multicast cast (the header of
its NoC simulator, its tree-fork replay and its firing deduplication),
written from those rules and not from its code:

* a firing is one (t, source neuron); a packet is one distinct (firing,
  destination core) whose core is not the source's; a core-local delivery is
  no packet and counts as a local spike, at the local energy, once per
  record of the trace;
* each SNN time step is a window of its own, injected at its start and
  drained before the next; every window is stepped at once;
* one flit a firing is injected: firings are taken in ascending firing id
  (t, then source neuron), and a core injects at most ``inject_capacity``
  of them a cycle;
* the flit's tree is the union of the XY routes to its destination cores;
  each tree link is traversed once; a root link (leaving the source core)
  can be requested from the injection cycle on, and a child link from the
  cycle after its parent link is granted;
* each directed link grants at most ``link_capacity`` requests a cycle,
  the earliest injected first, then in (firing, link) order; every refused
  request adds one to congestion (Eq. 3 of the paper);
* a destination's latency is the grant cycle of the tree link that enters
  it, plus one;
* link loads and energy count tree traversals; ``total_hops`` and
  ``avg_hop`` count the packets' pairwise routes; ``cycles_simulated`` is
  the sum over windows of the largest latency.

The recounts take the network's synapses and the reference profile's fire
counts (a firing transmits on every synapse of its source):

* the traffic matrix holds, off the diagonal, one packet a (firing,
  destination partition other than the source's) and, on it, every
  intra-partition delivery, once a synapse a firing;
* the communication volume is the off-diagonal sum, fires x (lambda - 1);
* the tree hop count is, a firing, the links of the XY tree from its
  source's core to its destination partitions' cores.

Choices where the rules leave something open: the hop measures divide by
the packets of the cast's traffic model plus the intra-partition
deliveries (the sum of the traffic matrix, which is every transmission
under unicast), as the program's placement report documents; link ids
follow the east, west, south, north layout of ``noc.py``, which orders
only ties between two links of one firing, never a link's arbitration.
"""
from __future__ import annotations

import numpy as np
import torch

from .noc import _links

__all__ = ["traffic", "comm_volume", "tree_links", "replay"]

_INF = np.iinfo(np.int64).max


def _pairs(part: np.ndarray, src: np.ndarray, dst: np.ndarray):
    """The distinct (source neuron, destination partition) pairs whose
    partition is not the source's."""
    ps, pd = part[src], part[dst]
    remote = ps != pd
    k = int(part.max()) + 1
    key = np.unique(src[remote] * k + pd[remote])
    return key // k, key % k


def traffic(part: np.ndarray, k: int, src: np.ndarray, dst: np.ndarray,
            fire: np.ndarray) -> np.ndarray:
    """(k, k) int64 packets of the multicast model, from partition i to j."""
    part = np.asarray(part, dtype=np.int64)
    ps, pd = part[src], part[dst]
    local = ps == pd
    out = np.zeros(k * k, dtype=np.int64)
    np.add.at(out, ps[local] * (k + 1), fire[src[local]])
    s, p = _pairs(part, src, dst)
    np.add.at(out, part[s] * k + p, fire[s])
    return out.reshape(k, k)


def comm_volume(part: np.ndarray, src: np.ndarray, dst: np.ndarray,
                fire: np.ndarray) -> int:
    """Packets a firing sends to partitions other than its own, summed."""
    s, _ = _pairs(np.asarray(part, dtype=np.int64), src, dst)
    return int(fire[s].sum())


def _tree(group: torch.Tensor, s: torch.Tensor, d: torch.Tensor, w: int,
          h: int, nl: int):
    """Each group's XY tree: one entity a distinct (group, link), sorted by
    (group, link), with the entity of its parent link (-1 at the root), and
    for each (source, destination) route the entity entering its
    destination.  Routes of one group share their source."""
    steps, parents = [], []
    cur = s.clone()
    last = torch.full_like(s, -1)
    term = torch.full_like(s, -1)
    live = torch.nonzero(cur != d).flatten()
    while live.numel():
        nxt, link = _links(cur[live], d[live], w, h)
        steps.append(group[live] * nl + link)
        parents.append(torch.where(last[live] >= 0, group[live] * nl
                                   + last[live], torch.full_like(link, -1)))
        last[live] = link
        cur[live] = nxt
        live = live[cur[live] != d[live]]
    if not steps:
        empty = torch.zeros(0, dtype=torch.int64, device=s.device)
        return empty, empty, empty, term
    keys = torch.cat(steps)
    pkeys = torch.cat(parents)
    ent, inv = torch.unique(keys, return_inverse=True)
    parent = torch.full_like(ent, -1)
    parent[inv] = torch.where(pkeys >= 0, torch.searchsorted(ent, pkeys),
                              torch.full_like(pkeys, -1))
    # The last link of each route enters its destination.
    has = last >= 0
    term[has] = torch.searchsorted(ent, group[has] * nl + last[has])
    return ent // nl, ent % nl, parent, term


def tree_links(part: np.ndarray, placement: np.ndarray, src: np.ndarray,
               dst: np.ndarray, fire: np.ndarray, w: int, h: int) -> int:
    """Links of every firing's XY tree, summed over the firings."""
    part = np.asarray(part, dtype=np.int64)
    core = np.asarray(placement, dtype=np.int64)
    s, p = _pairs(part, src, dst)
    g = torch.as_tensor(s)
    grp, _, _, _ = _tree(g, torch.as_tensor(core[part[s]]),
                         torch.as_tensor(core[p]), w, h, 2 * (w - 1) * h
                         + 2 * w * (h - 1))
    size = np.bincount(grp.numpy(), minlength=part.shape[0])
    return int((size * fire).sum())


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the equal keys before it (``key`` sorted)."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    new = torch.ones(n, dtype=torch.bool, device=key.device)
    new[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)), 0).values
    return idx - start


def replay(trace_t: np.ndarray, trace_src: np.ndarray, trace_dst: np.ndarray,
           core_of: np.ndarray, w: int, h: int, link_capacity: int,
           inject_capacity: int, energy: tuple[float, float],
           device: torch.device, max_cycles: int = 100_000) -> dict:
    """NoC statistics of one tree-fork replay (``core_of``: each neuron's
    core; ``energy``: pJ a link traversal, pJ a local delivery)."""
    dev = torch.device(device)
    nl = 2 * (w - 1) * h + 2 * w * (h - 1)
    ncores = w * h
    n_neurons = int(core_of.shape[0])
    core = torch.as_tensor(np.asarray(core_of), dtype=torch.int64, device=dev)
    t = torch.as_tensor(np.asarray(trace_t), dtype=torch.int64, device=dev)
    sn = torch.as_tensor(np.asarray(trace_src), dtype=torch.int64, device=dev)
    dn = torch.as_tensor(np.asarray(trace_dst), dtype=torch.int64, device=dev)
    sc, dc = core[sn], core[dn]
    remote = sc != dc
    n_local = int((~remote).sum())
    # Packets: distinct (firing, destination core), in ascending order.
    pk = torch.unique((t[remote] * n_neurons + sn[remote]) * ncores
                      + dc[remote])
    firing_of, d = pk // ncores, pk % ncores
    n = int(pk.shape[0])
    fid, pf = torch.unique(firing_of, return_inverse=True)  # ascending firing id
    f_t = fid // n_neurons
    f_src = core[fid % n_neurons]
    s = f_src[pf]
    hops = (s % w - d % w).abs() + (s // w - d // w).abs()
    # Injection: the firing's rank among its window's firings from its core.
    order = torch.sort(f_t * ncores + f_src, stable=True)
    f_inject = torch.empty_like(fid)
    f_inject[order.indices] = _ranks(order.values) // inject_capacity
    e_f, e_link, parent, term = _tree(pf, s, d, w, h, nl)
    ne = int(e_f.shape[0])
    e_t, e_inject = f_t[e_f], f_inject[e_f]
    avail = torch.where(parent < 0, e_inject, torch.full_like(e_inject, _INF))
    grant = torch.full_like(e_f, -1)
    span = int(f_inject.max()) + 1 if n else 1
    pending = torch.arange(ne, device=dev)  # (firing, link) order
    congestion = 0
    cycle = 0
    while pending.numel():
        if cycle >= max_cycles:
            raise RuntimeError("reference multicast replay did not drain")
        wait = pending[(avail[pending] == _INF) & (parent[pending] >= 0)]
        if wait.numel():
            up = grant[parent[wait]] >= 0
            avail[wait[up]] = grant[parent[wait[up]]] + 1
        ready = pending[avail[pending] <= cycle]
        if ready.numel():
            group = e_t[ready] * nl + e_link[ready]
            srt = torch.sort(group * span + e_inject[ready], stable=True)
            ok = torch.empty_like(ready, dtype=torch.bool)
            ok[srt.indices] = _ranks(srt.values // span) < link_capacity
            congestion += int(ready.shape[0] - int(ok.sum()))
            grant[ready[ok]] = cycle
            pending = pending[grant[pending] < 0]
        cycle += 1
    lat = grant[term] + 1 if n else torch.zeros(0, dtype=torch.int64, device=dev)
    per_link = torch.bincount(e_link, minlength=nl).cpu().numpy()
    t_pk = f_t[pf]
    windows = torch.zeros(int(t_pk.max()) + 1 if n else 1, dtype=torch.int64,
                          device=dev)
    windows.scatter_reduce_(0, t_pk, lat, reduce="amax")
    lat_np = lat.cpu().numpy()
    total_hops = int(hops.sum())
    return {
        "avg_latency": float(lat_np.mean()) if n else 0.0,
        "max_latency": int(lat_np.max()) if n else 0,
        "avg_hop": total_hops / max(n, 1),
        "total_hops": total_hops,
        "congestion_count": congestion,
        "edge_variance": float(np.var(per_link)),
        "dynamic_energy_pj": (float(ne) * energy[0]
                              + float(n_local) * energy[1]),
        "num_noc_spikes": n,
        "num_local_spikes": n_local,
        "cycles_simulated": int(windows.sum()),
    }
