"""The comparison that decides a run's ``correct``.

Everything the program produced in the window is held against the plain
reference of this folder, which works out the network's profile again from
the generated inputs and reads the program's outputs only to judge them:

* ``trace_diff``: transmission records in which the program's trace differs
  from the reference's (as sorted multisets of (t, src, dst));
* ``fire_diff``: neurons whose firing count differs;
* ``cap_over``: neurons over a core's capacity or without a partition;
* ``cut_gap``: the reported edge cut against a recount;
* ``place_bad``: partitions without a core of their own;
* ``hop_gap``: the reported avg_hop against a recount, relative;
* ``swap_gain``: the share of the hop cost one swap of two cores' contents
  would still save (the polish ends at a swap-local optimum);
* ``noc_gap``: the largest relative gap of a NoC statistic against the
  reference replay (replay jobs only);
* ``vol_gap``: the reported communication volume against a recount;
* ``tree_gap``: the reported tree hop against a recount, relative.

An answer is held to the cast that the benchmark's data states for it
(``platform["cast"]``): under unicast a packet is one transmission, and
``hop_gap``, ``swap_gain`` and ``noc_gap`` take the per-synapse spikes and
the unicast replay (``noc.py``); under multicast a packet is one (firing,
destination partition), and they take the multicast traffic matrix and the
tree-fork replay (``multicast.py``).  A number that the cell's limits do not
name is not computed.  A run reports each number's worst over its jobs'
answers.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lif, mapping, multicast, noc

__all__ = ["NOC_FIELDS", "profile_numbers", "job_numbers"]

NOC_FIELDS = ("avg_latency", "max_latency", "avg_hop", "total_hops",
              "congestion_count", "edge_variance", "dynamic_energy_pj",
              "num_noc_spikes", "num_local_spikes", "cycles_simulated")


def _packed(t, s, d, n: int, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t), device=device).to(torch.int64)
    s = torch.as_tensor(np.asarray(s), device=device).to(torch.int64)
    d = torch.as_tensor(np.asarray(d), device=device).to(torch.int64)
    return torch.sort((t * n + s) * n + d).values


def trace_diff(want: lif.Profile, trace_t, trace_src, trace_dst, n: int,
               device) -> int:
    """Records that differ between two traces, taken as multisets."""
    a = _packed(want.trace_t, want.trace_src, want.trace_dst, n, device)
    b = _packed(trace_t, trace_src, trace_dst, n, device)
    m = min(a.shape[0], b.shape[0])
    return int((a[:m] != b[:m]).sum()) + abs(a.shape[0] - b.shape[0])


def fire_diff(want: lif.Profile, fire_counts) -> int:
    got = np.asarray(fire_counts)
    if got.shape != want.fire_counts.shape:
        return int(want.fire_counts.shape[0])
    return int((got != want.fire_counts).sum())


def profile_numbers(want: lif.Profile, got, n: int, device) -> dict:
    """``got``: the program's profile (trace arrays and fire counts)."""
    return {"trace_diff": trace_diff(want, got["trace_t"], got["trace_src"],
                                     got["trace_dst"], n, device),
            "fire_diff": fire_diff(want, got["fire_counts"])}


def noc_gap(got: dict, want: dict) -> float:
    gaps = []
    for f in NOC_FIELDS:
        a, b = float(got[f]), float(want[f])
        gaps.append(abs(a - b) / abs(b) if b else abs(a))
    return max(gaps)


def job_numbers(net, want: lif.Profile, platform: dict, job: dict,
                replay: bool, device, names=None) -> dict:
    """The numbers of one job's answers (``job``: the program's partition,
    placement, reported cut, volume, avg_hop and tree hop, and NoC
    statistics) that ``names`` lists, or all of them."""
    def named(x: str) -> bool:
        return names is None or x in names

    n = net.num_neurons
    src = net.syn_src.astype(np.int64)
    dst = net.syn_dst.astype(np.int64)
    fire = want.fire_counts
    spikes = fire[src]
    cores = platform["mesh_w"] * platform["mesh_h"]
    cast = platform["cast"]
    if cast not in ("unicast", "multicast"):
        raise ValueError(f"unknown cast {cast!r} in the platform")
    part = np.asarray(job["part"], dtype=np.int64)
    out = mapping.partition_checks(part, job["k"], job["edge_cut"],
                                   platform["capacity"], n, src, dst, spikes)
    worst = {"place_bad": max(job["k"], 1), "hop_gap": float("inf"),
             "swap_gain": float("inf"), "tree_gap": float("inf")}
    if replay:
        worst["noc_gap"] = float("inf")
    if out["cap_over"]:
        return {**out, **worst, "vol_gap": float("inf")}
    if named("vol_gap"):
        got = job["comm_volume"]
        out["vol_gap"] = (float("inf") if got is None else
                          abs(int(got) - multicast.comm_volume(part, src, dst,
                                                               fire)))
    traffic = (multicast.traffic(part, job["k"], src, dst, fire)
               if cast == "multicast" else None)
    out.update(mapping.placement_checks(
        part, job["k"], job["placement"], job["avg_hop"], cores,
        platform["mesh_w"], src, dst, spikes, traffic, named("swap_gain")))
    if out["place_bad"]:
        return {**out, **{k: v for k, v in worst.items() if k != "place_bad"}}
    if named("tree_gap"):
        packets = int(spikes.sum()) if traffic is None else int(traffic.sum())
        links = multicast.tree_links(part, job["placement"], src, dst, fire,
                                     platform["mesh_w"], platform["mesh_h"])
        tree, got = links / max(packets, 1), job["tree_hop"]
        if got is None:
            out["tree_gap"] = float("inf")
        else:
            out["tree_gap"] = (abs(float(got) - tree) / tree if tree
                               else abs(float(got)))
    if replay and named("noc_gap"):
        core_of = np.asarray(job["placement"], dtype=np.int64)[part]
        args = (platform["mesh_w"], platform["mesh_h"],
                platform["link_capacity"], platform["inject_capacity"],
                (platform["router_pj"] + platform["link_pj"],
                 platform["local_pj"]), device)
        if cast == "multicast":
            ref = multicast.replay(want.trace_t, want.trace_src,
                                   want.trace_dst, core_of, *args)
        else:
            ref = noc.replay(want.trace_t, core_of[want.trace_src],
                             core_of[want.trace_dst], *args)
        out["noc_gap"] = noc_gap(job["noc"], ref)
    return out
