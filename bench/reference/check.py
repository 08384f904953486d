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
  reference replay (replay jobs only).

A run reports each number's worst over its jobs' answers.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lif, mapping, noc

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
                replay: bool, device) -> dict:
    """The numbers of one job's answers (``job``: the program's partition,
    placement, reported cut and avg_hop, and NoC statistics)."""
    n = net.num_neurons
    src = net.syn_src.astype(np.int64)
    dst = net.syn_dst.astype(np.int64)
    spikes = want.fire_counts[src]
    cores = platform["mesh_w"] * platform["mesh_h"]
    part = np.asarray(job["part"], dtype=np.int64)
    out = mapping.partition_checks(part, job["k"], job["edge_cut"],
                                   platform["capacity"], n, src, dst, spikes)
    worst = {"place_bad": max(job["k"], 1), "hop_gap": float("inf"),
             "swap_gain": float("inf")}
    if replay:
        worst["noc_gap"] = float("inf")
    if out["cap_over"]:
        return {**out, **worst}
    out.update(mapping.placement_checks(
        part, job["k"], job["placement"], job["avg_hop"], cores,
        platform["mesh_w"], src, dst, spikes))
    if out["place_bad"]:
        return {**out, **{k: v for k, v in worst.items() if k != "place_bad"}}
    if replay:
        core_of = np.asarray(job["placement"], dtype=np.int64)[part]
        ref = noc.replay(want.trace_t, core_of[want.trace_src],
                         core_of[want.trace_dst], platform["mesh_w"],
                         platform["mesh_h"], platform["link_capacity"],
                         platform["inject_capacity"],
                         (platform["router_pj"] + platform["link_pj"],
                          platform["local_pj"]), device)
        out["noc_gap"] = noc_gap(job["noc"], ref)
    return out

