"""Plain LIF simulation of a benchmark network and its spike trace.

The same semantics as the toolchain's profiling phase, written from the
equations and not from the program: each step every neuron sums the weights
of its synapses whose source fired the step before, one at a time in
ascending source order (so the float32 sum is one sequence of roundings),
adds the drive, and applies decay, threshold, reset and refractory period.
The trace holds one record (t, src, dst) per synapse of each firing, and is
cut at the step where the transmissions reach the network's
``target_spikes`` (Table 1 of the paper).  ``dtype`` lets the control run
the same simulation in bfloat16.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Profile", "simulate"]


@dataclass
class Profile:
    trace_t: np.ndarray  # (S,) int64
    trace_src: np.ndarray  # (S,) int64
    trace_dst: np.ndarray  # (S,) int64
    fire_counts: np.ndarray  # (N,) int64, firings over the kept steps
    num_steps: int  # steps kept


def _ell(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
         dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, N) source ids and weights, each destination's column in
    ascending source order, padded with weight 0."""
    order = np.lexsort((src, dst))
    src, dst, w = src[order], dst[order], w[order]
    deg = np.bincount(dst, minlength=n)
    width = int(deg.max()) if deg.size else 0
    slot = np.arange(dst.shape[0]) - (np.cumsum(deg) - deg)[dst]
    ell_src = np.zeros((width, n), dtype=np.int64)
    ell_w = np.zeros((width, n), dtype=np.float32)
    ell_src[slot, dst] = src
    ell_w[slot, dst] = w
    return torch.from_numpy(ell_src), torch.from_numpy(ell_w).to(dtype)


def simulate(net, drive: np.ndarray, dtype: torch.dtype = torch.float32) -> Profile:
    """Run ``net`` (a `snngen.Network`) under ``drive`` (T, N) on the CPU."""
    n = net.num_neurons
    src = net.syn_src.astype(np.int64)
    dst = net.syn_dst.astype(np.int64)
    ell_src, ell_w = _ell(n, src, dst, net.syn_w, dtype)
    out_deg = np.bincount(src, minlength=n)
    p = net.lif
    decay, threshold = float(p["decay"]), float(p["threshold"])
    v_reset, refractory = float(p["v_reset"]), int(p["refractory"])
    target = net.target_spikes
    drive_t = torch.from_numpy(drive).to(dtype)
    zero = torch.zeros((), dtype=dtype)
    v = torch.zeros(n, dtype=dtype)
    refr = torch.zeros(n, dtype=torch.int32)
    fired = torch.zeros(n, dtype=torch.bool)
    rows: list[np.ndarray] = []
    sent = 0
    cut_at = None  # the step where the transmissions first reach the target
    for t in range(drive.shape[0]):
        g = torch.where(fired[ell_src], ell_w, zero)
        cur = torch.zeros(n, dtype=dtype)
        for c in range(g.shape[0]):
            cur = cur + g[c]
        current = cur + drive_t[t]
        active = refr <= 0
        v2 = torch.where(active, decay * v + current, v)
        fired = active & (v2 >= threshold)
        v = torch.where(fired, torch.full_like(v2, v_reset), v2)
        refr = torch.where(fired, torch.full_like(refr, refractory),
                           torch.clamp(refr - 1, min=0))
        row = np.flatnonzero(fired.numpy())
        step_sent = int(out_deg[row].sum())
        if cut_at is not None and step_sent > 0:
            break  # a record beyond the target exists: cut at cut_at
        rows.append(row)
        sent += step_sent
        if target is not None and cut_at is None and sent >= target:
            cut_at = t
            if sent > target:
                break
    else:
        cut_at = None  # never passed the target: every step is kept
    if cut_at is not None:
        rows = rows[: cut_at + 1]
    fire_counts = np.zeros(n, dtype=np.int64)
    for row in rows:
        fire_counts[row] += 1
    # Records: each firing (t, i), once per synapse of i.
    fired_t = np.concatenate([np.full(r.shape[0], t, dtype=np.int64)
                              for t, r in enumerate(rows)] or [np.zeros(0, np.int64)])
    fired_i = np.concatenate(rows or [np.zeros(0, np.int64)]).astype(np.int64)
    order = np.argsort(src, kind="stable")
    xadj = np.concatenate([[0], np.cumsum(out_deg)])
    counts = out_deg[fired_i]
    starts = np.repeat(xadj[fired_i], counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    idx = order[starts + np.arange(int(counts.sum())) - first]
    return Profile(trace_t=np.repeat(fired_t, counts),
                   trace_src=np.repeat(fired_i, counts), trace_dst=dst[idx],
                   fire_counts=fire_counts, num_steps=len(rows))
