"""SNEAP-optimized logical->physical device layout (beyond-paper).

The paper's mapping phase places communicating partitions on a 2D mesh to
minimize hop-weighted traffic; the identical problem appears when laying
out a logical (data, model) mesh onto a physical torus of chips:
model-axis collectives (all-gather / reduce-scatter of weights and
activations) carry far more bytes than data-axis gradient reductions in
TP-heavy regimes, so the model axis should occupy physically-adjacent
chips.

`sneap_device_layout` builds the partition graph from per-axis collective
traffic (bytes between logical neighbors) and reuses
`repro_torch.core.mapping.sa_search` with torus distance to order the
devices of the mesh.  The search is host numpy, as in the reference: the
`kernels/swap_delta` op rebuilds Manhattan distances, not torus ones, so
it cannot score this search.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hopcost import hop_distance_matrix
from repro_torch.core.mapping import sa_search

__all__ = ["logical_traffic_matrix", "sneap_device_layout"]


def logical_traffic_matrix(
    mesh_shape: dict[str, int],
    axis_bytes: dict[str, float],
    patterns: dict[str, str] | None = None,
) -> np.ndarray:
    """Traffic between logical devices along each mesh axis.

    axis_bytes[axis] = bytes exchanged on that axis per step.
    patterns[axis] selects the traffic shape: "ring" (all-gather /
    reduce-scatter / all-reduce ring schedules — neighbor-only) or
    "alltoall" (MoE expert dispatch — every pair of devices differing only
    in this axis coordinate exchanges vol/(k-1) each way).
    """
    axes = list(mesh_shape.keys())
    sizes = [mesh_shape[a] for a in axes]
    n = int(np.prod(sizes))
    ids = np.arange(n).reshape(sizes)
    traffic = np.zeros((n, n))
    patterns = patterns or {}
    for ai, a in enumerate(axes):
        vol = axis_bytes.get(a, 0.0)
        k = sizes[ai]
        if vol <= 0 or k < 2:
            continue
        if patterns.get(a, "ring") == "alltoall":
            per_pair = vol / (k - 1)
            for shift in range(1, k):
                fwd = np.roll(ids, -shift, axis=ai)
                src = ids.reshape(-1)
                dst = fwd.reshape(-1)
                traffic[src, dst] += per_pair
        else:
            fwd = np.roll(ids, -1, axis=ai)
            src = ids.reshape(-1)
            dst = fwd.reshape(-1)
            traffic[src, dst] += vol
            traffic[dst, src] += vol
    return traffic


def sneap_device_layout(
    mesh_shape: dict[str, int],
    axis_bytes: dict[str, float],
    phys_w: int = 16,
    seed: int = 0,
    iters: int = 150_000,
    t0_frac: float = 2.0,
    dead_chips: list[int] | None = None,
    patterns: dict[str, str] | None = None,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, float, float]:
    """Order devices so hop-weighted collective traffic on the torus is low.

    The SA chain is seeded with the identity layout, so the result never
    regresses below the default row-major order (which is already
    hop-optimal for pure ring-neighbor traffic on an intact torus — the
    win appears for non-uniform traffic or a degraded pod, see
    `dead_chips`: logical devices then route around the holes).
    ``device`` is passed to `sa_search`, whose scalar chain is host numpy
    either way.

    Returns (device_order, baseline_avg_hop, optimized_avg_hop):
    ``device_order[i]`` is the physical chip of logical device ``i``.
    """
    traffic = logical_traffic_matrix(mesh_shape, axis_bytes, patterns)
    n_logical = traffic.shape[0]
    dead = sorted(dead_chips or [])
    n_phys = n_logical + len(dead)
    phys_h = n_phys // phys_w
    if phys_w * phys_h != n_phys:
        raise ValueError(f"{n_phys} chips do not fill rows of {phys_w}")
    dist = hop_distance_matrix(n_phys, phys_w, torus=True).astype(np.float64)
    if dead:
        # Dead chips cannot host devices: make them prohibitively distant so
        # the SA search keeps real (traffic-carrying) devices off them.
        penalty = float(dist.max()) * n_phys
        dist[dead, :] += penalty
        dist[:, dead] += penalty
        for c in dead:
            dist[c, c] = 0.0
    # Pad traffic with silent "virtual" partitions pinned to the dead chips
    # by the initial placement; swaps will move real devices off them.
    if dead:
        pad = np.zeros((n_phys, n_phys))
        pad[:n_logical, :n_logical] = traffic
        traffic = pad
    alive = [c for c in range(n_phys) if c not in dead]
    ident = np.concatenate([np.asarray(alive), np.asarray(dead)]).astype(np.int64)
    tot = max(traffic.sum(), 1)
    base = float((dist[ident[:n_logical, None], ident[None, :n_logical]]
                  * traffic[:n_logical, :n_logical]).sum() / tot)
    # A seeded chain starts at a local optimum; it needs a hot start
    # (t0_frac ~2) to escape before the geometric cooling bites.
    res = sa_search(traffic, n_phys, phys_w, trace_length=int(tot),
                    seed=seed, iters=iters, t0_frac=t0_frac, torus=True,
                    init=ident, device=device)
    placement = np.asarray(res.placement)
    opt = float((dist[placement[:n_logical, None], placement[None, :n_logical]]
                 * traffic[:n_logical, :n_logical]).sum() / tot)
    on_dead = dead and bool(np.isin(placement[:n_logical], dead).any())
    if opt > base or on_dead:  # SA failed to improve the seed; keep the seed
        placement, opt = ident, base
    order = np.empty(n_logical, dtype=np.int64)
    order[:] = placement[:n_logical]
    return order, base, opt
