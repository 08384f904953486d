"""Vertex-block sharding plan for the partitioning engine.

The partitioning engine shards its O(n)/O(m) state over contiguous vertex
blocks (CSR rows stay contiguous per shard, so per-shard adjacency slices
are zero-copy views).  Uneven or device-incompatible layouts degrade
gracefully: the plan stays host-only and records the reason in ``notes``
instead of failing.

Where the reference attaches a ``jax.sharding.NamedSharding`` over a 1-D
``vertex`` mesh axis, the plan here carries a list of torch devices, one
per shard.  The reference's parameter rules (``ShardingPlan``,
``spec_for_param``, ``plan_params``, ...) belong to its LLM scaffolding
and are not ported yet (ROADMAP queue 1, item 12a).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["VertexShardPlan", "plan_vertex_shards"]


@dataclass
class VertexShardPlan:
    """Contiguous vertex-block decomposition of an n-vertex graph.

    ``bounds`` is an int64 array of length ``num_shards + 1`` with
    ``bounds[0] == 0`` and ``bounds[-1] == n``; shard ``s`` owns the
    half-open vertex range ``[bounds[s], bounds[s+1])``.  When the plan was
    built with device placement and the blocks divide evenly, ``devices``
    holds one torch device per shard for placing O(n) vertex arrays;
    otherwise it is ``None`` and the reason is in ``notes`` (plain numpy
    blocks on the host).
    """

    bounds: np.ndarray
    devices: list[torch.device] | None = None
    notes: list[str] = field(default_factory=list)

    @property
    def num_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def n(self) -> int:
        return int(self.bounds[-1])

    def block(self, s: int) -> tuple[int, int]:
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def owner(self, vertices: np.ndarray) -> np.ndarray:
        """Shard id owning each vertex id."""
        return np.searchsorted(self.bounds, vertices, side="right") - 1

    def split(self, rows: np.ndarray) -> list[np.ndarray]:
        """Split a sorted array of vertex ids into per-shard sub-arrays."""
        cuts = np.searchsorted(rows, self.bounds[1:-1])
        return np.split(rows, cuts)

    def device_put(self, arr: np.ndarray):
        """Place an O(n) vertex array according to the plan.

        Returns one tensor per shard, block ``s`` on ``devices[s]``, when
        the plan carries devices, else the input unchanged (the host numpy
        path).
        """
        if self.devices is None:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return [t[lo:hi].to(dev) for (lo, hi), dev in
                zip((self.block(s) for s in range(self.num_shards)),
                    self.devices)]


def plan_vertex_shards(n: int, num_shards: int,
                       use_devices: bool | str = "auto",
                       device: "str | torch.device" = "cuda") -> VertexShardPlan:
    """Plan ``num_shards`` contiguous near-equal vertex blocks for n vertices.

    ``use_devices="auto"`` attaches one device of ``device``'s type per
    shard when there are at least ``num_shards`` of them (CUDA cards; the
    CPU counts as one) *and* n divides evenly (the reference's rule: jax
    needs equal shards along a mesh axis); otherwise the plan stays
    host-only and records why.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    num_shards = min(num_shards, max(1, n))
    bounds = (np.arange(num_shards + 1, dtype=np.int64) * n) // num_shards
    plan = VertexShardPlan(bounds=bounds)
    if use_devices is False:
        return plan
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if count < num_shards:
        plan.notes.append(
            f"{count} device(s) < {num_shards} shards -> host-only blocks")
        return plan
    if n % num_shards != 0:
        plan.notes.append(
            f"n={n} !% {num_shards} shards -> host-only blocks (needs even)")
        return plan
    plan.devices = ([torch.device("cuda", i) for i in range(num_shards)]
                    if dev.type == "cuda" else [dev])
    return plan
