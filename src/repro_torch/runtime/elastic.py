"""Elastic scaling: rebuild the mesh after pod/node loss and reshard state.

Recovery path on a real cluster: (1) surviving hosts agree on the new
device set, (2) `make_production_mesh` is rebuilt at the reduced pod
count, (3) the sharding planner re-plans on the new mesh (divisibility
rules may change — e.g. the batch divisor halves when a pod drops), and
(4) parameters/optimizer state are re-placed, either from the live copies
(`remesh_params`) or from the last committed checkpoint
(`CheckpointManager.restore` with the new plan's template).  Data shards
are re-balanced by re-deriving `DataConfig.num_shards` from the new mesh —
the pipeline's (seed, step, shard) determinism makes this a pure re-index.

Only replicated placement is ported: a spec that shards a dimension over
a mesh axis larger than 1 raises ``NotImplementedError``, since placing a
shard per card needs ``torch.distributed``, which the port does not use
yet (ROADMAP queue 1, item 12b's leftover).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh

__all__ = ["remesh_params"]


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def remesh_params(tree, new_mesh: "Mesh", new_specs):
    """Re-place a tree (nested dicts) of tensors onto ``new_mesh`` under
    ``new_specs`` (the planner's specs: one axis name, tuple of names or
    None per dimension).  Values are preserved exactly; only the
    placement changes — here, onto the mesh's one device."""
    sizes = new_mesh.shape
    device = new_mesh.devices.flat[0]

    def place(leaf: torch.Tensor, spec) -> torch.Tensor:
        split = [a for e in spec for a in _axes(e) if sizes.get(a, 1) > 1]
        if split:
            raise NotImplementedError(
                f"spec {spec} shards over mesh axes {split} of sizes "
                f"{[sizes[a] for a in split]}: placing shards on several cards "
                "is not ported (ROADMAP queue 1, item 12b's leftover)")
        return leaf.to(device)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return place(node, spec)

    return walk(tree, new_specs)
