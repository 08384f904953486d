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

A leaf whose spec splits it over mesh axes larger than 1 is placed as a
`Sharded`: on a mesh of cards in one process it holds every position's
block, each on its card; on a mesh of ranks (`repro_torch.launch.mesh.
make_rank_mesh`) each rank holds its own block, and `Sharded.full`
gathers them back (an ``all_gather`` over the mesh), bit for bit.  So a
tree placed on mesh A moves to mesh B as the reference's test moves it:
every rank of A takes part, and the ranks of B (a subset of A's, as after
a loss) come out holding their blocks; a rank outside B gets None.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.sharding.planner import shard_slices

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh

__all__ = ["remesh_params", "Sharded"]


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass
class Sharded:
    """A leaf of ``shape`` placed on ``mesh`` under ``spec``, which splits
    it: the blocks this process holds, by mesh position (every position on
    a mesh of cards, this rank's alone on a mesh of ranks)."""
    blocks: dict  # position (an index per axis) -> tensor
    shape: tuple[int, ...]
    mesh: "Mesh"
    spec: tuple

    @property
    def local(self) -> torch.Tensor:
        """This rank's block (a mesh of ranks)."""
        return self.blocks[tuple(self.mesh.coord.values())]

    def full(self) -> torch.Tensor:
        """The whole leaf, exact, on the first card of a mesh of cards or
        on this rank's device; on a mesh of ranks every rank of the mesh
        must call it (an ``all_gather`` over the axes ``spec`` splits: the
        positions along the others hold the same block)."""
        mesh = self.mesh
        if mesh.ranks is None:
            blocks = self.blocks
            device = mesh.devices.flat[0]
        else:
            # The blocks along the split axes, in their order (row-major).
            split = [a for a in mesh.axis_names
                     if a in {x for e in self.spec for x in _axes(e)}]
            gathered = mesh.all_gather(self.local, split)
            blocks = {}
            for index, block in zip(np.ndindex(*(mesh.shape[a] for a in split)),
                                    gathered):
                coord = dict(mesh.coord, **dict(zip(split, index)))
                blocks[tuple(coord[a] for a in mesh.axis_names)] = block
            device = mesh.device
        first = next(iter(blocks.values()))
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        for pos, block in blocks.items():
            coord = dict(zip(mesh.axis_names, pos))
            out[shard_slices(self.spec, self.shape, mesh.shape, coord)] = block
        return out


def remesh_params(tree, new_mesh: "Mesh", new_specs):
    """Re-place a tree (nested dicts) of tensors or `Sharded` leaves onto
    ``new_mesh`` under ``new_specs`` (the planner's specs: one axis name,
    tuple of names or None per dimension).  Values are preserved exactly;
    only the placement changes.  A leaf that no axis larger than 1 splits
    is a tensor on the mesh's (first) card or this rank's device; one that
    such an axis splits is a `Sharded` of its blocks (`shard_slices`).  On
    a mesh of ranks every rank of the old placement takes part (a
    `Sharded` leaf is gathered first), and a rank outside ``new_mesh``
    gets None for each leaf."""
    sizes = new_mesh.shape
    member = new_mesh.ranks is None or new_mesh.is_member

    def place(leaf, spec):
        if leaf is None:
            if member:
                raise ValueError("a rank of the new mesh holds no value of "
                                 "this leaf")
            return None
        full = leaf.full() if isinstance(leaf, Sharded) else leaf
        if not member:
            return None
        split = [a for e in spec for a in _axes(e) if sizes.get(a, 1) > 1]
        if new_mesh.ranks is None:
            if not split:
                return full.to(new_mesh.devices.flat[0])
            positions = list(np.ndindex(new_mesh.devices.shape))
        else:
            if not split:
                return full.to(new_mesh.device)
            positions = [tuple(new_mesh.coord.values())]
        blocks = {}
        for pos in positions:
            coord = dict(zip(new_mesh.axis_names, pos))
            block = full[shard_slices(spec, full.shape, sizes, coord)]
            blocks[pos] = block.to(new_mesh.devices[pos], copy=True)
        return Sharded(blocks, tuple(full.shape), new_mesh, tuple(spec))

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return place(node, spec)

    return walk(tree, new_specs)
