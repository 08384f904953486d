"""What a rematerialized layer keeps: the outputs of the collectives it
issues, under the ``"save_collectives"`` remat policy
(`repro_torch.models.model`; the reference's ``save_only_these_names(
"tp_collective_out")``).

The collectives of a mesh of ranks (`repro_torch.launch.mesh.Mesh`) and
the row-parallel product (`repro_torch.models.layers.row_parallel`) make
their outputs through `kept`: outside a `KeptCollectives.run` it issues
them; inside one, the first run keeps each output and a later run (the
backward's recomputation of the layer) gives them back in order without
issuing anything.
"""
from __future__ import annotations

import torch

__all__ = ["KeptCollectives", "kept"]

# The `KeptCollectives` of the layers being run, innermost last.
_KEEP: list = []


class KeptCollectives:
    """The outputs of the collectives issued inside one layer.  The first
    `run` keeps each output; a later `run` gives them back in order
    instead of issuing the collectives again.  A collective saves no
    tensor for its backward (a row-parallel product saves its operands
    either way), so the recomputation packs the same saved tensors in
    the same order as the forward did."""

    def __init__(self) -> None:
        self.outs: list[torch.Tensor] = []
        self.at: int | None = None  # None: keeping; else the next to give

    def run(self, fn, *args, **kwargs):
        _KEEP.append(self)
        try:
            return fn(*args, **kwargs)
        finally:
            _KEEP.pop()
            self.at = 0

    def __call__(self, make) -> torch.Tensor:
        if self.at is None:
            out = make()
            self.outs.append(out.detach())
            return out
        out = self.outs[self.at]
        self.at += 1
        return out.detach()


def kept(make) -> torch.Tensor:
    """``make()``, the issue of a collective, or its kept output inside
    `KeptCollectives.run`."""
    return _KEEP[-1](make) if _KEEP else make()
