"""Public wrapper: per-partition degree rows, the kernel on CUDA, plain on CPU."""
from __future__ import annotations

import torch

from .kernel import part_degrees_cuda
from .ref import part_degrees_ref

__all__ = ["part_degrees"]


def part_degrees(adj: torch.Tensor, part: torch.Tensor, k: int,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, k) f32 degrees D[r, b] = sum_{u: part[u]=b} adj[rows[r], u]."""
    if adj.device.type == "cuda":
        return part_degrees_cuda(adj, part, k, rows)
    if adj.device.type == "cpu":
        return part_degrees_ref(adj, part, k, rows)
    raise ValueError(f"part_degrees runs on cuda or cpu tensors, not {adj.device}")
