"""Public wrappers: degree and gain matrices, the kernels on CUDA, plain on CPU."""
from __future__ import annotations

import torch

from .kernel import connectivity_degrees_cuda, part_degrees_cuda
from .ref import connectivity_degrees_ref, part_degrees_ref, part_onehot

__all__ = ["part_degrees", "connectivity_degrees", "gain_matrix"]


def part_degrees(adj: torch.Tensor, part: torch.Tensor, k: int,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, k) f32 degrees D[r, b] = sum_{u: part[u]=b} adj[rows[r], u]."""
    if adj.device.type == "cuda":
        return part_degrees_cuda(adj, part, k, rows)
    if adj.device.type == "cpu":
        return part_degrees_ref(adj, part, k, rows)
    raise ValueError(f"part_degrees runs on cuda or cpu tensors, not {adj.device}")


def connectivity_degrees(inc: torch.Tensor, pres: torch.Tensor,
                         rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, c) f32 connectivity-mode degrees D*[r] = inc[rows[r]] @ pres."""
    if inc.device.type == "cuda":
        return connectivity_degrees_cuda(inc, pres, rows)
    if inc.device.type == "cpu":
        return connectivity_degrees_ref(inc, pres, rows)
    raise ValueError(
        f"connectivity_degrees runs on cuda or cpu tensors, not {inc.device}")


def gain_matrix(adj: torch.Tensor, part: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 move gains (D minus the own-column internal degree, 0 in
    the own column).  The degree product is the part_degrees kernel on
    CUDA; the O(nk) epilogue is elementwise PyTorch on either device."""
    deg = part_degrees(adj, part, k)
    own = torch.take_along_dim(deg, part[:, None].to(torch.int64), dim=1)
    return (deg - own) * (1.0 - part_onehot(part, k))
