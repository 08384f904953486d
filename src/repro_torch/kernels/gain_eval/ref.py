"""Plain PyTorch version of the cut-mode partition degree matrix.

For a dense weighted adjacency A (n, n) and a partition vector p (n,),

    D = A @ onehot(p)          D[v, b] = sum of w(v, u) over u with p[u] = b

Column p[v] of row v is v's internal degree; every other column is an
external degree (see `repro_torch.core.refine_vec`).  Only the requested
``rows`` of D are computed.
"""
from __future__ import annotations

import torch

__all__ = ["part_onehot", "part_degrees_ref"]


def part_onehot(part: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 one-hot of the partition vector."""
    cols = torch.arange(k, dtype=part.dtype, device=part.device)
    return (part[:, None] == cols[None, :]).to(torch.float32)


def part_degrees_ref(adj: torch.Tensor, part: torch.Tensor, k: int,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, k) f32 rows of D = A @ onehot(p); all n rows when ``rows`` is None."""
    a = adj if rows is None else adj[rows]
    return a.to(torch.float32) @ part_onehot(part, k)
