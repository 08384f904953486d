"""Plain PyTorch version of the all-pairs SA swap deltas.

For symmetric traffic S = C + C^T and placed-distance matrix
D[i, j] = manhattan(place_i, place_j), the change in total hop-weighted
traffic when partitions a and b exchange cores is

  delta[a, b] = (S D)[a, b] + (D S)[a, b] - r[a] - r[b]
                - (S[a, a] + S[b, b] - 2 S[a, b]) * D[a, b]

with r[a] = sum_j S[a, j] D[a, j] — the matrix form of the O(K)
incremental swap evaluation (`repro_torch.core.hopcost.swap_delta`).
"""
from __future__ import annotations

import torch

__all__ = ["distance_matrix", "swap_prepass", "swap_deltas_ref"]


def distance_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x[:, None] - x[None, :]).abs()
            + (y[:, None] - y[None, :]).abs()).to(torch.float32)


def swap_prepass(sym: torch.Tensor,
                 d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, diag): r[a] = sum_j S[a, j] D[a, j] and the diagonal of S (the
    CUDA kernel computes both itself, in the same launch)."""
    return (sym * d).sum(dim=1), torch.diagonal(sym)


def swap_deltas_ref(sym: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """sym: (K, K) f32 symmetric traffic; x, y: (K,) f32. Returns (K, K) f32."""
    sym = sym.to(torch.float32)
    d = distance_matrix(x, y)
    sd = sym @ d
    ds = d @ sym
    r, diag = swap_prepass(sym, d)
    return (sd + ds - r[:, None] - r[None, :]
            - (diag[:, None] + diag[None, :] - 2.0 * sym) * d)
