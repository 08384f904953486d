"""Plain PyTorch version of the hop-cost reduction (paper Algorithm 1).

H_total = sum_{a,b} C[a,b] * (|x_a - x_b| + |y_a - y_b|)

where (x_i, y_i) is the mesh coordinate of the core partition i is placed
on.  The average hop is H_total / trace length (done by the caller: the
kernel's job is the O(K^2) contraction).
"""
from __future__ import annotations

import torch

__all__ = ["hop_cost_ref"]


def hop_cost_ref(traffic: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """traffic: (K, K); x, y: (K,) placed coordinates.  Returns a 0-d f32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dist = (x[:, None] - x[None, :]).abs() + (y[:, None] - y[None, :]).abs()
    return (traffic.to(torch.float32) * dist).sum()
