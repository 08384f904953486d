"""Public wrapper for the hop-cost reduction: the kernel on CUDA, the plain
version on CPU."""
from __future__ import annotations

import torch

from .kernel import hop_cost_cuda
from .ref import hop_cost_ref

__all__ = ["hop_cost"]


def hop_cost(traffic: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Total hop-weighted traffic sum C[a, b] * manhattan(a, b), a 0-d f32.

    On CUDA the inputs are taken as f32 (traffic counts below 2**24 and
    mesh coordinates are exact there); the CPU computes the plain version.
    """
    if traffic.device.type == "cuda":
        return hop_cost_cuda(traffic.to(torch.float32).contiguous(),
                             x.to(torch.float32).contiguous(),
                             y.to(torch.float32).contiguous())
    if traffic.device.type == "cpu":
        return hop_cost_ref(traffic, x, y)
    raise ValueError(f"hop_cost runs on cuda or cpu tensors, not {traffic.device}")
