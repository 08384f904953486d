"""Public wrapper: batched SA swap-delta evaluation, the kernel on CUDA,
the plain version on CPU."""
from __future__ import annotations

import torch

from .kernel import swap_deltas_cuda
from .ref import swap_deltas_ref

__all__ = ["swap_deltas", "swap_deltas_pairs"]


def swap_deltas(sym: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """(K, K) matrix of hop-cost deltas for swapping partitions a and b.

    `sym` must be the symmetrized traffic C + C^T (zero-padded to the core
    count if virtual partitions are in play).
    """
    if sym.device.type == "cuda":
        return swap_deltas_cuda(sym, x, y)
    if sym.device.type == "cpu":
        return swap_deltas_ref(sym, x, y)
    raise ValueError(f"swap_deltas runs on cuda or cpu tensors, not {sym.device}")


def swap_deltas_pairs(sym: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      aa: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """Deltas of the B candidate pairs ``(aa[i], bb[i])``, gathered from the
    all-pairs batch on the tensors' device."""
    return swap_deltas(sym, x, y)[aa, bb]
