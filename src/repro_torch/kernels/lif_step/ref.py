"""Plain PyTorch version of the LIF membrane-update step."""
from __future__ import annotations

import torch

__all__ = ["lif_step_ref"]


def lif_step_ref(
    v: torch.Tensor,
    refr: torch.Tensor,
    current: torch.Tensor,
    *,
    decay: float,
    threshold: float,
    v_reset: float,
    refractory: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LIF step over any shape. Returns (v', refr', fired:bool)."""
    active = refr <= 0
    v2 = torch.where(active, decay * v + current, v)
    fired = active & (v2 >= threshold)
    v_out = torch.where(fired, torch.full_like(v2, v_reset), v2)
    refr_out = torch.where(fired, torch.full_like(refr, refractory),
                           torch.clamp(refr - 1, min=0))
    return v_out, refr_out, fired
