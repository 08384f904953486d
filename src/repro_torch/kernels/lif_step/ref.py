"""Plain PyTorch versions of the LIF step and of the fused T-step run."""
from __future__ import annotations

import torch

__all__ = ["lif_step_ref", "lif_steps_ref"]


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


def lif_steps_ref(
    syn_src: torch.Tensor,
    syn_w: torch.Tensor,
    syn_deg: torch.Tensor,
    drive: torch.Tensor,
    *,
    decay: float,
    threshold: float,
    v_reset: float,
    refractory: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T steps from rest of the ELL population (see ``lif_steps_cuda``):
    each step gathers ``w`` of the sources that fired the step before,
    sums the ELL columns left to right — each destination's current in
    ascending source order, the order the kernel and the reference's
    product sum in (masked entries add an exact +0) — adds the drive and
    applies ``lif_step_ref``.  Returns (raster (T, N) uint8, v, refr)."""
    steps, n = drive.shape
    width = syn_src.shape[0]
    dev = drive.device
    live = (torch.arange(width, device=dev)[:, None]
            < syn_deg.to(torch.int64)[None, :])
    src = syn_src.to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    refr = torch.zeros(n, dtype=torch.int32, device=dev)
    fired = torch.zeros(n, dtype=torch.bool, device=dev)
    raster = torch.empty((steps, n), dtype=torch.uint8, device=dev)
    for t in range(steps):
        g = torch.where(live & fired[src], syn_w, zero)
        cur = torch.zeros(n, dtype=torch.float32, device=dev)
        for c in range(width):
            cur = cur + g[c]
        v, refr, fired = lif_step_ref(
            v, refr, cur + drive[t], decay=decay, threshold=threshold,
            v_reset=v_reset, refractory=refractory)
        raster[t] = fired
    return raster, v, refr
