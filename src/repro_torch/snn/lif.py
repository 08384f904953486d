"""Leaky integrate-and-fire dynamics, vectorized over neurons, stepped in time.

The event-driven loop of CARLsim becomes a dense time-stepped loop over a
(T, N) spike raster.  Each step is one f32 synaptic product
``last_spikes @ weights`` (``torch.matmul``, outside any kernel, as the
reference leaves it to XLA) followed by the membrane update (decay +
integrate + threshold + reset) through ``repro_torch.kernels.lif_step``:
the CUDA kernel for tensors on the card, its plain version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.lif_step import lif_step

__all__ = ["LIFParams", "lif_run"]


@dataclass(frozen=True)
class LIFParams:
    """Discrete-time LIF constants (per-network, scalar-broadcast)."""

    decay: float = 0.9  # membrane leak multiplier per step: v <- decay * v
    threshold: float = 1.0  # fire when v >= threshold
    v_reset: float = 0.0  # post-spike reset potential
    refractory: int = 1  # steps a neuron stays silent after firing


def lif_run(
    weights: torch.Tensor,
    input_drive: torch.Tensor,
    params: LIFParams,
) -> np.ndarray:
    """Run T steps of a recurrently-connected LIF population.

    Args:
      weights: (N, N) f32 synaptic matrix; weights[i, j] = strength i -> j.
      input_drive: (T, N) f32 external input current per step, on the
        same device as ``weights`` (the run executes there).
      params: LIF constants.

    Returns:
      (T, N) uint8 spike raster (host numpy).  The raster stays on the
      device during the run and is copied to the host once at the end.
    """
    n = weights.shape[0]
    dev = weights.device
    steps = input_drive.shape[0]
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    refr = torch.zeros(n, dtype=torch.int32, device=dev)
    spikes = torch.zeros(n, dtype=torch.float32, device=dev)
    raster = torch.empty((steps, n), dtype=torch.uint8, device=dev)
    for t in range(steps):
        # Spikes from step t-1 arrive as current at step t (1-step synapse delay).
        syn_current = spikes @ weights
        v, refr, fired = lif_step(
            v, refr, syn_current + input_drive[t],
            decay=params.decay, threshold=params.threshold,
            v_reset=params.v_reset, refractory=params.refractory,
        )
        raster[t] = fired
        spikes = fired.to(torch.float32)
    return raster.cpu().numpy()
