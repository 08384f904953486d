"""Leaky integrate-and-fire dynamics, vectorized over neurons, stepped in time.

The event-driven loop of CARLsim becomes a dense time-stepped loop over a
(T, N) spike raster.  Each step sums, for every neuron, the weights of the
synapses whose source fired the step before — in ascending source order,
the order the reference's f32 product ``last_spikes @ weights`` sums in —
adds the external drive and applies the membrane update (decay +
integrate + threshold + reset).  The synapses are the non-zeros of the
weight matrix in the destination-major ELL layout of
``repro_torch.kernels.lif_step.Synapses``; on the card each step is one
launch of the fused CUDA kernel, on the CPU its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.lif_step import Synapses, lif_steps, synapses_from_dense

__all__ = ["LIFParams", "lif_run", "lif_run_synapses"]


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
      (T, N) uint8 spike raster (host numpy).
    """
    return lif_run_synapses(synapses_from_dense(weights), input_drive, params)


def lif_run_synapses(
    syn: Synapses,
    input_drive: torch.Tensor,
    params: LIFParams,
) -> np.ndarray:
    """``lif_run`` on the population's synapse list, on the device of
    ``input_drive`` (where ``syn`` must lie too).  The raster stays on the
    device during the run and is copied to the host once at the end."""
    raster, _, _ = lif_steps(
        syn, input_drive, decay=params.decay, threshold=params.threshold,
        v_reset=params.v_reset, refractory=params.refractory)
    return raster.cpu().numpy()
