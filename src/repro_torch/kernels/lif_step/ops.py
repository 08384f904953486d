"""Public wrappers for the LIF step: the kernel on CUDA, the plain version
on CPU, and the synapse layout the fused run takes."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .kernel import lif_step_cuda, lif_steps_cuda
from .ref import lif_step_ref, lif_steps_ref

__all__ = ["Synapses", "lif_step", "lif_steps", "synapses_from_dense"]


@dataclass(frozen=True)
class Synapses:
    """A population's non-zero weights, destination-major ELL.

    Entry c of destination i is ``src[c, i] -> i`` with weight ``w[c, i]``,
    valid for ``c < deg[i]``, sources ascending in c; padding holds source
    0 and weight 0.  ``src``/``w`` are (width, N) int32/f32 with width the
    largest in-degree, ``deg`` is (N,) int32.
    """

    src: torch.Tensor
    w: torch.Tensor
    deg: torch.Tensor

    def to(self, device: torch.device) -> "Synapses":
        """A copy on ``device``; host-to-card copies go through pinned
        memory."""
        if torch.device(device).type != "cuda":
            return Synapses(*(t.to(device) for t in (self.src, self.w, self.deg)))
        return Synapses(*(t.pin_memory().to(device, non_blocking=True)
                          for t in (self.src, self.w, self.deg)))


def synapses_from_dense(weights: torch.Tensor) -> Synapses:
    """The ELL of the non-zeros of an (N, N) matrix (weights[i, j] =
    strength i -> j), built where ``weights`` lies: exactly the entries the
    dense product ``spikes @ weights`` adds that can differ from zero."""
    n = weights.shape[0]
    dev = weights.device
    src, dst = torch.nonzero(weights, as_tuple=True)  # row-major: src ascending
    order = torch.sort(dst, stable=True).indices  # destination-major, src kept
    src, dst = src[order], dst[order]
    deg = torch.bincount(dst, minlength=n)
    width = int(deg.max()) if n else 0
    slot = torch.arange(dst.shape[0], device=dev) - (torch.cumsum(deg, 0) - deg)[dst]
    ell_src = torch.zeros((width, n), dtype=torch.int32, device=dev)
    ell_w = torch.zeros((width, n), dtype=torch.float32, device=dev)
    ell_src[slot, dst] = src.to(torch.int32)
    ell_w[slot, dst] = weights[src, dst].to(torch.float32)
    return Synapses(ell_src, ell_w, deg.to(torch.int32))


def _params(decay, threshold, v_reset, refractory) -> dict:
    return dict(decay=float(decay), threshold=float(threshold),
                v_reset=float(v_reset), refractory=int(refractory))


def lif_step(
    v: torch.Tensor,
    refr: torch.Tensor,
    current: torch.Tensor,
    *,
    decay: float,
    threshold: float,
    v_reset: float,
    refractory: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    kw = _params(decay, threshold, v_reset, refractory)
    if v.device.type == "cuda":
        return lif_step_cuda(v, refr, current, **kw)
    if v.device.type == "cpu":
        return lif_step_ref(v, refr, current, **kw)
    raise ValueError(f"lif_step runs on cuda or cpu tensors, not {v.device}")


def lif_steps(
    syn: Synapses,
    drive: torch.Tensor,
    *,
    decay: float,
    threshold: float,
    v_reset: float,
    refractory: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T steps from rest, the synaptic product fused into each step:
    (raster (T, N) uint8, v, refr) where ``drive`` (T, N) lies."""
    kw = _params(decay, threshold, v_reset, refractory)
    if drive.device.type == "cuda":
        return lif_steps_cuda(syn.src, syn.w, syn.deg, drive, **kw)
    if drive.device.type == "cpu":
        return lif_steps_ref(syn.src, syn.w, syn.deg, drive, **kw)
    raise ValueError(f"lif_steps runs on cuda or cpu tensors, not {drive.device}")
