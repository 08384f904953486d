"""Public wrapper for the LIF step: the kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

import torch

from .kernel import lif_step_cuda
from .ref import lif_step_ref

__all__ = ["lif_step"]


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
    kw = dict(decay=float(decay), threshold=float(threshold),
              v_reset=float(v_reset), refractory=int(refractory))
    if v.device.type == "cuda":
        return lif_step_cuda(v, refr, current, **kw)
    if v.device.type == "cpu":
        return lif_step_ref(v, refr, current, **kw)
    raise ValueError(f"lif_step runs on cuda or cpu tensors, not {v.device}")
