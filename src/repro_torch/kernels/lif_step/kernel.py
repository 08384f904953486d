"""Launch of the CUDA LIF step kernel (``csrc/lif_step.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["lif_step_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0


def _fn():
    f = _build.load("lif_step").lif_step_launch
    f.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def lif_step_cuda(
    v: torch.Tensor,
    refr: torch.Tensor,
    current: torch.Tensor,
    *,
    decay: float,
    threshold: float,
    v_reset: float,
    refractory: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v, current: (N,) f32; refr: (N,) i32, all on one card.
    Returns (v', refr', fired:bool)."""
    global launches
    n = v.shape[0]
    _build.require(v, "v", torch.float32, (n,))
    _build.require(refr, "refr", torch.int32, (n,), v.device)
    _build.require(current, "current", torch.float32, (n,), v.device)
    v_out = torch.empty_like(v)
    refr_out = torch.empty_like(refr)
    fired = torch.empty(n, dtype=torch.bool, device=v.device)
    rc = _fn()(v.data_ptr(), refr.data_ptr(), current.data_ptr(),
               v_out.data_ptr(), refr_out.data_ptr(), fired.data_ptr(), n,
               decay, threshold, v_reset, refractory,
               torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(rc, "lif_step")
    launches += 1
    return v_out, refr_out, fired
