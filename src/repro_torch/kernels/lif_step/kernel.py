"""Launch of the CUDA LIF step kernel (``csrc/lif_step.cu``).

One kernel serves both entry points: ``lif_steps_cuda`` runs a population
for T steps with the synaptic product fused into the step (one launch a
step, state updated in place), and ``lif_step_cuda`` is the same kernel
with no synapses, stepping on a given current.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["lif_step_cuda", "lif_steps_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0


_ARGTYPES = [ctypes.c_void_p] * 10 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


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
    rc = _build.bind("lif_step", _ARGTYPES)(
        None, None, None, None, current.data_ptr(), v.data_ptr(),
        refr.data_ptr(), v_out.data_ptr(), refr_out.data_ptr(),
        fired.data_ptr(), n, 0, decay, threshold, v_reset, refractory,
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(rc, "lif_step")
    launches += 1
    return v_out, refr_out, fired


def lif_steps_cuda(
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
    """T steps from rest (v = 0, refr = 0) of a population whose synapses
    are the destination-major ELL ``syn_src``/``syn_w`` (width, N) with
    ``syn_deg`` (N,) entries each; ``drive`` is (T, N) f32.  One launch a
    step.  Returns (raster (T, N) uint8, v, refr) on the card."""
    global launches
    steps, n = drive.shape
    width = syn_src.shape[0]
    _build.require(drive, "drive", torch.float32, (steps, n))
    dev = drive.device
    _build.require(syn_src, "syn_src", torch.int32, (width, n), dev)
    _build.require(syn_w, "syn_w", torch.float32, (width, n), dev)
    _build.require(syn_deg, "syn_deg", torch.int32, (n,), dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    refr = torch.zeros(n, dtype=torch.int32, device=dev)
    raster = torch.empty((steps, n), dtype=torch.uint8, device=dev)
    # The loop is the profile's host cost per step: the launch function
    # is bound once and each step passes only pointers.
    launch = _build.bind("lif_step", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fixed = (syn_src.data_ptr(), syn_w.data_ptr(), syn_deg.data_ptr())
    v_p, refr_p = v.data_ptr(), refr.data_ptr()
    drive_p, raster_p = drive.data_ptr(), raster.data_ptr()
    for t in range(steps):
        rc = launch(*fixed, raster_p + (t - 1) * n if t else None,
                    drive_p + 4 * t * n, v_p, refr_p, v_p, refr_p,
                    raster_p + t * n, n, width, decay, threshold, v_reset,
                    refractory, stream)
        _build.check(rc, "lif_step")
        launches += 1
    return raster, v, refr
