"""Launch of the CUDA hop-cost reduction (``csrc/hop_cost.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["hop_cost_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0

# Traffic rows per stage-1 block: K = 4096 gives 512 blocks of 256 threads,
# each thread summing 8 x 16 products.
ROWS_PER_BLOCK = 8


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def hop_cost_cuda(traffic: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """traffic: (K, K) f32; x, y: (K,) f32 placed coordinates, on one card.

    Returns the total hop cost as a 0-d f32 tensor on the card; the
    fixed-order two-stage reduction makes repeated calls bitwise equal.
    """
    global launches
    k = traffic.shape[0]
    _build.require(traffic, "traffic", torch.float32, (k, k))
    _build.require(x, "x", torch.float32, (k,), traffic.device)
    _build.require(y, "y", torch.float32, (k,), traffic.device)
    out = torch.zeros(1, dtype=torch.float32, device=traffic.device)
    if k == 0:
        return out[0]
    blocks = -(-k // ROWS_PER_BLOCK)
    partials = torch.empty(blocks, dtype=torch.float64, device=traffic.device)
    rc = _build.bind("hop_cost", _ARGTYPES)(
        traffic.data_ptr(), x.data_ptr(), y.data_ptr(), partials.data_ptr(),
        out.data_ptr(), k, ROWS_PER_BLOCK,
        torch.cuda.current_stream(traffic.device).cuda_stream)
    _build.check(rc, "hop_cost")
    launches += 1
    return out[0]
