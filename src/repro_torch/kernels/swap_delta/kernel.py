"""Launch of the CUDA swap-delta kernel (``csrc/swap_deltas.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["swap_deltas_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


def swap_deltas_cuda(sym: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """sym: (K, K) f32 traffic, which must be symmetric (C + C^T); x, y:
    (K,) f32 placed coordinates.

    Returns the (K, K) f32 delta matrix in one launch (r and the diagonal
    are summed inside the kernel).  The kernel computes only the tiles
    on and above the diagonal and mirrors them, so a non-symmetric ``sym``
    gives a wrong (but symmetric) result; the output is exactly symmetric.
    """
    global launches
    k = sym.shape[0]
    _build.require(sym, "sym", torch.float32, (k, k))
    _build.require(x, "x", torch.float32, (k,), sym.device)
    _build.require(y, "y", torch.float32, (k,), sym.device)
    out = torch.empty((k, k), dtype=torch.float32, device=sym.device)
    rc = _build.bind("swap_deltas", _ARGTYPES)(
        sym.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), k,
        torch.cuda.current_stream(sym.device).cuda_stream)
    _build.check(rc, "swap_deltas")
    launches += 1
    return out
