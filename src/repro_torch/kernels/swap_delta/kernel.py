"""Launch of the CUDA swap-delta kernel (``csrc/swap_deltas.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import swap_prepass

__all__ = ["swap_deltas_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0


def _fn():
    f = _build.load("swap_deltas").swap_deltas_launch
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def swap_deltas_cuda(sym: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """sym: (K, K) f32 symmetric traffic; x, y: (K,) f32 placed coords.

    Returns the (K, K) f32 delta matrix.  The O(K^2) r / diag pre-pass is
    plain PyTorch; the O(K^3) products and the epilogue are the kernel.
    """
    global launches
    k = sym.shape[0]
    _build.require(sym, "sym", torch.float32, (k, k))
    _build.require(x, "x", torch.float32, (k,), sym.device)
    _build.require(y, "y", torch.float32, (k,), sym.device)
    r, diag = swap_prepass(sym, x, y)
    out = torch.empty((k, k), dtype=torch.float32, device=sym.device)
    rc = _fn()(sym.data_ptr(), x.data_ptr(), y.data_ptr(), r.data_ptr(),
               diag.data_ptr(), out.data_ptr(), k,
               torch.cuda.current_stream(sym.device).cuda_stream)
    _build.check(rc, "swap_deltas")
    launches += 1
    return out
