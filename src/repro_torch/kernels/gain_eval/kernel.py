"""Launch of the CUDA partition-degree kernel (``csrc/part_degrees.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["part_degrees_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0

# The k-bin histogram lives in (static-limit) dynamic shared memory.
_MAX_K = 48 * 1024 // 4


def _fn():
    f = _build.load("part_degrees").part_degrees_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def part_degrees_cuda(adj: torch.Tensor, part: torch.Tensor, k: int,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """adj: (n, n) f32; part: (n,) i32; rows: (R,) i64 or None (all rows).

    Returns the (R, k) f32 degree rows, equal to computing every row and
    indexing ``[rows]``.
    """
    global launches
    n = adj.shape[0]
    if not 0 < k <= _MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{_MAX_K}")
    _build.require(adj, "adj", torch.float32, (n, n))
    _build.require(part, "part", torch.int32, (n,), adj.device)
    if rows is None:
        rows = torch.arange(n, dtype=torch.int64, device=adj.device)
    _build.require(rows, "rows", torch.int64, device=adj.device)
    if rows.dim() != 1:
        raise ValueError(f"rows must be 1-D, got shape {tuple(rows.shape)}")
    out = torch.empty((rows.shape[0], k), dtype=torch.float32, device=adj.device)
    rc = _fn()(adj.data_ptr(), part.data_ptr(), rows.data_ptr(),
               out.data_ptr(), n, k, rows.shape[0],
               torch.cuda.current_stream(adj.device).cuda_stream)
    _build.check(rc, "part_degrees")
    launches += 1
    return out
