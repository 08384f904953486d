"""Launch of the CUDA degree kernels: cut-mode partition degrees
(``csrc/part_degrees.cu``) and volume-mode connectivity degrees
(``csrc/connectivity_degrees.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["part_degrees_cuda", "connectivity_degrees_cuda", "launches",
           "connectivity_launches"]

# Launches since the last reset (set to 0 by callers that count a run), one
# counter per kernel: ``launches`` counts part_degrees,
# ``connectivity_launches`` counts connectivity_degrees.
launches = 0
connectivity_launches = 0

# The k-bin histogram lives in (static-limit) dynamic shared memory.
_MAX_K = 48 * 1024 // 4
# connectivity_degrees keeps C column sums and a 2048-entry (e, w) list in
# the same 48 KB: C * 4 + 2048 * 8 bytes.
_MAX_C = (48 * 1024 - 2048 * 8) // 4


def _fn():
    f = _build.load("part_degrees").part_degrees_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _conn_fn():
    f = _build.load("connectivity_degrees").connectivity_degrees_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _rows_or_all(rows: torch.Tensor | None, n: int,
                 device: torch.device) -> torch.Tensor:
    if rows is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    _build.require(rows, "rows", torch.int64, device=device)
    if rows.dim() != 1:
        raise ValueError(f"rows must be 1-D, got shape {tuple(rows.shape)}")
    return rows


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
    rows = _rows_or_all(rows, n, adj.device)
    out = torch.empty((rows.shape[0], k), dtype=torch.float32, device=adj.device)
    rc = _fn()(adj.data_ptr(), part.data_ptr(), rows.data_ptr(),
               out.data_ptr(), n, k, rows.shape[0],
               torch.cuda.current_stream(adj.device).cuda_stream)
    _build.check(rc, "part_degrees")
    launches += 1
    return out


def connectivity_degrees_cuda(inc: torch.Tensor, pres: torch.Tensor,
                              rows: torch.Tensor | None = None) -> torch.Tensor:
    """inc: (n, E) f32 incidence; pres: (E, C) f32 presence; rows: (R,) i64
    row ids in [0, n) or None (all rows).

    Returns the (R, C) f32 rows of ``inc @ pres``, equal to computing every
    row and indexing ``[rows]``.
    """
    global connectivity_launches
    if inc.dim() != 2 or pres.dim() != 2:
        raise ValueError("inc and pres must be 2-D")
    n, ne = inc.shape
    c = pres.shape[1]
    if not 0 < c <= _MAX_C:
        raise ValueError(f"{c} presence columns outside the kernel's range "
                         f"1..{_MAX_C}")
    _build.require(inc, "inc", torch.float32)
    _build.require(pres, "pres", torch.float32, (ne, c), inc.device)
    rows = _rows_or_all(rows, n, inc.device)
    out = torch.empty((rows.shape[0], c), dtype=torch.float32, device=inc.device)
    rc = _conn_fn()(inc.data_ptr(), pres.data_ptr(), rows.data_ptr(),
                    out.data_ptr(), ne, c, rows.shape[0],
                    torch.cuda.current_stream(inc.device).cuda_stream)
    _build.check(rc, "connectivity_degrees")
    connectivity_launches += 1
    return out
