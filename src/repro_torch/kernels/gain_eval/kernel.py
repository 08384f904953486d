"""Launch of the CUDA degree kernels: cut-mode partition degrees
(``csrc/part_degrees.cu``) and volume-mode degree rows from the sparse
incidence and the live Φ table (``csrc/connectivity_degrees.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["part_degrees_cuda", "volume_degree_rows_cuda", "launches",
           "connectivity_launches"]

# Launches since the last reset (set to 0 by callers that count a run), one
# counter per kernel: ``launches`` counts part_degrees,
# ``connectivity_launches`` counts connectivity_degrees (volume_degree_rows).
launches = 0
connectivity_launches = 0

# The k-bin histogram lives in (static-limit) dynamic shared memory.
_MAX_K = 48 * 1024 // 4

_PART_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CONN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


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
    rc = _build.bind("part_degrees", _PART_ARGTYPES)(
        adj.data_ptr(), part.data_ptr(), rows.data_ptr(), out.data_ptr(), n, k,
        rows.shape[0], torch.cuda.current_stream(adj.device).cuda_stream)
    _build.check(rc, "part_degrees")
    launches += 1
    return out


def volume_degree_rows_cuda(vxadj: torch.Tensor, vedges: torch.Tensor,
                            w: torch.Tensor, phi: torch.Tensor,
                            rows: torch.Tensor | None,
                            own: torch.Tensor) -> torch.Tensor:
    """vxadj: (n + 1,) i32 and vedges: (nnz,) i32, the vertex -> hyperedge
    CSR; w: (nnz,) f32 the weight of each entry (hfire of its hyperedge);
    phi: (E, k) i32 member counts; rows: (R,) i64 vertex ids or None (all
    n); own: (R,) i64 the partition of each row vertex.

    Returns the (R, k) f32 rows D*[r, c] = sum of w over the row's entries
    e with phi[e, c] > (c == own[r]).
    """
    global connectivity_launches
    dev = vxadj.device
    _build.require(vxadj, "vxadj", torch.int32)
    if vxadj.dim() != 1 or phi.dim() != 2:
        raise ValueError("vxadj must be 1-D and phi 2-D")
    _build.require(vedges, "vedges", torch.int32, device=dev)
    _build.require(w, "w", torch.float32, tuple(vedges.shape), dev)
    _build.require(phi, "phi", torch.int32, device=dev)
    rows = _rows_or_all(rows, vxadj.shape[0] - 1, dev)
    _build.require(own, "own", torch.int64, tuple(rows.shape), dev)
    k = phi.shape[1]
    out = torch.empty((rows.shape[0], k), dtype=torch.float32, device=dev)
    rc = _build.bind("connectivity_degrees", _CONN_ARGTYPES)(
        vxadj.data_ptr(), vedges.data_ptr(), w.data_ptr(), phi.data_ptr(),
        rows.data_ptr(), own.data_ptr(), out.data_ptr(), k, rows.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "connectivity_degrees")
    connectivity_launches += 1
    return out
