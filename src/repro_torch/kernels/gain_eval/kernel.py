"""Launch of the CUDA kernels of the vec refiner: cut-mode partition degrees
(``csrc/part_degrees.cu``), volume-mode degree rows from the sparse
incidence and the live Φ table (``csrc/connectivity_degrees.cu``), and the
volume batch's conflict-free mover selection (``csrc/volume_select.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["part_degrees_cuda", "volume_degree_rows_cuda", "volume_select_cuda",
           "SelectSlots", "launches", "connectivity_launches",
           "select_launches"]

# Launches since the last reset (set to 0 by callers that count a run), one
# counter per kernel: ``launches`` counts part_degrees,
# ``connectivity_launches`` counts connectivity_degrees (volume_degree_rows),
# ``select_launches`` counts volume_select.
launches = 0
connectivity_launches = 0
select_launches = 0

# The k-bin histogram lives in (static-limit) dynamic shared memory.
_MAX_K = 48 * 1024 // 4

_PART_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_CONN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_SELECT_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# The selection's per-call counters: the contended keys and the candidates
# live at the start of each round (the kernel takes rounds < 256).
_SELECT_COUNTERS = 256


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


class SelectSlots:
    """The selection kernel's slot state for one (E, k) Φ table, on the
    card and zero at rest: per slot a packed toucher/leaver count and a
    stamped priority maximum (int64 each) and the call stamps of the
    contended and used flags (int32 each), then the per-call counters.
    One allocation a table; each call leaves it as it found it (the
    counts zeroed at the call's own keys, the stamps outdated by the next
    call's), so calls share it without a pass over all slots.  ``calls``
    numbers the calls made on it."""

    def __init__(self, slots: int, device: torch.device):
        self.slots = int(slots)
        self.buf = torch.zeros(3 * self.slots + _SELECT_COUNTERS // 2,
                               dtype=torch.int64, device=device)
        self.calls = 0

    def pointers(self) -> tuple[int, int, int, int, int]:
        """Addresses of the counts, ranks, used and contended stamps and
        the per-call counters."""
        base, n = self.buf.data_ptr(), self.slots
        return base, base + 8 * n, base + 16 * n, base + 20 * n, base + 24 * n


def volume_select_cuda(vxadj: torch.Tensor, vedges: torch.Tensor,
                       phi: torch.Tensor, cand: torch.Tensor,
                       own: torch.Tensor, target: torch.Tensor,
                       pri: torch.Tensor, rounds: int,
                       slots: SelectSlots) -> torch.Tensor:
    """vxadj: (n + 1,) i32 and vedges: (nnz,) i32, the vertex -> hyperedge
    CSR; phi: (E, k) i32 member counts; cand, own, target, pri: (C,) i32
    the candidates' vertices, own and target columns and distinct positive
    priorities; ``rounds`` Luby rounds at most; ``slots`` the table's slot
    state, kept across the calls on that table.

    Returns (8 + C,) uint8: the contended key count and the rounds run as
    two int32, then 1 for each chosen candidate (see ``volume_select_ref``).
    """
    global select_launches
    dev = vxadj.device
    _build.require(vxadj, "vxadj", torch.int32)
    if vxadj.dim() != 1 or phi.dim() != 2:
        raise ValueError("vxadj must be 1-D and phi 2-D")
    _build.require(vedges, "vedges", torch.int32, device=dev)
    _build.require(phi, "phi", torch.int32, device=dev)
    _build.require(cand, "cand", torch.int32, device=dev)
    if cand.dim() != 1:
        raise ValueError(f"cand must be 1-D, got shape {tuple(cand.shape)}")
    for name, t in (("own", own), ("target", target), ("pri", pri)):
        _build.require(t, name, torch.int32, tuple(cand.shape), dev)
    if not 0 <= rounds < _SELECT_COUNTERS:
        raise ValueError(f"rounds={rounds} outside 0..{_SELECT_COUNTERS - 1}")
    if (not isinstance(slots, SelectSlots) or slots.slots != phi.numel()
            or slots.buf.device != dev):
        raise ValueError("slots must be the SelectSlots of this Φ table")
    slots.calls += 1
    out = torch.empty(8 + cand.shape[0], dtype=torch.uint8, device=dev)
    rc = _build.bind("volume_select", _SELECT_ARGTYPES)(
        vxadj.data_ptr(), vedges.data_ptr(), phi.data_ptr(), cand.data_ptr(),
        own.data_ptr(), target.data_ptr(), pri.data_ptr(), *slots.pointers(),
        out.data_ptr(), cand.shape[0], phi.shape[1], slots.calls, rounds,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "volume_select")
    select_launches += 1
    return out
