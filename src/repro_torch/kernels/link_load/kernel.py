"""Launch of the CUDA link-load kernel (``csrc/link_loads.cu``) and of the
replay's screen kernel (``csrc/replay_screen.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.nocsim.xy import link_count

from .. import _build
from .ref import MAX_CORES, dense_to_records

__all__ = ["MAX_RECORDS", "link_loads_cuda", "link_loads_records_cuda",
           "replay_screen_cuda", "launches", "screen_launches"]

# Launches since the last reset (set to 0 by callers that count a run):
# link_loads, and replay_screen.
launches = 0
screen_launches = 0

MAX_RECORDS = 2 ** 31 - 1  # the kernel's int32 record offsets
# The per-window link histogram lives in (static-limit) shared memory
# beside the kernel's 1 KB of per-warp scratch.
_MAX_LINKS = (48 * 1024 - 1024) // 4


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SCREEN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def link_loads_records_cuda(woff: torch.Tensor, rec: torch.Tensor,
                            count: torch.Tensor | None, x: torch.Tensor,
                            y: torch.Tensor, mesh_w: int,
                            mesh_h: int) -> torch.Tensor:
    """woff: (n_win + 1,) i32 window offsets into the window-sorted route
    records ``rec`` (n,) i32 (``pack_routes``); count: (n,) i32 packets a
    record, or None for one each; x, y: (K,) i32 core coordinates.

    Returns the (n_win, num_links) int32 loads in the ``xy`` link id layout,
    in one launch.
    """
    global launches
    if link_count(mesh_w, mesh_h) > _MAX_LINKS:
        raise ValueError(f"a {mesh_w}x{mesh_h} mesh has more than {_MAX_LINKS} "
                         "links, the kernel's shared-memory histogram")
    n, k, n_win = rec.shape[0], x.shape[0], woff.shape[0] - 1
    _build.require(rec, "rec", torch.int32, (n,))
    dev = rec.device
    _build.require(woff, "woff", torch.int32, (n_win + 1,), dev)
    if count is not None:
        _build.require(count, "count", torch.int32, (n,), dev)
    _build.require(x, "x", torch.int32, (k,), dev)
    _build.require(y, "y", torch.int32, (k,), dev)
    if n > MAX_RECORDS:
        raise ValueError(f"{n} records exceed the kernel's {MAX_RECORDS}")
    if k > MAX_CORES:
        raise ValueError(f"{k} cores exceed the record packing's {MAX_CORES}")
    out = torch.empty((n_win, link_count(mesh_w, mesh_h)), dtype=torch.int32,
                      device=dev)
    rc = _build.bind("link_loads", _ARGTYPES)(
        rec.data_ptr(), None if count is None else count.data_ptr(),
        woff.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), n_win, n,
        mesh_w, mesh_h, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "link_loads")
    launches += 1
    return out


def replay_screen_cuda(woff: torch.Tensor, rec: torch.Tensor,
                       inject: torch.Tensor, mesh_w: int, mesh_h: int,
                       link_capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """woff: (n_win + 1,) i32 window offsets into the window-sorted route
    records ``rec`` (n,) i32 of row-major cores; inject: (n,) i32 injection
    cycles, with ``inject + hops`` below 2**31.

    The replay's two tier-1 screens in one launch (``ref.replay_screen_ref``
    states them): returns the (n,) uint8 flags (``PAST``, ``STEPPED``) and
    the (num_links + 3,) int64 totals.
    """
    global screen_launches
    nl = link_count(mesh_w, mesh_h)
    if nl > _MAX_LINKS:
        raise ValueError(f"a {mesh_w}x{mesh_h} mesh has more than {_MAX_LINKS} "
                         "links, the kernel's shared-memory histogram")
    if mesh_w * mesh_h > MAX_CORES:
        raise ValueError(f"a {mesh_w}x{mesh_h} mesh exceeds {MAX_CORES} cores")
    if not 0 <= link_capacity < 2 ** 31:
        raise ValueError(f"link_capacity {link_capacity} is not a count")
    n, n_win = rec.shape[0], woff.shape[0] - 1
    _build.require(rec, "rec", torch.int32, (n,))
    dev = rec.device
    _build.require(woff, "woff", torch.int32, (n_win + 1,), dev)
    _build.require(inject, "inject", torch.int32, (n,), dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    totals = torch.empty(nl + 3, dtype=torch.int64, device=dev)
    rc = _build.bind("replay_screen", _SCREEN_ARGTYPES)(
        woff.data_ptr(), rec.data_ptr(), inject.data_ptr(), flags.data_ptr(),
        totals.data_ptr(), n_win, mesh_w, mesh_h, link_capacity,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "replay_screen")
    screen_launches += 1
    return flags, totals


def link_loads_cuda(counts: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    mesh_w: int, mesh_h: int) -> torch.Tensor:
    """counts: (B, K, K) i32; x, y: (K,) i32 core coordinates on the mesh.

    The non-zero counts become weighted records on the card, which the
    record kernel histograms.  Returns the (B, num_links) int32 loads.
    """
    b, k = counts.shape[0], counts.shape[1]
    _build.require(counts, "counts", torch.int32, (b, k, k))
    _build.require(x, "x", torch.int32, (k,), counts.device)
    _build.require(y, "y", torch.int32, (k,), counts.device)
    woff, rec, cnt = dense_to_records(counts)
    return link_loads_records_cuda(woff, rec, cnt, x, y, mesh_w, mesh_h)
