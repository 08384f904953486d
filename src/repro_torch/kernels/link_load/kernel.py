"""Launch of the CUDA link-load kernel (``csrc/link_loads.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.nocsim.xy import link_count

from .. import _build

__all__ = ["link_loads_cuda", "launches"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0

# The per-window link histogram lives in (static-limit) shared memory.
_MAX_LINKS = 48 * 1024 // 4


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def link_loads_cuda(counts: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    mesh_w: int, mesh_h: int) -> torch.Tensor:
    """counts: (B, K, K) i32; x, y: (K,) i32 core coordinates on the mesh.

    Returns the (B, num_links) int32 loads in the ``xy`` link id layout.
    """
    global launches
    if link_count(mesh_w, mesh_h) > _MAX_LINKS:
        raise ValueError(f"a {mesh_w}x{mesh_h} mesh has more than {_MAX_LINKS} "
                         "links, the kernel's shared-memory histogram")
    b, k = counts.shape[0], counts.shape[1]
    _build.require(counts, "counts", torch.int32, (b, k, k))
    _build.require(x, "x", torch.int32, (k,), counts.device)
    _build.require(y, "y", torch.int32, (k,), counts.device)
    out = torch.empty((b, link_count(mesh_w, mesh_h)), dtype=torch.int32,
                      device=counts.device)
    rc = _build.bind("link_loads", _ARGTYPES)(
        counts.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), b, k,
        mesh_w, mesh_h, torch.cuda.current_stream(counts.device).cuda_stream)
    _build.check(rc, "link_loads")
    launches += 1
    return out
