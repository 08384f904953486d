"""Launch of the CUDA hop-cost reduction (``csrc/hop_cost.cu``)."""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["hop_cost_cuda", "launches", "grid_blocks"]

# Launches since the last reset (set to 0 by callers that count a run).
launches = 0

THREADS = 256
BLOCKS_PER_SM = 4  # 1,024 resident threads an SM, 32 KB of loads in flight
MAX_K = 65_535  # K * K must fit the kernel's 32-bit flat index

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# One zeroed ticket a (card, stream): the kernel's last block resets it, so
# it is allocated once and never cleared by the host.
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_sm_count: dict[int, int] = {}


def grid_blocks(k: int, sm_count: int) -> int:
    """Blocks of one launch at K: enough to fill the card (BLOCKS_PER_SM an
    SM), fewer where the K * K traffic gives each thread less than one
    float4 vector (at K = 141, 20 blocks: one round of loads, which
    `tools/probe_hop_cost.py` measured faster than fewer blocks)."""
    vectors = k * k // 4
    return max(1, min(sm_count * BLOCKS_PER_SM, -(-vectors // THREADS)))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def hop_cost_cuda(traffic: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """traffic: (K, K) f32; x, y: (K,) f32 placed coordinates, on one card.

    Returns the total hop cost as a 0-d f32 tensor on the card, in one
    launch; the fixed-order reduction makes repeated calls bitwise equal.
    """
    global launches
    k = traffic.shape[0]
    _build.require(traffic, "traffic", torch.float32, (k, k))
    _build.require(x, "x", torch.float32, (k,), traffic.device)
    _build.require(y, "y", torch.float32, (k,), traffic.device)
    if k > MAX_K:
        raise ValueError(f"hop_cost takes K <= {MAX_K}, got {k}")
    dev = traffic.device
    if k == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    blocks = grid_blocks(k, _sm_count[index])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = _tickets.get((index, stream))
    if ticket is None:
        ticket = _tickets[(index, stream)] = torch.zeros(1, dtype=torch.int32,
                                                          device=dev)
    partials = torch.empty(blocks, dtype=torch.float64, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    head = (-(traffic.data_ptr() % 16) // 4) % 4  # elements before 16 B
    row_vectors = k % 4 == 0 and head == 0 and _aligned(x) and _aligned(y)
    rc = _build.bind("hop_cost", _ARGTYPES)(
        traffic.data_ptr(), x.data_ptr(), y.data_ptr(), partials.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), k, head, int(row_vectors), blocks,
        stream)
    _build.check(rc, "hop_cost")
    launches += 1
    return out[0]
