"""Public wrappers: per-window link loads for the NoC replay's screen.

``window_link_loads`` is the replay's hot-path entry point: it turns a
batch of per-window core-to-core count matrices into flat per-link load
vectors (the ``repro_torch.nocsim.xy`` directed-link id layout), which the
batched queued engine uses to screen contention-free windows without any
cycle stepping.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nocsim.xy import link_count

from .kernel import link_loads_cuda
from .ref import link_loads_ref

__all__ = ["link_loads", "window_link_loads"]


def link_loads(counts: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mesh_w: int, mesh_h: int) -> torch.Tensor:
    """(B, num_links) int32 XY loads of (B, K, K) counts; the kernel on
    CUDA, the plain version on CPU."""
    if counts.device.type == "cuda":
        return link_loads_cuda(counts, x, y, mesh_w, mesh_h)
    if counts.device.type == "cpu":
        return link_loads_ref(counts, x, y, mesh_w, mesh_h)
    raise ValueError(f"link_loads runs on cuda or cpu tensors, not {counts.device}")


def window_link_loads(
    traffic: np.ndarray,
    mesh_w: int,
    mesh_h: int,
    device: "str | torch.device" = "cuda",
    chunk: int = 256,
) -> np.ndarray:
    """Per-window flat link loads from (B, K, K) core-to-core traffic.

    K must equal ``mesh_w * mesh_h`` (each matrix row/col is a mesh core in
    row-major coordinates).  Returns an int64 (B, num_links) array in the
    ``xy`` link id layout, computed on ``device`` ``chunk`` windows at a
    time to bound device memory.
    """
    dev = resolve_device(device)
    k = mesh_w * mesh_h
    if traffic.shape[-2:] != (k, k):
        raise ValueError(f"traffic must be (B, {k}, {k}), got {traffic.shape}")
    if traffic.size and int(traffic.max()) > np.iinfo(np.int32).max:
        raise OverflowError("per-window counts exceed int32")
    cores = torch.arange(k, dtype=torch.int32, device=dev)
    x = cores % mesh_w
    y = cores // mesh_w
    out = []
    for lo in range(0, traffic.shape[0], chunk):
        batch = torch.from_numpy(
            np.ascontiguousarray(traffic[lo:lo + chunk], dtype=np.int32)).to(dev)
        out.append(link_loads(batch, x, y, mesh_w, mesh_h).cpu().numpy())
    if not out:
        return np.empty((0, link_count(mesh_w, mesh_h)), dtype=np.int64)
    return np.concatenate(out).astype(np.int64)
