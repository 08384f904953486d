"""Public wrappers: per-window link loads for the NoC replay's screen.

``record_link_loads`` is the replay's hot-path entry point: it turns the
replay's window-sorted packets (window, src core, dst core) into flat
per-link load vectors (the ``repro_torch.nocsim.xy`` directed-link id
layout), which the batched queued engine uses to screen contention-free
windows without any cycle stepping.  ``window_link_loads`` computes the
same from dense per-window (K, K) core-to-core count matrices.
``record_replay_screen`` runs the unicast replay's two tier-1 screens over
the same packets on the card, in one pass a window, and hands back which
packets the joint stepper steps.
``edge_variance`` is the paper's Eq. 4-5 over one traffic matrix, and
``flatten_link_maps`` lays (E, W, S, N) load maps out as flat link ids.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.device import resolve_device
from repro_torch.nocsim.xy import link_count

from .kernel import (MAX_RECORDS, link_loads_cuda, link_loads_records_cuda,
                     replay_screen_cuda)
from .ref import (MAX_CORES, link_loads_records_ref, link_loads_ref,
                  replay_screen_ref)

__all__ = ["edge_variance", "flatten_link_maps", "link_loads",
           "link_loads_records", "record_link_loads", "record_replay_screen",
           "replay_screen", "window_link_loads"]


def link_loads(counts: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mesh_w: int, mesh_h: int) -> torch.Tensor:
    """(B, num_links) int32 XY loads of (B, K, K) counts; the kernel on
    CUDA, the plain version on CPU."""
    if counts.device.type == "cuda":
        return link_loads_cuda(counts, x, y, mesh_w, mesh_h)
    if counts.device.type == "cpu":
        return link_loads_ref(counts, x, y, mesh_w, mesh_h)
    raise ValueError(f"link_loads runs on cuda or cpu tensors, not {counts.device}")


def link_loads_records(woff: torch.Tensor, rec: torch.Tensor,
                       count: torch.Tensor | None, x: torch.Tensor,
                       y: torch.Tensor, mesh_w: int,
                       mesh_h: int) -> torch.Tensor:
    """(n_win, num_links) int32 XY loads of window-sorted route records;
    the kernel on CUDA, the plain version on CPU."""
    if rec.device.type == "cuda":
        return link_loads_records_cuda(woff, rec, count, x, y, mesh_w, mesh_h)
    if rec.device.type == "cpu":
        return link_loads_records_ref(woff, rec, count, x, y, mesh_w, mesh_h)
    raise ValueError(f"link_loads_records runs on cuda or cpu tensors, not {rec.device}")


def replay_screen(woff: torch.Tensor, rec: torch.Tensor, inject: torch.Tensor,
                  mesh_w: int, mesh_h: int,
                  link_capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The replay's tier-1 screens over window-sorted route records: (n,)
    uint8 flags and (num_links + 3,) int64 totals; the kernel on CUDA, the
    plain version on CPU."""
    if rec.device.type == "cuda":
        return replay_screen_cuda(woff, rec, inject, mesh_w, mesh_h,
                                  link_capacity)
    if rec.device.type == "cpu":
        return replay_screen_ref(woff, rec, inject, mesh_w, mesh_h,
                                 link_capacity)
    raise ValueError(f"replay_screen runs on cuda or cpu tensors, not {rec.device}")


def _mesh_coords(mesh_w: int, mesh_h: int, dev: torch.device):
    cores = torch.arange(mesh_w * mesh_h, dtype=torch.int32, device=dev)
    return cores % mesh_w, cores // mesh_w


def _upload_packets(win: np.ndarray, src_core: np.ndarray,
                    dst_core: np.ndarray, n_win: int, mesh_w: int, mesh_h: int,
                    dev: torch.device, *rows: np.ndarray) -> list[torch.Tensor]:
    """Window-sorted packets on ``dev``: their window offsets (n_win + 1,),
    route records ``(src << 16) | dst`` (n,) and each of ``rows`` (n,), all
    int32, sent up as one pinned buffer in a single copy.  Raises where the
    windows are not sorted ids below ``n_win`` or the sizes exceed the
    record layout."""
    n = int(win.shape[0])
    if n > MAX_RECORDS:
        raise ValueError(f"{n} packets exceed the kernel's {MAX_RECORDS}")
    if mesh_w * mesh_h > MAX_CORES:
        raise ValueError(f"a {mesh_w}x{mesh_h} mesh exceeds {MAX_CORES} cores")
    if n and (np.any(win[1:] < win[:-1]) or win[0] < 0 or win[-1] >= n_win):
        raise ValueError(f"packet windows must be sorted ids in [0, {n_win})")
    buf = torch.empty(n_win + 1 + n * (1 + len(rows)), dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    host = buf.numpy()
    host[:n_win + 1] = np.searchsorted(win, np.arange(n_win + 1))
    rec = host[n_win + 1:n_win + 1 + n]
    np.left_shift(src_core, 16, out=rec, casting="unsafe")
    np.bitwise_or(rec, dst_core, out=rec, casting="unsafe")
    for i, row in enumerate(rows, start=1):
        host[n_win + 1 + i * n:n_win + 1 + (i + 1) * n] = row
    buf = buf.to(dev, non_blocking=True)
    return list(buf.split([n_win + 1] + [n] * (1 + len(rows))))


def record_link_loads(
    win: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    n_win: int,
    mesh_w: int,
    mesh_h: int,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """Per-window flat link loads of packets (win, src core, dst core).

    ``win`` must be sorted (ascending window ids below ``n_win``); cores are
    row-major mesh coordinates.  Returns an int64 (n_win, num_links) array
    in the ``xy`` link id layout.  On the card the packets go up once, as
    one pinned buffer of window offsets and 4-byte route records, and one
    kernel launch histograms every window.
    """
    dev = resolve_device(device)
    woff, rec = _upload_packets(win, src_core, dst_core, n_win, mesh_w,
                                mesh_h, dev)
    spans.add(link_load_calls=1, link_load_records=int(rec.shape[0]),
              link_load_windows=n_win)
    x, y = _mesh_coords(mesh_w, mesh_h, dev)
    loads = link_loads_records(woff, rec, None, x, y, mesh_w, mesh_h)
    return loads.cpu().numpy().astype(np.int64)


def record_replay_screen(
    win: np.ndarray,
    src_core: np.ndarray,
    dst_core: np.ndarray,
    inject: np.ndarray,
    n_win: int,
    mesh_w: int,
    mesh_h: int,
    link_capacity: int,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray, dict]:
    """The unicast replay's two tier-1 screens over packets (win, src core,
    dst core) injected at cycles ``inject`` (their offsets in the window).

    ``win`` must be sorted (ascending window ids below ``n_win``); cores are
    row-major mesh coordinates.  Returns the (num_links,) int64 loads summed
    over the windows, the (n,) uint8 flags (``PAST``: the route crosses a
    (window, link) pair loaded above ``link_capacity``; ``STEPPED`` as
    well: the window's unobstructed schedule oversubscribes a (cycle, link)
    bucket, so the packet must be stepped) and the counts ``hot_pairs``,
    ``past_screen`` and ``bad_windows``.  On the card the packets and their
    cycles go up as one pinned buffer and one launch screens every window;
    no route is expanded on the host.
    """
    dev = resolve_device(device)
    if inject.shape[0] and (int(inject.min()) < 0 or int(inject.max())
                            + mesh_w + mesh_h > np.iinfo(np.int32).max):
        raise ValueError("injection cycles must lie in [0, 2**31 - W - H)")
    woff, rec, inj = _upload_packets(win, src_core, dst_core, n_win, mesh_w,
                                     mesh_h, dev, inject)
    spans.add(link_load_calls=1, link_load_records=int(rec.shape[0]),
              link_load_windows=n_win, replay_screen_calls=1)
    flags, totals = replay_screen(woff, rec, inj, mesh_w, mesh_h,
                                  link_capacity)
    totals = totals.cpu().numpy()
    nl = totals.shape[0] - 3
    counts = dict(zip(("hot_pairs", "past_screen", "bad_windows"),
                      totals[nl:].tolist()))
    return totals[:nl], flags.cpu().numpy(), counts


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
    x, y = _mesh_coords(mesh_w, mesh_h, dev)
    out = []
    for lo in range(0, traffic.shape[0], chunk):
        batch = torch.from_numpy(
            np.ascontiguousarray(traffic[lo:lo + chunk], dtype=np.int32)).to(dev)
        out.append(link_loads(batch, x, y, mesh_w, mesh_h).cpu().numpy())
    if not out:
        return np.empty((0, link_count(mesh_w, mesh_h)), dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


def flatten_link_maps(e: torch.Tensor, w_: torch.Tensor, s: torch.Tensor,
                      n: torch.Tensor, mesh_w: int, mesh_h: int) -> torch.Tensor:
    """Concatenate (E, W, S, N) maps into the flat directed-link id layout.

    Row-major raveling of each map lands every entry exactly at its
    ``repro_torch.nocsim.xy`` link id: ``east[y, x] -> y*(W-1)+x`` and so on
    for the W/S/N blocks.  Maps may arrive padded; only the leading
    (H, W-1) / (W, H-1) blocks are real.
    """
    return torch.cat([e[:mesh_h, :mesh_w - 1].reshape(-1),
                      w_[:mesh_h, :mesh_w - 1].reshape(-1),
                      s[:mesh_w, :mesh_h - 1].reshape(-1),
                      n[:mesh_w, :mesh_h - 1].reshape(-1)])


def edge_variance(traffic: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  mesh_w: int, mesh_h: int) -> torch.Tensor:
    """Paper Eq. 4-5 over partition-level traffic: the population variance
    (a 0-d f64 tensor) of the XY link loads of (K, K) integer spike counts
    between partitions placed at (x, y).  The loads come from the
    ``link_loads`` kernel on CUDA, from its plain version on the CPU."""
    if traffic.is_floating_point() and not torch.equal(traffic, traffic.round()):
        raise ValueError("edge_variance takes integer spike counts")
    counts = traffic.to(torch.int32)[None]
    x, y = x.to(torch.int32), y.to(torch.int32)
    flat = link_loads(counts, x, y, mesh_w, mesh_h)[0].to(torch.float64)
    return flat.var(unbiased=False)
