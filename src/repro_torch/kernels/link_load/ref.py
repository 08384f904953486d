"""Plain PyTorch versions of the per-window XY link loads, and the packet
record layout the kernel reads.

Under XY routing a packet from (xa, ya) to (xb, yb) first crosses the
horizontal links of row ya between xa and xb, then the vertical links of
column xb between ya and yb.

``link_loads_ref`` takes dense (B, K, K) core-to-core counts and sums them
over those closed-form conditions, giving the four directional load maps

  east[y, w]  = sum C[a,b] * [ya==y] * [xa <= w <  xb]
  west[y, w]  = sum C[a,b] * [ya==y] * [xb <= w <  xa]
  south[x, q] = sum C[a,b] * [xb==x] * [ya <= q <  yb]
  north[x, q] = sum C[a,b] * [xb==x] * [yb <= q <  ya]

(w indexes the link between columns w and w+1; q the link between rows q
and q+1), each factored into indicator-matrix products.  Row-major
raveling of the maps lands every entry at its ``nocsim.xy`` link id.

``link_loads_records_ref`` takes window-sorted packet records — one int32
``(src << 16) | dst`` a record (``pack_routes``), window offsets and an
optional count a record — expands every route into its link ids and sums
the counts per (window, link) in int64.
"""
from __future__ import annotations

import torch

from repro_torch.nocsim.xy import link_count

__all__ = ["MAX_CORES", "dense_to_records", "link_loads_records_ref",
           "link_loads_ref", "pack_routes"]

# A record packs its route as (src << 16) | dst in one int32.
MAX_CORES = 1 << 15


def pack_routes(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """int32 route records ``(src << 16) | dst`` of core ids below
    ``MAX_CORES``."""
    return ((src.to(torch.int32) << 16) | dst.to(torch.int32)).contiguous()


def dense_to_records(counts: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(woff, rec, count) of the non-zero entries of (B, K, K) counts, on
    the device of ``counts``: one weighted record per (window, src, dst),
    windows ascending; ``woff`` (B + 1,) int32 are the window offsets."""
    b = counts.shape[0]
    win, s, d = counts.nonzero(as_tuple=True)  # row-major: windows ascending
    cnt = counts[win, s, d].to(torch.int32).contiguous()
    woff = torch.searchsorted(win, torch.arange(b + 1, device=counts.device))
    return woff.to(torch.int32), pack_routes(s, d), cnt


def link_loads_ref(counts: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   mesh_w: int, mesh_h: int) -> torch.Tensor:
    """counts: (B, K, K) core-to-core counts; x, y: (K,) core coordinates.

    Returns the (B, num_links) int32 loads in the flat ``xy`` link id
    layout.  The products run in f32, exact for per-link sums below 2**24.
    """
    c = counts.to(torch.float32)
    dev = c.device
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    wl = torch.arange(mesh_w - 1, device=dev)[None, :]
    ql = torch.arange(mesh_h - 1, device=dev)[None, :]
    xc, yc = x[:, None], y[:, None]

    def ind(m: torch.Tensor) -> torch.Tensor:
        return m.to(torch.float32)

    row_of = ind(yc == torch.arange(mesh_h, device=dev)[None, :])  # (K, H)
    col_of = ind(xc == torch.arange(mesh_w, device=dev)[None, :])  # (K, W)
    # Horizontal leg, contracted over the destination b first.
    t_e = c @ ind(wl < xc)  # sum_b C[a,b] [w < xb]
    t_w = c @ ind(xc <= wl)  # sum_b C[a,b] [xb <= w]
    east = row_of.T @ (t_e * ind(xc <= wl))  # [xa <= w]
    west = row_of.T @ (t_w * ind(wl < xc))  # [w < xa]
    # Vertical leg, contracted over the source a first.
    ct = c.transpose(1, 2)
    p_s = ct @ ind(yc <= ql)  # sum_a C[a,b] [ya <= q]
    p_n = ct @ ind(ql < yc)  # sum_a C[a,b] [q < ya]
    south = col_of.T @ (p_s * ind(ql < yc))  # [q < yb]
    north = col_of.T @ (p_n * ind(yc <= ql))  # [yb <= q]
    flat = torch.cat([east.flatten(1), west.flatten(1),
                      south.flatten(1), north.flatten(1)], dim=1)
    return torch.round(flat).to(torch.int32)


def _expand(length: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(record, step) pairs: record r repeated length[r] times, step
    0..length[r]-1 within each."""
    rec = torch.repeat_interleave(
        torch.arange(length.shape[0], device=length.device), length)
    start = torch.cumsum(length, 0) - length
    return rec, torch.arange(rec.shape[0], device=length.device) - start[rec]


def link_loads_records_ref(woff: torch.Tensor, rec: torch.Tensor,
                           count: torch.Tensor | None, x: torch.Tensor,
                           y: torch.Tensor, mesh_w: int,
                           mesh_h: int) -> torch.Tensor:
    """The (n_win, num_links) int32 loads of window-sorted route records
    (see ``link_loads_records_cuda``), by route expansion, exact."""
    dev = rec.device
    n_win = woff.shape[0] - 1
    nl = link_count(mesh_w, mesh_h)
    win = torch.repeat_interleave(torch.arange(n_win, device=dev),
                                  torch.diff(woff.to(torch.int64)))
    s = (rec >> 16).to(torch.int64)
    d = (rec & 0xFFFF).to(torch.int64)
    x, y = x.to(torch.int64), y.to(torch.int64)
    sx, sy, dx, dy = x[s], y[s], x[d], y[d]
    cnt = (torch.ones_like(s) if count is None else count.to(torch.int64))
    w_base = (mesh_w - 1) * mesh_h
    s_base = 2 * w_base
    n_base = s_base + mesh_w * (mesh_h - 1)
    # X leg along row sy, then Y leg along column dx.
    p, j = _expand((dx - sx).abs())
    col = torch.minimum(sx, dx)[p] + j
    row_x = sy[p] * (mesh_w - 1) + col
    ids_x = torch.where(dx[p] > sx[p], row_x, w_base + row_x)
    q, i = _expand((dy - sy).abs())
    col_y = dx[q] * (mesh_h - 1) + torch.minimum(sy, dy)[q] + i
    ids_y = torch.where(dy[q] > sy[q], s_base + col_y, n_base + col_y)
    keys = torch.cat([win[p] * nl + ids_x, win[q] * nl + ids_y])
    loads = torch.zeros(n_win * nl, dtype=torch.int64, device=dev)
    loads.index_add_(0, keys, torch.cat([cnt[p], cnt[q]]))
    return loads.view(n_win, nl).to(torch.int32)
