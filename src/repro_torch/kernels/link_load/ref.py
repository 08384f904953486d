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

``replay_screen_ref`` is the queued unicast replay's two tier-1 screens
over such records and their injection cycles (see ``csrc/replay_screen.cu``),
by route expansion, exact.
"""
from __future__ import annotations

import torch

from repro_torch.nocsim.xy import link_count

__all__ = ["MAX_CORES", "PAST", "STEPPED", "dense_to_records",
           "link_loads_records_ref", "link_loads_ref", "pack_routes",
           "replay_screen_ref"]

# A record packs its route as (src << 16) | dst in one int32.
MAX_CORES = 1 << 15
# The replay screen's flags a packet: its route crosses an overloaded
# (window, link) pair; and its window's unobstructed schedule oversubscribes
# a (cycle, link) bucket too, so the joint stepper steps it.
PAST, STEPPED = 1, 2


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


def _route_links(sx: torch.Tensor, sy: torch.Tensor, dx: torch.Tensor,
                 dy: torch.Tensor, mesh_w: int, mesh_h: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packet, link, step) of every hop of the XY routes (sx, sy) -> (dx,
    dy): the X leg along row sy, then the Y leg along column dx; ``step`` is
    the hop's 0-based place on its route."""
    w_base = (mesh_w - 1) * mesh_h
    s_base = 2 * w_base
    n_base = s_base + mesh_w * (mesh_h - 1)
    hx = (dx - sx).abs()
    p, j = _expand(hx)
    col = torch.minimum(sx, dx)[p] + j
    east = dx[p] > sx[p]
    row_x = sy[p] * (mesh_w - 1) + col
    ids_x = torch.where(east, row_x, w_base + row_x)
    step_x = torch.where(east, col - sx[p], sx[p] - 1 - col)
    q, i = _expand((dy - sy).abs())
    row = torch.minimum(sy, dy)[q] + i
    south = dy[q] > sy[q]
    col_y = dx[q] * (mesh_h - 1) + row
    ids_y = torch.where(south, s_base + col_y, n_base + col_y)
    step_y = hx[q] + torch.where(south, row - sy[q], sy[q] - 1 - row)
    return (torch.cat([p, q]), torch.cat([ids_x, ids_y]),
            torch.cat([step_x, step_y]))


def _windows(woff: torch.Tensor) -> torch.Tensor:
    """The window of each record, from the window offsets."""
    n_win = woff.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n_win, device=woff.device),
                                   torch.diff(woff.to(torch.int64)))


def link_loads_records_ref(woff: torch.Tensor, rec: torch.Tensor,
                           count: torch.Tensor | None, x: torch.Tensor,
                           y: torch.Tensor, mesh_w: int,
                           mesh_h: int) -> torch.Tensor:
    """The (n_win, num_links) int32 loads of window-sorted route records
    (see ``link_loads_records_cuda``), by route expansion, exact."""
    n_win = woff.shape[0] - 1
    nl = link_count(mesh_w, mesh_h)
    win = _windows(woff)
    s = (rec >> 16).to(torch.int64)
    d = (rec & 0xFFFF).to(torch.int64)
    x, y = x.to(torch.int64), y.to(torch.int64)
    cnt = (torch.ones_like(s) if count is None else count.to(torch.int64))
    pkt, link, _ = _route_links(x[s], y[s], x[d], y[d], mesh_w, mesh_h)
    loads = torch.zeros(n_win * nl, dtype=torch.int64, device=rec.device)
    loads.index_add_(0, win[pkt] * nl + link, cnt[pkt])
    return loads.view(n_win, nl).to(torch.int32)


def replay_screen_ref(woff: torch.Tensor, rec: torch.Tensor,
                      inject: torch.Tensor, mesh_w: int, mesh_h: int,
                      link_capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The queued unicast replay's tier-1 screens over window-sorted packet
    records (see ``replay_screen_cuda``), by route expansion, exact.

    woff: (n_win + 1,) window offsets; rec: (n,) int32 records ``(src <<
    16) | dst`` of row-major cores; inject: (n,) injection cycles.  A
    packet is ``PAST`` where its route crosses a link whose whole-window
    load exceeds ``link_capacity``; it is also ``STEPPED`` where, in its
    window, some (cycle, link) bucket of the past packets' unobstructed
    schedule (``inject + step``) holds more than ``link_capacity``.
    Returns the (n,) uint8 flags and the int64 totals: the (num_links,)
    loads summed over the windows, then the counts of overloaded (window,
    link) pairs, of past packets and of windows with an oversubscribed
    bucket.
    """
    dev = rec.device
    n_win = woff.shape[0] - 1
    nl = link_count(mesh_w, mesh_h)
    win = _windows(woff)
    s = (rec >> 16).to(torch.int64)
    d = (rec & 0xFFFF).to(torch.int64)
    pkt, link, step = _route_links(s % mesh_w, s // mesh_w, d % mesh_w,
                                   d // mesh_w, mesh_w, mesh_h)
    key = win[pkt] * nl + link
    loads = torch.bincount(key, minlength=n_win * nl)
    over = loads > link_capacity
    past = torch.zeros(rec.shape[0], dtype=torch.bool, device=dev)
    past[pkt[over[key]]] = True
    hop = past[pkt]
    cycle = inject.to(torch.int64)[pkt[hop]] + step[hop]
    span = int(cycle.max()) + 1 if cycle.numel() else 1
    keys, cnt = torch.unique((win[pkt[hop]] * span + cycle) * nl + link[hop],
                             return_counts=True)
    bad = torch.zeros(n_win, dtype=torch.bool, device=dev)
    bad[keys[cnt > link_capacity] // (span * nl)] = True
    stepped = past & bad[win]
    flags = past.to(torch.uint8) * PAST + stepped.to(torch.uint8) * STEPPED
    totals = torch.cat([loads.view(n_win, nl).sum(0),
                        torch.stack([over.sum(), past.sum(), bad.sum()])])
    return flags, totals
