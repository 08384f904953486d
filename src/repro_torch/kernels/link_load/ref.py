"""Plain PyTorch version of the per-window XY link loads.

Under XY routing a packet from (xa, ya) to (xb, yb) first crosses the
horizontal links of row ya between xa and xb, then the vertical links of
column xb between ya and yb.  Summing core-to-core counts over those
closed-form conditions gives the four directional load maps

  east[y, w]  = sum C[a,b] * [ya==y] * [xa <= w <  xb]
  west[y, w]  = sum C[a,b] * [ya==y] * [xb <= w <  xa]
  south[x, q] = sum C[a,b] * [xb==x] * [ya <= q <  yb]
  north[x, q] = sum C[a,b] * [xb==x] * [yb <= q <  ya]

(w indexes the link between columns w and w+1; q the link between rows q
and q+1), each factored into indicator-matrix products.  Row-major
raveling of the maps lands every entry at its ``nocsim.xy`` link id.
"""
from __future__ import annotations

import torch

__all__ = ["link_loads_ref"]


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
