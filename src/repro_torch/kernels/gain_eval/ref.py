"""Plain PyTorch versions of the partition degree and gain matrices.

For a dense weighted adjacency A (n, n) and a partition vector p (n,),

    D = A @ onehot(p)          D[v, b] = sum of w(v, u) over u with p[u] = b

Column p[v] of row v is v's internal degree; every other column is an
external degree (see `repro_torch.core.refine_vec`).  The move gain is
then elementwise arithmetic:

    gain[v, b] = D[v, b] - D[v, p[v]]     (0 in the own column)

The volume objective's counterpart is the connectivity-mode product

    D* = inc @ pres

of the hfire-weighted vertex x hyperedge incidence and a per-hyperedge
partition-presence matrix (the TPU kernel's dense form).  The refiner
needs its degree rows with the own column demanding a second member,

    D*[r, c] = sum_{e in edges(rows[r])} hfire[e] * [Φ(e, c) > (c == own[r])]

which ``volume_degree_rows_ref`` computes from the sparse vertex ->
hyperedge CSR and the member-count table Φ.  Only the requested ``rows``
of D and D* are computed.
"""
from __future__ import annotations

import torch

__all__ = ["part_onehot", "part_degrees_ref", "gain_matrix_ref",
           "connectivity_degrees_ref", "volume_degree_rows_ref"]


def part_onehot(part: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 one-hot of the partition vector."""
    cols = torch.arange(k, dtype=part.dtype, device=part.device)
    return (part[:, None] == cols[None, :]).to(torch.float32)


def part_degrees_ref(adj: torch.Tensor, part: torch.Tensor, k: int,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, k) f32 rows of D = A @ onehot(p); all n rows when ``rows`` is None."""
    a = adj if rows is None else adj[rows]
    return a.to(torch.float32) @ part_onehot(part, k)


def gain_matrix_ref(adj: torch.Tensor, part: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 move gains; the own column is exactly zero."""
    deg = part_degrees_ref(adj, part, k)
    own = torch.take_along_dim(deg, part[:, None].to(torch.int64), dim=1)
    return (deg - own) * (1.0 - part_onehot(part, k))


def connectivity_degrees_ref(inc: torch.Tensor, pres: torch.Tensor,
                             rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, c) f32 rows of D* = inc @ pres; all n rows when ``rows`` is None.

    ``inc`` (n, E) is the hfire-weighted vertex x hyperedge incidence and
    ``pres`` (E, c) the per-hyperedge partition presence; the product sums,
    per vertex and column, the fire counts of incident hyperedges with a
    member present there (the volume objective's lambda-gain matrix, see
    `repro_torch.core.graph.volume_degrees`).
    """
    a = inc if rows is None else inc[rows]
    return a.to(torch.float32) @ pres.to(torch.float32)


def volume_degree_rows_ref(vxadj: torch.Tensor, vedges: torch.Tensor,
                           w: torch.Tensor, phi: torch.Tensor,
                           rows: torch.Tensor | None,
                           own: torch.Tensor) -> torch.Tensor:
    """(R, k) f32 volume-mode degree rows from the vertex -> hyperedge CSR
    (``vxadj``, ``vedges``), the per-entry weights ``w`` (hfire of each
    entry's hyperedge) and the (E, k) member counts ``phi``; all n rows
    when ``rows`` is None.  ``own`` (R,) is each row vertex's partition.

    Gathers the Φ row of every list entry: a column counts the entry's
    weight where Φ > 0, the own column where Φ > 1 (the row vertex always
    sits there itself) — ``connectivity_degrees_ref`` against
    [Φ > 0 | Φ > 1] followed by the own-column overwrite.
    """
    if rows is None:
        rows = torch.arange(vxadj.shape[0] - 1, device=vxadj.device)
    rows = rows.to(torch.int64)
    k = phi.shape[1]
    starts = vxadj.to(torch.int64)[rows]
    counts = vxadj.to(torch.int64)[rows + 1] - starts
    local = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=rows.device), counts)
    ramp = (torch.arange(local.shape[0], device=rows.device)
            - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts))
    idx = starts[local] + ramp
    cols = torch.arange(k, device=rows.device)
    thr = (cols[None, :] == own.to(torch.int64)[local][:, None]).to(phi.dtype)
    hits = (phi[vedges.to(torch.int64)[idx]] > thr).to(torch.float32)
    out = torch.zeros((rows.shape[0], k), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, local, hits * w.to(torch.float32)[idx][:, None])
