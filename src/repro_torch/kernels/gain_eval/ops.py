"""Public wrappers: degree and gain matrices, the kernels on CUDA, plain on CPU."""
from __future__ import annotations

import torch

from repro_torch import spans

from .kernel import part_degrees_cuda, volume_degree_rows_cuda
from .ref import part_degrees_ref, part_onehot, volume_degree_rows_ref

__all__ = ["part_degrees", "volume_degree_rows", "gain_matrix"]


def part_degrees(adj: torch.Tensor, part: torch.Tensor, k: int,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """(R, k) f32 degrees D[r, b] = sum_{u: part[u]=b} adj[rows[r], u]."""
    spans.add(degree_calls=1,
              degree_rows=adj.shape[0] if rows is None else rows.shape[0])
    if adj.device.type == "cuda":
        return part_degrees_cuda(adj, part, k, rows)
    if adj.device.type == "cpu":
        return part_degrees_ref(adj, part, k, rows)
    raise ValueError(f"part_degrees runs on cuda or cpu tensors, not {adj.device}")


def volume_degree_rows(vxadj: torch.Tensor, vedges: torch.Tensor,
                       w: torch.Tensor, phi: torch.Tensor,
                       rows: torch.Tensor | None,
                       own: torch.Tensor) -> torch.Tensor:
    """(R, k) f32 volume-mode degrees D*[r, c] = sum of w over the CSR
    entries e of vertex rows[r] with phi[e, c] > (c == own[r])."""
    spans.add(degree_calls=1, degree_rows=own.shape[0])
    if vxadj.device.type == "cuda":
        return volume_degree_rows_cuda(vxadj, vedges, w, phi, rows, own)
    if vxadj.device.type == "cpu":
        return volume_degree_rows_ref(vxadj, vedges, w, phi, rows, own)
    raise ValueError(
        f"volume_degree_rows runs on cuda or cpu tensors, not {vxadj.device}")


def gain_matrix(adj: torch.Tensor, part: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) f32 move gains (D minus the own-column internal degree, 0 in
    the own column).  The degree product is the part_degrees kernel on
    CUDA; the O(nk) epilogue is elementwise PyTorch on either device."""
    deg = part_degrees(adj, part, k)
    own = torch.take_along_dim(deg, part[:, None].to(torch.int64), dim=1)
    return (deg - own) * (1.0 - part_onehot(part, k))
