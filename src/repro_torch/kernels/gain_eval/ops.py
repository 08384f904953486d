"""Public wrappers: degree and gain matrices and the volume mover selection,
the kernels on CUDA, plain on CPU."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans

from .kernel import (
    SelectSlots,
    part_degrees_cuda,
    volume_degree_rows_cuda,
    volume_select_cuda,
)
from .ref import (
    part_degrees_ref,
    part_onehot,
    volume_degree_rows_ref,
    volume_select_ref,
)

__all__ = ["part_degrees", "volume_degree_rows", "gain_matrix",
           "volume_select", "read_select"]


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


def volume_select(vxadj: torch.Tensor, vedges: torch.Tensor,
                  phi: torch.Tensor, cand: torch.Tensor, own: torch.Tensor,
                  target: torch.Tensor, pri: torch.Tensor, rounds: int,
                  slots: SelectSlots | None = None) -> torch.Tensor:
    """(8 + C,) uint8: the conflict-free movers among the candidates ``cand``
    (see ``volume_select_ref``), after a header of the contended key count
    and the rounds run.  On CUDA ``slots`` is the Φ table's slot state kept
    across calls (``SelectSlots``); the plain version needs none."""
    if vxadj.device.type == "cuda":
        return volume_select_cuda(vxadj, vedges, phi, cand, own, target, pri,
                                  rounds, slots)
    if vxadj.device.type == "cpu":
        return volume_select_ref(vxadj, vedges, phi, cand, own, target, pri,
                                 rounds)
    raise ValueError(
        f"volume_select runs on cuda or cpu tensors, not {vxadj.device}")


def read_select(out: torch.Tensor) -> tuple[np.ndarray, int, int]:
    """``volume_select``'s result on the host, in one read: (chosen mask,
    contended keys, rounds run)."""
    host = out.cpu().numpy()
    contended, rounds = (int(x) for x in host[:8].view(np.int32))
    return host[8:] != 0, contended, rounds
