"""Shared building blocks: norms, rotary embeddings, SwiGLU MLP, the
(vocab-parallel) embedding lookup."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "swiglu", "embed_tokens",
           "init_dense", "cross_entropy_loss", "DTYPES"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """(head_dim // 2,) inverse frequencies (float32, computed by numpy as
    the reference computes them)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by position; fp32 math.

    positions: (..., seq) int32 — absolute token positions.
    """
    hd = x.shape[-1]
    inv = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, hd/2) broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., : hd // 2].float()
    x2 = x[..., hd // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
                 mesh=None) -> torch.Tensor:
    """The rows of the embedding ``table`` (V, D) for ``tokens``.  Where
    ``table`` holds a block of the ``vocab`` rows (a rank of a mesh of
    ranks, its block at its coordinate along ``model``), each token
    outside the block gets zeros and one ``all_reduce`` over ``model``
    sums the blocks: a token's row comes from one rank, so the sum is
    exact."""
    rows = table.shape[0]
    if rows == vocab:
        return table[tokens.long()]
    local = tokens.long() - mesh.coord["model"] * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0)
    return mesh.all_reduce(x, "model")


def init_dense(param: torch.Tensor, generator: torch.Generator,
               fan_in: int | None = None, whole: tuple[int, ...] | None = None,
               block: tuple[slice, ...] | None = None) -> torch.Tensor:
    """Fill ``param`` in place with the reference's truncated-normal fan-in
    init: a standard normal truncated to ±3, drawn in f32 on the
    parameter's device from ``generator``, times fan_in**-0.5 (fan_in
    defaults to the leading dim), cast to the parameter's dtype.  Where
    ``param`` is the ``block`` of a leaf of shape ``whole``, the whole
    leaf is drawn and the block kept, so it is the whole leaf's block bit
    for bit and the generator moves on as it would for the whole leaf."""
    shape = tuple(param.shape) if whole is None else tuple(whole)
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else 1
    draw = torch.empty(shape, dtype=torch.float32, device=param.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -3.0, 3.0, generator=generator)
    if block is not None:
        draw = draw[block]
    with torch.no_grad():
        param.copy_(draw.mul_(fan_in ** -0.5))
    return param


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32. logits (..., V), labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
