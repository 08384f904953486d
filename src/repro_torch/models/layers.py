"""Shared building blocks: norms, rotary embeddings, SwiGLU MLP, the
(vocab-parallel) embedding lookup, the row-parallel product."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .remat import kept

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "swiglu", "embed_tokens",
           "init_dense", "cross_entropy_loss", "row_parallel", "DTYPES"]

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


class _RowParallel(torch.autograd.Function):
    """``x2 @ w2`` (2-d) summed over ``model``: the partial product with
    an f32 output, summed in f32 and rounded once to ``x2``'s dtype.
    Backward: the sum's is the identity (the loss is the same on every
    rank along ``model``), and ``dx``, ``dw`` are formed in the operands'
    dtype, as the unsharded product's backward forms them (the card's
    ``torch.mm(..., out_dtype=...)`` has no derivative).  The output is
    made through `remat.kept`: a recomputation under
    ``"save_collectives"`` saves the same operands and gives the kept
    sum back without multiplying or summing."""

    @staticmethod
    def forward(ctx, x2, w2, mesh):
        ctx.save_for_backward(x2, w2)

        def make():
            if x2.device.type in ("cuda", "meta") and x2.dtype != torch.float32:
                part = torch.mm(x2, w2, out_dtype=torch.float32)
            else:  # f32 already, or the CPU (no GEMM with a wider output there)
                part = x2.float() @ w2.float()
            return mesh._all_reduce(part, "model").to(x2.dtype)

        return kept(make)

    @staticmethod
    def backward(ctx, grad):
        x2, w2 = ctx.saved_tensors
        grad = grad.to(x2.dtype)
        dx = grad @ w2.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ grad if ctx.needs_input_grad[1] else None
        return dx, dw, None


def row_parallel(x, w, mesh):
    """``x @ w`` contracting the trailing dims of ``x`` with the leading
    dims of ``w`` (all but its last), where both hold this rank's block of
    the contracted dims: the partial product with an f32 output (the
    GEMM's own accumulator: on the card a bf16 GEMM writing f32, no f32
    copy of ``w``), summed over ``model`` in f32 and rounded once to
    ``x``'s dtype, as the unsharded product's accumulator rounds once
    (`_RowParallel`).  The sum's operand is f32: twice the bytes of the
    bf16 partial sums that XLA's partitioner reduces."""
    n = w.shape[-1]
    lead = x.shape[:x.dim() - (w.dim() - 1)]
    x2, w2 = x.reshape(-1, w[..., 0].numel()), w.reshape(-1, n)
    return _RowParallel.apply(x2, w2, mesh).reshape(*lead, n)
