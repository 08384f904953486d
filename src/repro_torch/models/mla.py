"""Multi-head Latent Attention (DeepSeek-V2), prefill + absorbed decode.

K/V are compressed into a rank-`kv_lora_rank` latent c_kv plus one shared
decoupled rope sub-head k_pe; the cache stores only (c_kv, k_pe) — the MLA
memory saving.  Decode uses the weight-absorption identity:

  score = (q_nope W_uk^T) . c_kv + q_pe . k_pe
  out   = (softmax . c_kv) W_uv

so the per-head K/V are never materialized during decode.  ``p`` is the
attention module holding ``w_q``, ``w_dkv``, ``w_kpe``, ``w_uk``, ``w_uv``
and ``w_o``.  The latent score and softmax·c_kv products are f32 from the
cache dtype's operands, as the reference asks.

A rank of a mesh of ranks may hold a block of the heads (``w_q``,
``w_uk``, ``w_uv``, ``w_o``; ``mesh``): the latent and its rope sub-head
are whole on every rank (``w_dkv``, ``w_kpe``, which pass `Mesh.copy_to`
with the normed input, so their gradients are summed over ``model``),
each rank attends with its heads, and ``w_o``'s product is summed over
``model`` (`layers.row_parallel`).  A rank may hold a block of the
latent cache's sequence slots (`attention.SeqBlock`): decode writes the
new latent only where its slot lies, gathers the absorbed queries
(``q_lat``, ``q_pe``) of every head over ``model``, scores them against
its slots, combines the partial softmax over the slot holders
(`attention.seq_softmax`) and takes its heads' ``out_lat`` into ``w_uv``
and ``w_o``: the latent cache itself is never gathered.

Where the heads do not divide the model axis, a model built with the
planner's ``shard_head_dim_fallback`` holds a block of ``w_q``'s
nope+rope dim and of ``w_uk``/``w_uv``/``w_o``'s head_dim.  The query
and, at prefill, the per-head K and V are gathered whole over ``model``
(`attention.whole_head_dim`) and attention runs over every head; the
absorbed decode contracts ``w_uk``'s block with the rank's block of
``q_nope``'s head_dim and sums the part over ``model`` (one
``all_reduce``, in f32), and ``w_uv``'s block gives the rank's block of
the output's head_dim, which ``w_o``'s block takes as it is before its
sum over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import (SeqBlock, gather_heads, head_dim_block, mha,
                        seq_softmax, whole_head_dim, write_slots)
from .layers import apply_rope, row_parallel

__all__ = ["mla_attention", "mla_decode", "init_mla_cache", "update_mla_cache"]


def _project_q(p, x: torch.Tensor, positions: torch.Tensor, cfg, mesh=None):
    """Returns q_nope (B,S,H,hd), q_pe (B,S,H,rh) with rope applied (a
    block of ``w_q``'s nope+rope dim gathered whole first)."""
    q = torch.einsum("bsd,dhe->bshe", x, p.w_q)  # e = hd + rh
    q = whole_head_dim(q, cfg.head_dim + cfg.rope_head_dim, mesh)
    q_nope = q[..., : cfg.head_dim]
    q_pe = apply_rope(q[..., cfg.head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _latent(p, x, positions, cfg, mesh=None):
    """c_kv (B,S,r) and the roped shared sub-head k_pe (B,S,rh); on a rank
    holding a block of the heads, ``w_dkv`` and ``w_kpe`` pass
    `Mesh.copy_to` (``x`` already has)."""
    w_dkv, w_kpe = p.w_dkv, p.w_kpe
    if _split(p, cfg):
        w_dkv, w_kpe = mesh.copy_to(w_dkv), mesh.copy_to(w_kpe)
    c_kv = x @ w_dkv
    k_pe = apply_rope((x @ w_kpe)[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def _split(p, cfg) -> bool:
    """Whether ``p`` holds a block of the heads."""
    return p.w_q.shape[1] != cfg.num_heads


def _out(p, out, cfg, mesh):
    """The output projection of the heads' ``out`` (B,S,h,hd): summed over
    ``model`` where ``p`` holds a block of them, or of the head_dim (of
    which ``out`` is, or gives, the rank's block)."""
    if _split(p, cfg):
        return row_parallel(out, p.w_o, mesh)
    if p.w_o.shape[1] != cfg.head_dim:
        return row_parallel(head_dim_block(out, p.w_o.shape[1], mesh), p.w_o, mesh)
    return torch.einsum("bshe,hed->bsd", out, p.w_o)


def mla_attention(
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg,
    kv_chunk: int = 1024,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Prefill/train path: materializes per-head K/V from the latent.

    Returns (attn_out (B,S,D), {c_kv, k_pe, pos}).
    """
    b, s, _ = x.shape
    hd, rh = cfg.head_dim, cfg.rope_head_dim
    if _split(p, cfg):
        x = mesh.copy_to(x)
    h = p.w_q.shape[1]
    q_nope, q_pe = _project_q(p, x, positions, cfg, mesh)
    c_kv, k_pe = _latent(p, x, positions, cfg, mesh)

    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p.w_uk)  # (B,S,H,hd)
    v = torch.einsum("bsr,rhe->bshe", c_kv, p.w_uv)  # (B,S,H,hd)
    k_nope, v = (whole_head_dim(t, hd, mesh) for t in (k_nope, v))

    # Assemble full q/k with the shared rope sub-head broadcast to all heads.
    q_full = torch.cat([q_nope, q_pe], dim=-1)  # (B,S,H,hd+rh)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rh)], dim=-1)
    scale = (hd + rh) ** -0.5
    # v is padded to hd+rh so mha's uniform head_dim applies; excess sliced off.
    v_pad = F.pad(v, (0, rh))
    out = mha(q_full, k_full, v_pad, positions, positions, causal=True,
              kv_chunk=kv_chunk, softmax_scale=scale)[..., :hd]
    return _out(p, out, cfg, mesh), {"c_kv": c_kv, "k_pe": k_pe, "pos": positions}


def mla_decode(
    p,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # c_kv (B,S,r), k_pe (B,S,rh), pos (B,S)
    positions: torch.Tensor,  # (B, 1)
    cfg,
    mesh=None,
    seq: SeqBlock | None = None,
) -> tuple[torch.Tensor, dict]:
    """Absorbed decode: attention in latent space, O(r) per cached token;
    on a rank, see the module docstring."""
    hd, rh = cfg.head_dim, cfg.rope_head_dim
    q_nope, q_pe = _project_q(p, x, positions, cfg, mesh)  # (B,1,H,hd), (B,1,H,rh)
    c_new, kpe_new = _latent(p, x, positions, cfg, mesh)
    cache = update_mla_cache(cache, c_new, kpe_new, positions, seq)

    if p.w_uk.shape[-1] != hd:  # a head_dim block: its part of the contraction
        part = torch.einsum("bshe,rhe->bshr", head_dim_block(
            q_nope, p.w_uk.shape[-1], mesh).float(), p.w_uk.float())
        q_lat = mesh.all_reduce(part, "model").to(q_nope.dtype)
    else:
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p.w_uk)  # absorb W_uk
    gather = seq is not None and _split(p, cfg)
    if gather:  # every head against this rank's slots
        q_lat, q_pe = gather_heads(q_lat, mesh), gather_heads(q_pe, mesh)
    c_kv = cache["c_kv"]
    s_lat = torch.einsum("bshr,bcr->bshc", q_lat.float(), c_kv.float())
    s_pe = torch.einsum("bshe,bce->bshc", q_pe.float(), cache["k_pe"].float())
    s = (s_lat + s_pe) * (hd + rh) ** -0.5  # (B,1,H,C)
    valid = (cache["pos"] >= 0) & (cache["pos"] <= positions)  # (B,C)
    out_lat = seq_softmax(s, valid[:, None, None, :], lambda w: torch.einsum(
        "bshc,bcr->bshr", w.to(c_kv.dtype).float(), c_kv.float()),
        mesh, seq).to(x.dtype)
    if gather:  # this rank's heads
        h = p.w_uv.shape[1]
        i = mesh.coord["model"]
        out_lat = out_lat[:, :, i * h:(i + 1) * h]
    # (B,1,H,hd); a head_dim block of w_uv gives the rank's block of it
    out = torch.einsum("bshr,rhe->bshe", out_lat, p.w_uv)
    return _out(p, out, cfg, mesh), cache


def init_mla_cache(batch: int, length: int, cfg, dtype, device,
                   lead: tuple[int, ...] = ()) -> dict:
    """A {c_kv, k_pe, pos} cache; ``lead`` prepends stack dims (layers)."""
    return {
        "c_kv": torch.zeros(lead + (batch, length, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros(lead + (batch, length, cfg.rope_head_dim), dtype=dtype,
                            device=device),
        "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32,
                          device=device),
    }


def update_mla_cache(cache: dict, c_new, kpe_new, positions,
                     seq: SeqBlock | None = None) -> dict:
    """Write the new latents at their positions, in place; with a
    `attention.SeqBlock`, only those whose slot lies in this rank's block
    (`attention.write_slots`)."""
    return write_slots(cache, {"c_kv": c_new, "k_pe": kpe_new}, positions, seq)
