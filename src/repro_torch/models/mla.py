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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import NEG_INF, mha
from .layers import apply_rope

__all__ = ["mla_attention", "mla_decode", "init_mla_cache", "update_mla_cache"]


def _project_q(p, x: torch.Tensor, positions: torch.Tensor, cfg):
    """Returns q_nope (B,S,H,hd), q_pe (B,S,H,rh) with rope applied."""
    q = torch.einsum("bsd,dhe->bshe", x, p.w_q)  # e = hd + rh
    q_nope = q[..., : cfg.head_dim]
    q_pe = apply_rope(q[..., cfg.head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _latent(p, x, positions, cfg):
    """c_kv (B,S,r) and the roped shared sub-head k_pe (B,S,rh)."""
    c_kv = x @ p.w_dkv
    k_pe = apply_rope((x @ p.w_kpe)[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_attention(
    p,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, dict]:
    """Prefill/train path: materializes per-head K/V from the latent.

    Returns (attn_out (B,S,D), {c_kv, k_pe, pos}).
    """
    b, s, _ = x.shape
    h, hd, rh = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    q_nope, q_pe = _project_q(p, x, positions, cfg)
    c_kv, k_pe = _latent(p, x, positions, cfg)

    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p.w_uk)  # (B,S,H,hd)
    v = torch.einsum("bsr,rhe->bshe", c_kv, p.w_uv)  # (B,S,H,hd)

    # Assemble full q/k with the shared rope sub-head broadcast to all heads.
    q_full = torch.cat([q_nope, q_pe], dim=-1)  # (B,S,H,hd+rh)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rh)], dim=-1)
    scale = (hd + rh) ** -0.5
    # v is padded to hd+rh so mha's uniform head_dim applies; excess sliced off.
    v_pad = F.pad(v, (0, rh))
    out = mha(q_full, k_full, v_pad, positions, positions, causal=True,
              kv_chunk=kv_chunk, softmax_scale=scale)[..., :hd]
    attn = torch.einsum("bshe,hed->bsd", out, p.w_o)
    return attn, {"c_kv": c_kv, "k_pe": k_pe, "pos": positions}


def mla_decode(
    p,
    x: torch.Tensor,  # (B, 1, D)
    cache: dict,  # c_kv (B,S,r), k_pe (B,S,rh), pos (B,S)
    positions: torch.Tensor,  # (B, 1)
    cfg,
) -> tuple[torch.Tensor, dict]:
    """Absorbed decode: attention in latent space, O(r) per cached token."""
    hd, rh = cfg.head_dim, cfg.rope_head_dim
    q_nope, q_pe = _project_q(p, x, positions, cfg)  # (B,1,H,hd), (B,1,H,rh)
    c_new, kpe_new = _latent(p, x, positions, cfg)
    cache = update_mla_cache(cache, c_new, kpe_new, positions)

    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p.w_uk)  # absorb W_uk
    c_kv = cache["c_kv"]
    s_lat = torch.einsum("bshr,bcr->bshc", q_lat.float(), c_kv.float())
    s_pe = torch.einsum("bshe,bce->bshc", q_pe.float(), cache["k_pe"].float())
    s = (s_lat + s_pe) * (hd + rh) ** -0.5  # (B,1,H,C)
    valid = (cache["pos"] >= 0) & (cache["pos"] <= positions)  # (B,C)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bshc,bcr->bshr", w.to(c_kv.dtype).float(),
                           c_kv.float()).to(x.dtype)
    out = torch.einsum("bshr,rhe->bshe", out_lat, p.w_uv)  # (B,1,H,hd)
    attn = torch.einsum("bshe,hed->bsd", out, p.w_o)
    return attn, cache


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


def update_mla_cache(cache: dict, c_new, kpe_new, positions) -> dict:
    """Write the new latents at their positions, in place."""
    b_idx = torch.arange(c_new.shape[0], device=c_new.device)[:, None]
    pos = positions.long()
    cache["c_kv"][b_idx, pos] = c_new.to(cache["c_kv"].dtype)
    cache["k_pe"][b_idx, pos] = kpe_new.to(cache["k_pe"].dtype)
    cache["pos"][b_idx, pos] = positions.to(torch.int32)
    return cache
