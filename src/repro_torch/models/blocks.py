"""Decoder/encoder blocks: one ``nn.Module`` per family.

Every block's ``forward`` takes a static ``mode`` in {"train", "prefill",
"decode"}:
  * train   — full sequence, no cache.
  * prefill — full sequence, writes the cache decode will consume.
  * decode  — single token against the cache.

A block's cache is a dict of views into the model's stacked cache tensors
(one layer's slice); prefill and decode write it in place, the
counterpart of the reference's donated caches.  Parameter leaf names are
the reference's (``wq``, ``w_gate``, ``router``, ``in_proj``, ...), and
every parameter is created uninitialized (`repro_torch.models.init`
fills them).

The constructors take the whole model's sizes.  A rank's model
(`repro_torch.models.Model` with a ``shard``) holds the planner's block
of each leaf instead, in every family, and the forward reads what it
holds from the tensors' shapes: a block of the query heads (``wq``/``wo``,
MLA's ``w_q``/``w_uk``/``w_uv``/``w_o``; self, cross and encoder
attention) or of the MLP's ffn dim (``w_gate``/``w_up``/``w_down``) makes
a partial sum of the output, which one ``all_reduce`` over ``model``
completes (Megatron's column- then row-parallel pair;
`layers.row_parallel`); a block of the routed experts runs
`moe_ffn_sharded`; a block of Mamba-2's ``in_proj`` / ``out_proj`` runs
the mixer over its inner dim (`mamba2`).  ``mesh_info = (mesh,
batch_axes)`` carries the rank mesh there.  For training, the input of
each column-parallel product (the normed ``x`` before ``wq``/``wk``/``wv``
and before ``w_gate``/``w_up``) passes `Mesh.copy_to`, whose backward
sums its gradient over ``model``, and so do the replicated weights that
each rank uses for its own heads only (``wk``/``wv`` where the KV heads
stay whole, ``q_norm``/``k_norm``, MLA's ``w_dkv``/``w_kpe``).
Where the heads do not divide the model axis and the model was built with
the planner's ``shard_head_dim_fallback`` (`repro_torch.sharding.
ParamShard`), a projection holds a block of the head_dim instead: its
output is gathered whole over ``model`` (`attention.whole_head_dim`),
attention runs as over whole projections, and ``wo`` takes the rank's
block of the output's head_dim and sums its partial product over
``model``; such a model serves, it does not train.
`layers.row_parallel`'s output is the reference's ``tp_collective_out``
point: under the ``"save_collectives"`` remat policy
(`repro_torch.models.model`) it is kept, and the backward's
recomputation neither multiplies nor sums it again.

A rank's cache holds the planner's block (``plan_caches``): its KV
heads, or every KV head over a block of the slots (`attention.SeqBlock`:
where the KV heads do not divide the model axis, or the batch does not
divide the batch axes), or all of it.  Over a block of the slots a
rank writes the tokens whose slot it holds (`write_kv`; the new K/V of
every head gathered over ``model`` where the projections hold a block of
them), and attends with the queries of every head gathered over
``model`` against its slots, the partial softmax combined over the slot
holders; it keeps its heads' output for ``wo`` (`_attend_cache`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import (SeqBlock, decode_attend, gather_heads, head_dim_block,
                        init_kv_cache, mha, update_kv_cache, whole_head_dim)
from .layers import apply_rope, rms_norm, row_parallel, swiglu
from .mamba2 import init_mamba_cache, mamba_block, mamba_decode
from .mla import init_mla_cache, mla_attention, mla_decode, update_mla_cache
from .moe import moe_ffn, moe_ffn_sharded

__all__ = ["Attention", "MLA", "MLP", "MoE", "Mamba", "DenseBlock", "MoEBlock",
           "SSMBlock", "HybridBlock", "CrossBlock", "EncDecBlock",
           "EncoderBlock", "cross_kv", "cross_attention", "write_kv",
           "init_block_cache", "rank_kv_heads"]


def _mesh(mesh_info):
    return mesh_info[0] if mesh_info is not None else None


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# -------------------------------------------------------- parameter groups

class Attention(nn.Module):
    """GQA projections: wq (D, H, hd), wk/wv (D, KVH, hd), wo (H, hd, D);
    q_norm/k_norm (hd,) under qk-norm."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, kvh, hd), dtype, device)
        self.wv = _param((d, kvh, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), dtype, device)
            self.k_norm = _param((hd,), dtype, device)


class MLA(nn.Module):
    """Multi-head latent attention projections (see `mla`)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        r, rh = cfg.kv_lora_rank, cfg.rope_head_dim
        self.w_q = _param((d, h, hd + rh), dtype, device)
        self.w_dkv = _param((d, r), dtype, device)
        self.w_kpe = _param((d, rh), dtype, device)
        self.w_uk = _param((r, h, hd), dtype, device)
        self.w_uv = _param((r, h, hd), dtype, device)
        self.w_o = _param((h, hd, d), dtype, device)


class MLP(nn.Module):
    """SwiGLU MLP: w_gate/w_up (D, F), w_down (F, D); a rank holding a
    block of F sums its partial output over ``model``."""

    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.d_ff = f
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def forward(self, x, mesh=None):
        if self.w_down.shape[0] == self.d_ff:
            return swiglu(x, self.w_gate, self.w_up, self.w_down)
        x = mesh.copy_to(x)
        h = F.silu(x @ self.w_gate) * (x @ self.w_up)
        return row_parallel(h, self.w_down, mesh)


class MoE(nn.Module):
    """Routed experts: router (D, E) in f32, w_gate/w_up (E, D, F),
    w_down (E, F, D); a rank of an expert-parallel mesh holds a block of
    the experts (E / n of them)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.num_experts = e
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, f), dtype, device)
        self.w_up = _param((e, d, f), dtype, device)
        self.w_down = _param((e, f, d), dtype, device)


class Mamba(nn.Module):
    """Mamba-2 mixer weights; dt_bias, a_log and d_skip are f32."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        self.in_proj = _param((d, 2 * di + 2 * n + h), dtype, device)
        self.conv_w = _param((cfg.conv_kernel, di + 2 * n), dtype, device)
        self.dt_bias = _param((h,), torch.float32, device)
        self.a_log = _param((h,), torch.float32, device)
        self.d_skip = _param((h,), torch.float32, device)
        self.norm = _param((di,), dtype, device)
        self.out_proj = _param((di, d), dtype, device)


# ---------------------------------------------------------------- attention

def _qkv(p: Attention, x, positions, cfg, mesh=None):
    """Q, K, V of ``x``.  On a rank holding a block of the query heads,
    ``x`` and the replicated weights it uses for its own heads pass
    `Mesh.copy_to` (their gradients are summed over ``model``).  A
    projection holding a block of the head_dim gives its block, gathered
    whole over ``model`` before the norm and rope, which read the whole
    head_dim (rope pairs dims i and i + hd/2)."""
    wk, wv = p.wk, p.wv
    q_norm, k_norm = (p.q_norm, p.k_norm) if cfg.qk_norm else (None, None)
    if p.wq.shape[1] != cfg.num_heads:
        x = mesh.copy_to(x)
        if wk.shape[1] == cfg.num_kv_heads:  # whole: the rank uses some
            wk, wv = mesh.copy_to(wk), mesh.copy_to(wv)
        if cfg.qk_norm:
            q_norm, k_norm = mesh.copy_to(q_norm), mesh.copy_to(k_norm)
    q = torch.einsum("bsd,dhe->bshe", x, p.wq)
    k = torch.einsum("bsd,dhe->bshe", x, wk)
    v = torch.einsum("bsd,dhe->bshe", x, wv)
    q, k, v = (whole_head_dim(t, cfg.head_dim, mesh) for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def rank_kv_heads(cfg, q_heads: int, kv_heads: int, index: int):
    """Which of the ``kv_heads`` KV heads a rank projects its ``q_heads``
    query heads (the block at ``index`` along ``model``) attend with:
    query head h uses KV head h // (H / KVH).  All of them where the
    queries are whole or the KV heads are split with them; where only the
    queries are split (KVH does not divide the model axis, so the KV
    projections stay whole), the KV heads that the rank's queries use: a
    slice where they group evenly, else one index a query head."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if q_heads == h or kv_heads != kvh:
        return slice(None)
    g = h // kvh
    used = [(index * q_heads + j) // g for j in range(q_heads)]
    first, count = used[0], used[-1] - used[0] + 1
    per = q_heads // count
    if q_heads % count == 0 and used == [first + j // per for j in range(q_heads)]:
        return slice(first, first + count)
    return used


def _used_kv(k, v, q_heads: int, cfg, mesh):
    """``k``, ``v`` (B, S, KVH, hd) narrowed to the KV heads that a rank's
    ``q_heads`` query heads use (`rank_kv_heads`): where only the queries
    are split, the KV heads being whole."""
    if q_heads == cfg.num_heads or k.shape[2] != cfg.num_kv_heads:
        return k, v
    heads = rank_kv_heads(cfg, q_heads, k.shape[2], mesh.coord["model"])
    return k[:, :, heads], v[:, :, heads]


def _heads_out(p: Attention, out, cfg, mesh):
    """``wo``'s product of the heads' ``out``: summed over ``model`` where
    ``p`` holds a block of the heads, or of the head_dim (of which the
    rank takes its block of ``out``'s)."""
    if p.wo.shape[0] != cfg.num_heads:
        return row_parallel(out, p.wo, mesh)
    if p.wo.shape[1] != cfg.head_dim:
        return row_parallel(head_dim_block(out, p.wo.shape[1], mesh), p.wo, mesh)
    return torch.einsum("bshe,hed->bsd", out, p.wo)


def write_kv(cache: dict, k, v, positions, mesh=None,
             seq: SeqBlock | None = None) -> None:
    """``k``, ``v`` (this rank's KV heads, or all) into ``cache``, whose
    KV heads are those or all of them (the latter ``all_gather``ed over
    ``model``); a `SeqBlock` writes this rank's slots only.  Self
    attention's new tokens, and prefill's cross K/V (`cross_kv`, at
    their positions) into a cross cache."""
    if cache["k"].shape[-2] != k.shape[2]:
        k, v = gather_heads(k, mesh), gather_heads(v, mesh)
    update_kv_cache(cache, k, v, positions, seq)


def _attend_cache(q, cache: dict, q_pos, cfg, mesh, seq: SeqBlock | None,
                  window=None, causal: bool = True):
    """One query token of this rank's heads against ``cache``.  Over the
    whole sequence, the cache's KV heads that they use; over a
    `SeqBlock` (every KV head, a block of the slots) the queries of every
    head are gathered over ``model``, attend over the rank's slots, the
    partial softmax is combined over ``seq.axes`` and the rank keeps its
    heads."""
    if seq is None:
        k, v = _used_kv(cache["k"], cache["v"], q.shape[2], cfg, mesh)
        return decode_attend(q, k, v, cache["pos"], q_pos, window=window,
                             causal=causal)
    h = q.shape[2]
    gather = h != cfg.num_heads
    out = decode_attend(gather_heads(q, mesh) if gather else q, cache["k"],
                        cache["v"], cache["pos"], q_pos, window=window,
                        causal=causal, mesh=mesh, seq=seq)
    if gather:
        i = mesh.coord["model"]
        out = out[:, :, i * h:(i + 1) * h]
    return out


def self_attention(p: Attention, x, positions, cfg, mode: str,
                   cache: dict | None = None, window=None, kv_chunk: int = 1024,
                   mesh=None, seq: SeqBlock | None = None):
    """Returns the attention output; writes ``cache`` in prefill/decode.
    A rank holding a block of the query heads (on ``mesh``) attends with
    the KV heads they use (`rank_kv_heads` where the KV projections are
    whole) and sums its partial output over ``model``.  Its cache holds
    the planner's block (`repro_torch.sharding.ParamShard.cache_blocks`):
    its KV heads, or every KV head over a block of the slots (``seq``,
    `_attend_cache`), or the whole cache."""
    q, k, v = _qkv(p, x, positions, cfg, mesh)
    if mode == "decode":
        write_kv(cache, k, v, positions, mesh, seq)
        out = _attend_cache(q, cache, positions, cfg, mesh, seq, window)
    else:
        ku, vu = _used_kv(k, v, q.shape[2], cfg, mesh)
        out = mha(q, ku, vu, positions, positions, causal=True, window=window,
                  kv_chunk=kv_chunk)
        if mode == "prefill":
            write_kv(cache, k, v, positions, mesh, seq)
    return _heads_out(p, out, cfg, mesh)


def cross_attention(p: Attention, h, enc_kv: dict, cfg, mode: str, mesh=None,
                    seq: SeqBlock | None = None, kv_chunk: int = 1024):
    """Bidirectional attention of ``h``'s queries over ``enc_kv`` (the
    encoder's K/V of this rank's KV heads or all; at decode, the cross
    cache, over a block of its positions with ``seq``)."""
    if p.wq.shape[1] != cfg.num_heads:
        h = mesh.copy_to(h)
    q = whole_head_dim(torch.einsum("bsd,dhe->bshe", h, p.wq), cfg.head_dim, mesh)
    zeros = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    if mode == "decode" and seq is not None:
        out = _attend_cache(q, enc_kv, zeros, cfg, mesh, seq, causal=False)
    else:
        k, v = _used_kv(enc_kv["k"], enc_kv["v"], q.shape[2], cfg, mesh)
        out = mha(q, k, v, zeros, enc_kv["pos"], causal=False, kv_chunk=kv_chunk)
    return _heads_out(p, out, cfg, mesh)


def _latent_attention(p: MLA, h, positions, cfg, mode, cache, kv_chunk,
                      mesh=None, seq=None):
    if mode == "decode":
        attn, _ = mla_decode(p, h, cache, positions, cfg, mesh, seq)
        return attn
    attn, new = mla_attention(p, h, positions, cfg, kv_chunk, mesh)
    if mode == "prefill":
        update_mla_cache(cache, new["c_kv"], new["k_pe"], positions, seq)
    return attn


def _attend(blk, x, positions, cfg, mode, cache, window, kv_chunk, mesh, seq):
    """Pre-norm GQA or MLA attention of a dense/MoE block."""
    h = rms_norm(x, blk.attn_norm, cfg.norm_eps)
    if cfg.use_mla:
        return _latent_attention(blk.attn, h, positions, cfg, mode, cache,
                                 kv_chunk, mesh, seq)
    return self_attention(blk.attn, h, positions, cfg, mode, cache, window,
                          kv_chunk, mesh, seq)


def _ssm(p: Mamba, h, cfg, mode, cache, mesh=None):
    """The Mamba-2 mixer of an SSM/hybrid block; prefill replaces the
    cache's state and conv tail (a rank's cache: the block of the tail's
    channels it holds), decode advances them."""
    if mode == "decode":
        out, _ = mamba_decode(p, h, cfg, cache, mesh)
        return out
    out, new = mamba_block(p, h, cfg, mesh=mesh)
    if mode == "prefill":
        conv, n = new["conv"], cache["conv"].shape[-1]
        if n != conv.shape[-1]:
            i = mesh.coord["model"]
            conv = conv[..., i * n:(i + 1) * n]
        cache["state"].copy_(new["state"])
        cache["conv"].copy_(conv)
    return out


# ------------------------------------------------------------- block bodies

class DenseBlock(nn.Module):
    """Pre-norm attention (GQA or MLA) + SwiGLU MLP (llama family)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = (MLA if cfg.use_mla else Attention)(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)

    def forward(self, x, positions, mode, cache=None, window=None,
                kv_chunk: int = 1024, mesh_info=None, seq=None):
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        x = x + _attend(self, x, positions, cfg, mode, cache, window, kv_chunk,
                        mesh, seq)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps), mesh)


class MoEBlock(nn.Module):
    """Attention (GQA or MLA) + routed-experts FFN (+ shared experts).

    With ``mesh_info = (mesh, batch_axes)`` (a mesh of ranks, from
    `repro_torch.launch.steps`) a block of the routed experts runs
    expert-parallel (`moe_ffn_sharded`), and blocks of the attention heads
    and of the shared experts' ffn dim run tensor-parallel (see the module
    docstring)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = (MLA if cfg.use_mla else Attention)(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device)
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)
        if cfg.num_shared_experts:
            self.shared = MLP(cfg.d_model, cfg.moe_d_ff * cfg.num_shared_experts,
                              dtype, device)

    def forward(self, x, positions, mode, cache=None, kv_chunk: int = 1024,
                mesh_info=None, seq=None):
        """Returns (x, aux_loss)."""
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        x = x + _attend(self, x, positions, cfg, mode, cache, None, kv_chunk,
                        mesh, seq)
        h = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        if self.moe.w_gate.shape[0] != cfg.num_experts:
            out, aux = moe_ffn_sharded(h, self.moe, cfg, mesh, mesh_info[1])
        else:
            out, aux = moe_ffn(h, self.moe, cfg.top_k, cfg.capacity_factor)
        if cfg.num_shared_experts:
            out = out + self.shared(h, mesh)
        return x + out, aux


class SSMBlock(nn.Module):
    """Pure Mamba-2 block (mamba2-780m): norm -> mixer -> residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.mamba = Mamba(cfg, dtype, device)
        self.pre_norm = _param((cfg.d_model,), dtype, device)

    def forward(self, x, positions, mode, cache=None, mesh_info=None):
        h = rms_norm(x, self.pre_norm, self.cfg.norm_eps)
        return x + _ssm(self.mamba, h, self.cfg, mode, cache, _mesh(mesh_info))


class HybridBlock(nn.Module):
    """Hymba: attention and Mamba-2 heads in parallel on the same input,
    outputs normalized and averaged, then a SwiGLU MLP."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.attn = Attention(cfg, dtype, device)
        self.mamba = Mamba(cfg, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, dtype, device)
        self.attn_norm = _param((d,), dtype, device)
        self.attn_out_norm = _param((d,), dtype, device)
        self.ssm_out_norm = _param((d,), dtype, device)
        self.mlp_norm = _param((d,), dtype, device)

    def forward(self, x, positions, mode, cache=None, window=None,
                kv_chunk: int = 1024, mesh_info=None, seq=None):
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        attn = self_attention(self.attn, h, positions, cfg, mode,
                              cache["attn"] if cache is not None else None,
                              window, kv_chunk, mesh, seq)
        ssm = _ssm(self.mamba, h, cfg, mode,
                   cache["ssm"] if cache is not None else None, mesh)
        mixed = 0.5 * (rms_norm(attn, self.attn_out_norm, cfg.norm_eps)
                       + rms_norm(ssm, self.ssm_out_norm, cfg.norm_eps))
        x = x + mixed
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps), mesh)


class CrossBlock(nn.Module):
    """Cross-attention + MLP with tanh gates (the vlm image layers).

    ``enc_kv``: {"k": (B,Se,KVH,hd), "v": ..., "pos": (B,Se)} — precomputed
    from the encoder states (static during decode); at decode on a rank,
    the cross cache's block (``seq`` where it is a block of the
    positions, `cross_attention`).
    """

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)
        self.gate_attn = _param((), torch.float32, device)
        self.gate_mlp = _param((), torch.float32, device)

    def forward(self, x, enc_kv: dict, mode: str = "train", mesh_info=None,
                seq=None):
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        attn = cross_attention(self.attn, h, enc_kv, cfg, mode, mesh, seq)
        # Gated residual (llama-3.2 style tanh gate, initialized near zero).
        x = x + torch.tanh(self.gate_attn).to(x.dtype) * attn
        h2 = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        return x + torch.tanh(self.gate_mlp).to(x.dtype) * self.mlp(h2, mesh)


class EncDecBlock(nn.Module):
    """Whisper decoder layer: causal self-attn + cross-attn + MLP."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.self_attn = Attention(cfg, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, dtype, device)
        self.self_norm = _param((d,), dtype, device)
        self.cross_norm = _param((d,), dtype, device)
        self.mlp_norm = _param((d,), dtype, device)

    def forward(self, x, positions, enc_kv: dict, mode: str, cache=None,
                kv_chunk: int = 1024, mesh_info=None, seq=None, cross_seq=None):
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        x = x + self_attention(self.self_attn,
                               rms_norm(x, self.self_norm, cfg.norm_eps),
                               positions, cfg, mode, cache, None, kv_chunk,
                               mesh, seq)
        h = rms_norm(x, self.cross_norm, cfg.norm_eps)
        x = x + cross_attention(self.cross_attn, h, enc_kv, cfg, mode, mesh,
                                cross_seq, kv_chunk)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps), mesh)


class EncoderBlock(nn.Module):
    """Bidirectional self-attention + MLP (whisper encoder)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)

    def forward(self, x, positions, kv_chunk: int = 1024, mesh_info=None):
        cfg = self.cfg
        mesh = _mesh(mesh_info)
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(self.attn, h, positions, cfg, mesh)
        k, v = _used_kv(k, v, q.shape[2], cfg, mesh)
        out = mha(q, k, v, positions, positions, causal=False, kv_chunk=kv_chunk)
        x = x + _heads_out(self.attn, out, cfg, mesh)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps), mesh)


def cross_kv(attn: Attention, enc_states: torch.Tensor, cfg=None,
             mesh=None) -> dict:
    """Precompute cross-attention K/V from encoder states; on a rank
    holding a block of the query heads (``cfg``, ``mesh``), of its KV heads
    (or all, where they are whole; then they pass `Mesh.copy_to`, as the
    states do); where ``wk``/``wv`` hold a block of the head_dim, it is
    gathered whole."""
    wk, wv = attn.wk, attn.wv
    if cfg is not None and attn.wq.shape[1] != cfg.num_heads:
        enc_states = mesh.copy_to(enc_states)
        if wk.shape[1] == cfg.num_kv_heads:
            wk, wv = mesh.copy_to(wk), mesh.copy_to(wv)
    k = torch.einsum("bsd,dhe->bshe", enc_states, wk)
    v = torch.einsum("bsd,dhe->bshe", enc_states, wv)
    if cfg is not None:
        k, v = (whole_head_dim(t, cfg.head_dim, mesh) for t in (k, v))
    b, s = enc_states.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=enc_states.device).expand(b, s)
    return {"k": k, "v": v, "pos": pos}


# ---------------------------------------------------------------- caches

def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device, window_len: int | None = None,
                     lead: tuple[int, ...] = ()):
    """Cache dict of the given kind for ``lead`` stacked layers."""
    if kind == "mla":
        return init_mla_cache(batch, cache_len, cfg, dtype, device, lead)
    length = window_len if window_len is not None else cache_len
    if kind == "attn":
        return init_kv_cache(batch, length, cfg.num_kv_heads, cfg.head_dim,
                             dtype, device, lead)
    if kind == "ssm":
        return init_mamba_cache(batch, cfg, dtype, device, lead)
    if kind == "hybrid":
        return {"attn": init_kv_cache(batch, length, cfg.num_kv_heads,
                                      cfg.head_dim, dtype, device, lead),
                "ssm": init_mamba_cache(batch, cfg, dtype, device, lead)}
    raise ValueError(kind)
