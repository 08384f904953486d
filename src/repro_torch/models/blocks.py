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
of each leaf instead, and the forward reads what it holds from the
tensors' shapes: a block of the query heads (``wq``/``wo``) or of the
MLP's ffn dim (``w_gate``/``w_up``/``w_down``) makes a partial sum of
the output, which one ``all_reduce`` over ``model`` completes
(Megatron's column- then row-parallel pair; `_row_parallel`); a block of
the routed experts runs `moe_ffn_sharded`.  ``mesh_info = (mesh,
batch_axes)`` carries the rank mesh there.  For training, the input of
each column-parallel product (the normed ``x`` before ``wq``/``wk``/``wv``
and before ``w_gate``/``w_up``) passes `Mesh.copy_to`, whose backward
sums its gradient over ``model``, and so do the replicated weights that
each rank uses for its own heads only (``wk``/``wv`` where the KV heads
stay whole, ``q_norm``/``k_norm``).  `_row_parallel`'s output is the
reference's ``tp_collective_out`` point: under the ``"save_collectives"``
remat policy (`repro_torch.models.model`) it is kept, and the backward's
recomputation neither multiplies nor sums it again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import decode_attend, init_kv_cache, mha, update_kv_cache
from .layers import apply_rope, rms_norm, swiglu
from .mamba2 import init_mamba_cache, mamba_block, mamba_decode
from .mla import init_mla_cache, mla_attention, mla_decode, update_mla_cache
from .moe import moe_ffn, moe_ffn_sharded
from .remat import kept

__all__ = ["Attention", "MLA", "MLP", "MoE", "Mamba", "DenseBlock", "MoEBlock",
           "SSMBlock", "HybridBlock", "CrossBlock", "EncDecBlock",
           "EncoderBlock", "cross_kv", "init_block_cache", "rank_kv_heads"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


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


def _row_parallel(x, w, mesh):
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
        return _row_parallel(h, self.w_down, mesh)


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
    `Mesh.copy_to` (their gradients are summed over ``model``)."""
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


def self_attention(p: Attention, x, positions, cfg, mode: str,
                   cache: dict | None = None, window=None, kv_chunk: int = 1024,
                   mesh=None):
    """Returns the attention output; writes ``cache`` in prefill/decode.
    A rank holding a block of the query heads (on ``mesh``) attends with
    the KV heads they use (`rank_kv_heads`; the cache holds only those)
    and sums its partial output over ``model``."""
    q, k, v = _qkv(p, x, positions, cfg, mesh)
    split = q.shape[2] != cfg.num_heads
    if split:
        heads = rank_kv_heads(cfg, q.shape[2], k.shape[2], mesh.coord["model"])
        k, v = k[:, :, heads], v[:, :, heads]
    if mode == "decode":
        update_kv_cache(cache, k, v, positions)
        out = decode_attend(q, cache["k"], cache["v"], cache["pos"], positions,
                            window=window)
    else:
        out = mha(q, k, v, positions, positions, causal=True, window=window,
                  kv_chunk=kv_chunk)
        if mode == "prefill":
            update_kv_cache(cache, k, v, positions)
    if split:
        return _row_parallel(out, p.wo, mesh)
    return torch.einsum("bshe,hed->bsd", out, p.wo)


def _latent_attention(p: MLA, h, positions, cfg, mode, cache, kv_chunk):
    if mode == "decode":
        attn, _ = mla_decode(p, h, cache, positions, cfg)
        return attn
    attn, new = mla_attention(p, h, positions, cfg, kv_chunk)
    if mode == "prefill":
        update_mla_cache(cache, new["c_kv"], new["k_pe"], positions)
    return attn


def _attend(blk, x, positions, cfg, mode, cache, window, kv_chunk, mesh):
    """Pre-norm GQA or MLA attention of a dense/MoE block."""
    h = rms_norm(x, blk.attn_norm, cfg.norm_eps)
    if cfg.use_mla:
        return _latent_attention(blk.attn, h, positions, cfg, mode, cache,
                                 kv_chunk)
    return self_attention(blk.attn, h, positions, cfg, mode, cache, window,
                          kv_chunk, mesh)


def _ssm(p: Mamba, h, cfg, mode, cache):
    """The Mamba-2 mixer of an SSM/hybrid block; prefill replaces the
    cache's state and conv tail, decode advances them."""
    if mode == "decode":
        out, _ = mamba_decode(p, h, cfg, cache)
        return out
    out, new = mamba_block(p, h, cfg)
    if mode == "prefill":
        cache["state"].copy_(new["state"])
        cache["conv"].copy_(new["conv"])
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
                kv_chunk: int = 1024, mesh_info=None):
        cfg = self.cfg
        mesh = mesh_info[0] if mesh_info is not None else None
        x = x + _attend(self, x, positions, cfg, mode, cache, window, kv_chunk,
                        mesh)
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
                mesh_info=None):
        """Returns (x, aux_loss)."""
        cfg = self.cfg
        mesh = mesh_info[0] if mesh_info is not None else None
        x = x + _attend(self, x, positions, cfg, mode, cache, None, kv_chunk,
                        mesh)
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

    def forward(self, x, positions, mode, cache=None):
        h = rms_norm(x, self.pre_norm, self.cfg.norm_eps)
        return x + _ssm(self.mamba, h, self.cfg, mode, cache)


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
                kv_chunk: int = 1024):
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        attn = self_attention(self.attn, h, positions, cfg, mode,
                              cache["attn"] if cache is not None else None,
                              window, kv_chunk)
        ssm = _ssm(self.mamba, h, cfg, mode,
                   cache["ssm"] if cache is not None else None)
        mixed = 0.5 * (rms_norm(attn, self.attn_out_norm, cfg.norm_eps)
                       + rms_norm(ssm, self.ssm_out_norm, cfg.norm_eps))
        x = x + mixed
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps))


class CrossBlock(nn.Module):
    """Cross-attention + MLP with tanh gates (the vlm image layers).

    ``enc_kv``: {"k": (B,Se,KVH,hd), "v": ..., "pos": (B,Se)} — precomputed
    from the encoder states (static during decode).
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

    def forward(self, x, enc_kv: dict):
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = torch.einsum("bsd,dhe->bshe", h, self.attn.wq)
        out = mha(q, enc_kv["k"], enc_kv["v"],
                  torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device),
                  enc_kv["pos"], causal=False, kv_chunk=1024)
        attn = torch.einsum("bshe,hed->bsd", out, self.attn.wo)
        # Gated residual (llama-3.2 style tanh gate, initialized near zero).
        x = x + torch.tanh(self.gate_attn).to(x.dtype) * attn
        h2 = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        return x + torch.tanh(self.gate_mlp).to(x.dtype) * self.mlp(h2)


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
                kv_chunk: int = 1024):
        cfg = self.cfg
        x = x + self_attention(self.self_attn,
                               rms_norm(x, self.self_norm, cfg.norm_eps),
                               positions, cfg, mode, cache, None, kv_chunk)
        h = rms_norm(x, self.cross_norm, cfg.norm_eps)
        q = torch.einsum("bsd,dhe->bshe", h, self.cross_attn.wq)
        out = mha(q, enc_kv["k"], enc_kv["v"],
                  torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device),
                  enc_kv["pos"], causal=False, kv_chunk=kv_chunk)
        x = x + torch.einsum("bshe,hed->bsd", out, self.cross_attn.wo)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps))


class EncoderBlock(nn.Module):
    """Bidirectional self-attention + MLP (whisper encoder)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)

    def forward(self, x, positions, kv_chunk: int = 1024):
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(self.attn, h, positions, cfg)
        out = mha(q, k, v, positions, positions, causal=False, kv_chunk=kv_chunk)
        x = x + torch.einsum("bshe,hed->bsd", out, self.attn.wo)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps))


def cross_kv(attn: Attention, enc_states: torch.Tensor) -> dict:
    """Precompute cross-attention K/V from encoder states."""
    k = torch.einsum("bsd,dhe->bshe", enc_states, attn.wk)
    v = torch.einsum("bsd,dhe->bshe", enc_states, attn.wv)
    b, s = enc_states.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=enc_states.device).expand(b, s)
    return {"k": k, "v": v, "pos": pos}


# ---------------------------------------------------------------- caches

def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device, window_len: int | None = None,
                     lead: tuple[int, ...] = (), kv_heads: int | None = None):
    """Cache dict of the given kind for ``lead`` stacked layers;
    ``kv_heads``: the KV heads an "attn" cache holds (default all: a rank
    holds those its query heads use, `rank_kv_heads`)."""
    if kind == "mla":
        return init_mla_cache(batch, cache_len, cfg, dtype, device, lead)
    length = window_len if window_len is not None else cache_len
    if kind == "attn":
        return init_kv_cache(batch, length, kv_heads or cfg.num_kv_heads,
                             cfg.head_dim, dtype, device, lead)
    if kind == "ssm":
        return init_mamba_cache(batch, cfg, dtype, device, lead)
    if kind == "hybrid":
        return {"attn": init_kv_cache(batch, length, cfg.num_kv_heads,
                                      cfg.head_dim, dtype, device, lead),
                "ssm": init_mamba_cache(batch, cfg, dtype, device, lead)}
    raise ValueError(kind)
