"""Attention: GQA / sliding-window / cross / decode, flash-style blockwise.

One position-mask-driven implementation covers every flavor the
architectures need:
  * causal full attention (train / prefill),
  * grouped-query attention (no KV head repeat is materialized — the query
    is reshaped to (B, S, KVH, G, hd) and contractions keep the group dim;
    G comes from the tensors, so a rank's block of query heads attends with
    the KV heads they use),
  * sliding-window attention with an exact ring-buffer KV cache,
  * bidirectional encoder and cross attention (causal=False),
  * single-token decode against a KV cache.

Softmax runs in fp32 with the online (running max / denominator) update,
looping over KV chunks so the score tensor never exceeds one
(B, Sq, KVH, G, chunk) block.  Invalid cache slots carry position -1 and
are masked out, so ragged lengths need no special casing.

The score and P·V products take bf16 operands to an f32 result, as the
reference asks with ``preferred_element_type=float32``: the operands are
upcast (bf16 products are exact in f32), and ``p`` is rounded to the value
dtype first, where the reference rounds it.  A fully masked chunk scores
``NEG_INF = -1e30`` (not ``-inf``): its weights are exp(0) = 1 until the
next chunk's correction exp(m - m_new) takes them to 0.

A rank of a mesh of ranks may hold a block of a cache's sequence slots
(`SeqBlock`: the planner's ``seq`` mode, `repro_torch.sharding.ParamShard.
cache_blocks`).  It writes only the slots of its block (`write_slots`)
and attends over them with a partial softmax (`seq_softmax`): the row
maximum over the slot holders (one ``all_max``), the weights against it,
and their sum and weighted values summed over the holders (one
``all_reduce`` of both), divided once at the end.  The max and the sums
are f32.

A projection may hold a block of its head_dim instead (the planner's
``shard_head_dim_fallback``, where the heads do not divide the model
axis): its output's last dim is gathered whole before the norm and rope
(`whole_head_dim`), and the output projection takes the rank's block of
the attention output's head_dim (`head_dim_block`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["mha", "decode_attend", "init_kv_cache", "update_kv_cache",
           "SeqBlock", "write_slots", "seq_softmax", "gather_heads",
           "whole_head_dim", "head_dim_block"]

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    """(B, Sq, C) boolean validity from absolute positions.

    q_pos: (B, Sq); k_pos: (B, C).  k_pos == -1 marks empty cache slots.
    """
    valid = (k_pos >= 0)[:, None, :]  # (B, 1, C)
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return valid


def _group(h: int, kvh: int) -> int:
    """The query heads a KV head serves, from the local tensors' head
    counts (a rank's query heads and the KV heads they use)."""
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    return h // kvh


def mha(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KVH, hd)
    v: torch.Tensor,  # (B, Skv, KVH, hd)
    q_pos: torch.Tensor,  # (B, Sq) int32
    k_pos: torch.Tensor,  # (B, Skv) int32; -1 = invalid slot
    *,
    causal: bool = True,
    window: int | None = None,
    kv_chunk: int = 1024,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    g = _group(h, kvh)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5

    chunk = min(kv_chunk, skv)
    if skv % chunk:
        pad = chunk - skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        skv += pad
    nc = skv // chunk

    qg = q.reshape(b, sq, kvh, g, hd).float()
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32, device=q.device)
    for c in range(nc):
        k_i = k[:, c * chunk:(c + 1) * chunk]
        v_i = v[:, c * chunk:(c + 1) * chunk]
        p_i = k_pos[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, k_i.float()) * scale
        ok = _mask(q_pos, p_i, causal, window)  # (B,Sq,C)
        s = torch.where(ok[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(v_i.dtype).float(), v_i.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


@dataclass(frozen=True)
class SeqBlock:
    """A rank's block of a cache's sequence slots: slots ``[start, start +
    n)`` of ``whole`` (n the cache tensor's own length), the other blocks
    held by the ranks along ``axes``."""
    axes: tuple[str, ...]
    start: int
    whole: int


def seq_softmax(s: torch.Tensor, ok: torch.Tensor, values, mesh,
                seq: SeqBlock | None) -> torch.Tensor:
    """softmax(s) over the last dim, masked by ``ok``, applied by
    ``values(p)`` (the f32 weighted sum of the values, its last dim the
    value dim, the slot dim contracted).  Over a whole cache, the
    softmax (``p`` rounded as ``values`` rounds it); over a `SeqBlock`,
    the partial softmax combined over ``seq.axes`` (module docstring)."""
    s = torch.where(ok, s, NEG_INF)
    if seq is None:
        return values(torch.softmax(s, dim=-1))
    m = mesh.all_max(torch.amax(s, dim=-1), seq.axes)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    both = torch.cat([values(p), p.sum(-1)[..., None]], dim=-1)
    both = mesh.all_reduce(both, seq.axes)
    return both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)


def gather_heads(t: torch.Tensor, mesh) -> torch.Tensor:
    """(..., h, e) of this rank's block of heads -> (..., n h, e): the
    blocks of the ``n`` ranks along ``model``, in their order."""
    return mesh.all_gather(t, "model").movedim(0, -3).flatten(-3, -2)


def whole_head_dim(t: torch.Tensor, whole: int, mesh) -> torch.Tensor:
    """``t`` (..., e) with its last dim whole (``whole``): where it holds
    this rank's block of it (a projection holding a head_dim block), the
    blocks of the ranks along ``model`` gathered in their order."""
    if t.shape[-1] == whole:
        return t
    return mesh.all_gather(t, "model").movedim(0, -2).flatten(-2)


def head_dim_block(t: torch.Tensor, block: int, mesh) -> torch.Tensor:
    """This rank's block of ``block`` elements of ``t``'s last dim (the
    whole ``t`` where it has that size already)."""
    if t.shape[-1] == block:
        return t
    i = mesh.coord["model"]
    return t[..., i * block:(i + 1) * block]


def decode_attend(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KVH, hd)
    v_cache: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, S) int32 absolute positions, -1 = empty
    q_pos: torch.Tensor,  # (B, 1)
    *,
    window: int | None = None,
    softmax_scale: float | None = None,
    causal: bool = True,
    mesh=None,
    seq: SeqBlock | None = None,
) -> torch.Tensor:
    """Single-token decode: one fused pass (no chunk loop needed at Sq=1);
    over a `SeqBlock` of the cache, the partial softmax combined over
    ``seq.axes`` on ``mesh`` (`seq_softmax`)."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = _group(h, kvh)
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qg = q.reshape(b, 1, kvh, g, hd).float()
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k_cache.float()) * scale
    ok = _mask(q_pos, cache_pos, causal, window)[:, :, None, None, :]
    out = seq_softmax(s, ok, lambda p: torch.einsum(
        "bqkgc,bckd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float()),
        mesh, seq)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def init_kv_cache(batch: int, length: int, kvh: int, hd: int, dtype,
                  device, lead: tuple[int, ...] = ()) -> dict:
    """A {k, v, pos} cache; ``lead`` prepends stack dims (layers)."""
    return {
        "k": torch.zeros(lead + (batch, length, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, length, kvh, hd), dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32, device=device),
    }


def write_slots(cache: dict, new: dict, positions: torch.Tensor,
                seq: SeqBlock | None = None) -> dict:
    """Write each ``new[name]`` (B, S_new, ...) and the positions (as
    ``cache["pos"]``) at slot ``position % length`` of ``cache`` in
    place, ``length`` the whole cache's; with a `SeqBlock` only the
    tokens whose slot lies in this rank's block, at its offset there.
    If more tokens arrive than the cache holds (SWA prefill), only the
    trailing ``length`` are written, so every (b, slot) pair is written
    once and the newest entries deterministically win."""
    length = seq.whole if seq is not None else cache["pos"].shape[-1]
    new = dict(new, pos=positions.to(torch.int32))
    if positions.shape[1] > length:
        new = {k: v[:, -length:] for k, v in new.items()}
        positions = positions[:, -length:]
    b, s_new = positions.shape
    b_idx = torch.arange(b, device=positions.device)[:, None]
    slots = (positions % length).long()
    if seq is None:
        for k, v in new.items():
            cache[k][b_idx, slots] = v.to(cache[k].dtype)
        return cache
    n = cache["pos"].shape[-1]
    local = slots - seq.start
    inside = (local >= 0) & (local < n)
    if s_new == 1:  # one slot a row: keep what the slot holds where outside
        at = local.clamp(0, n - 1)
        for k, v in new.items():
            old = cache[k][b_idx, at]
            keep = inside.reshape(inside.shape + (1,) * (v.dim() - 2))
            cache[k][b_idx, at] = torch.where(keep, v.to(old.dtype), old)
        return cache
    # Which token each local slot takes, if any: the tokens outside the
    # block go to a spare slot n, dropped.
    src = torch.full((b, n + 1), -1, dtype=torch.long, device=positions.device)
    src.scatter_(1, torch.where(inside, local, n),
                 torch.arange(s_new, device=positions.device).expand(b, s_new))
    src = src[:, :n]
    took = src >= 0
    src = src.clamp(min=0)
    for k, v in new.items():
        keep = took.reshape(took.shape + (1,) * (v.dim() - 2))
        cache[k].copy_(torch.where(keep, v[b_idx, src].to(cache[k].dtype),
                                   cache[k]))
    return cache


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    positions: torch.Tensor, seq: SeqBlock | None = None) -> dict:
    """Write new K/V at their positions, modulo the cache length, in place.

    Full caches (length >= max position) see the identity mapping; shorter
    (sliding-window) caches behave as ring buffers (`write_slots`; a
    `SeqBlock` writes this rank's slots only).

    k_new/v_new: (B, S_new, KVH, hd); positions: (B, S_new).
    """
    return write_slots(cache, {"k": k_new, "v": v_new}, positions, seq)
