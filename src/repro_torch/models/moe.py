"""Mixture-of-Experts (sort-based capacity dispatch), single shard and
expert-parallel.

Each token's top-k experts are dispatched into a dense (E_local,
capacity, D) buffer (a stable sort + cumulative rank, no (T, E, C) one-hot
tensor is ever built), the expert SwiGLUs run as batched matmuls, and the
weighted outputs are combined back per token.

Two orders are pinned so that results are the reference's and repeat
bitwise on the card: the router's top-k takes the first ``top_k`` of a
stable descending sort (ties go to the lower expert index, as
``jax.lax.top_k`` orders them; ``torch.topk`` promises no order on ties,
which bf16 router logits make common), and the combine un-sorts the
(token, k) pairs and sums each token's k contributions in k order instead
of a scatter-add, whose order on CUDA is not fixed.

`moe_ffn_sharded` is the reference's expert-parallel MoE on a mesh of
ranks (`repro_torch.launch.mesh.make_rank_mesh`): the tokens are
replicated over the model axis inside the block, each rank holds the
experts of its model coordinate and dispatches only the tokens routed to
them, and one ``all_reduce`` over the model axis sums the experts'
contributions — the body of the reference's ``shard_map``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn", "router_topk", "moe_ffn_sharded"]


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids below ``n``, by an
    integer ``index_add_``: exact in any order, and it has a meta kernel,
    which ``bincount`` (whose output size depends on the values) lacks."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int64))


def router_topk(logits: torch.Tensor, top_k: int):
    """Softmax-then-top-k with renormalized combine weights.

    logits: (T, E). Returns (weights (T, K) f32, experts (T, K) int64,
    aux_loss scalar) — aux is the standard load-balance term E * sum(f * P).
    """
    probs = torch.softmax(logits.float(), dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :top_k], experts[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    # f_e: fraction of tokens whose top-1 hits e; P_e: mean router prob.
    top1 = experts[:, 0]
    f = _bincount(top1, e).float() / top1.shape[0]
    p_mean = probs.mean(0)
    aux = e * torch.sum(f * p_mean)
    return weights, experts, aux


def _dispatch_combine(
    x: torch.Tensor,  # (T, D)
    weights: torch.Tensor,  # (T, K)
    experts: torch.Tensor,  # (T, K) global expert ids
    w_gate: torch.Tensor,  # (E_loc, D, F)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E_loc, F, D)
    e_start: int,
    capacity: int,
) -> torch.Tensor:
    t, d = x.shape
    k = weights.shape[1]
    e_loc = w_gate.shape[0]
    dev = x.device

    flat_e = experts.reshape(-1) - e_start  # (T*K,) local expert index
    flat_w = weights.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    local = (flat_e >= 0) & (flat_e < e_loc)
    # Non-local pairs sort to a sentinel bucket past the real experts.
    sort_key = torch.where(local, flat_e, e_loc)
    _, order = torch.sort(sort_key, stable=True)
    se, st, sw = sort_key[order], flat_t[order], flat_w[order]
    # Rank within each expert: position in the sorted list minus the
    # expert's first position.
    counts = _bincount(se, e_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.shape[0], device=dev) - starts[se]
    keep = (se < e_loc) & (rank < capacity)
    slot = torch.where(keep, se * capacity + rank,
                       torch.full_like(se, e_loc * capacity))  # overflow slot

    buf = torch.zeros((e_loc * capacity + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], x[st], 0)
    buf = buf[:-1].reshape(e_loc, capacity, d)

    g = F.silu(torch.bmm(buf, w_gate))
    u = torch.bmm(buf, w_up)
    y = torch.bmm(g * u, w_down)  # (E_loc, C, D)

    y_flat = torch.cat([y.reshape(e_loc * capacity, d),
                        torch.zeros((1, d), dtype=y.dtype, device=dev)])
    gathered = y_flat[slot] * sw[:, None].to(y.dtype)  # (T*K, D), sorted order
    gathered = torch.where(keep[:, None], gathered, 0)
    # Undo the sort (the pre-sort index of a pair is t*K + k) and sum each
    # token's K contributions in k order.
    unsorted = torch.empty_like(gathered)
    unsorted[order] = gathered
    parts = unsorted.reshape(t, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def moe_ffn(
    x: torch.Tensor,  # (B, S, D) or (T, D)
    p,  # router (D, E); w_gate/w_up (E, D, F); w_down (E, F, D)
    top_k: int,
    capacity_factor: float = 1.25,
    e_start: int = 0,
    num_experts_global: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-shard MoE. Returns (out, aux_loss)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = x2.shape[0]
    e_glob = num_experts_global or p.w_gate.shape[0]
    logits = x2 @ p.router.to(x2.dtype)
    weights, experts, aux = router_topk(logits, top_k)
    # Floor of top_k*2 keeps tiny decode batches drop-free (a dropped token
    # at serve time would silently change the served distribution).
    capacity = max(int(capacity_factor * t * top_k / e_glob), 2 * top_k)
    out = _dispatch_combine(x2, weights.to(x2.dtype), experts,
                            p.w_gate, p.w_up, p.w_down, e_start, capacity)
    return out.reshape(shape), aux


def moe_ffn_sharded(
    x: torch.Tensor,  # (B_local, S, D): this rank's rows of the batch
    p,  # router (D, E); this rank's experts: w_gate/w_up (E/n, D, F), w_down
    cfg,
    mesh,
    batch_axes: tuple[str, ...],
    expert_axis: str = "model",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on a mesh of ranks; returns (out, aux) of this
    rank's rows.

    The rank at index ``i`` of ``expert_axis`` (n positions) holds the
    experts ``[i·E/n, (i+1)·E/n)`` and runs `moe_ffn` on them with the
    global capacity formula (``num_experts_global=E``), so it drops what
    the unsharded MoE drops on the same rows.  ``out`` is summed over
    ``expert_axis`` (the same bits on each of its ranks); ``aux`` is
    averaged over ``expert_axis``, then over ``batch_axes``, whose ranks
    hold the other rows (the reference's ``pmean``s).

    Backward (`repro_torch.launch.mesh`): ``x`` and the router pass
    ``copy_to`` over ``expert_axis``, since each rank's gradient of them
    covers only its experts' combine weights (and its share of ``aux``);
    the sums' backward is the identity over ``expert_axis`` and a sum
    over ``batch_axes``."""
    if mesh.ranks is None:
        raise ValueError("moe_ffn_sharded runs on a mesh of ranks "
                         "(repro_torch.launch.mesh.make_rank_mesh)")
    n = mesh.shape[expert_axis]
    e_glob = cfg.num_experts
    e_loc = p.w_gate.shape[0]
    if e_glob % n or e_loc * n != e_glob:
        raise ValueError(f"{e_loc} experts a rank do not split {e_glob} over "
                         f"{expert_axis}={n}")
    x = mesh.copy_to(x, expert_axis)
    p = SimpleNamespace(router=mesh.copy_to(p.router, expert_axis),
                        w_gate=p.w_gate, w_up=p.w_up, w_down=p.w_down)
    out, aux = moe_ffn(x, p, cfg.top_k, cfg.capacity_factor,
                       e_start=mesh.coord[expert_axis] * e_loc,
                       num_experts_global=e_glob)
    out = mesh.all_reduce(out, expert_axis)
    aux = mesh.all_reduce(aux, expert_axis) / n
    if batch_axes:
        aux = mesh.all_reduce(aux, batch_axes) / mesh.size(batch_axes)
    return out, aux
