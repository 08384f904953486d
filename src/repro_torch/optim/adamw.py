"""AdamW with warmup+cosine schedule, global-norm clipping, and optional
int8 gradient compression (stochastic rounding) for the cross-replica
reduce — torch ops on tensors, no ``torch.optim``.

The update runs the reference's operations in the reference's order, in
f32, so that it rounds as the reference does (``torch.optim.AdamW``
rounds differently: it decays as ``p * (1 - lr * wd)`` and divides by
``sqrt(v) / sqrt(bc2)``).  A ``scalar / tensor`` is written as a tensor
division: torch computes it as a reciprocal times the scalar.

``params`` is a `repro_torch.models.Model` or a nested dict of tensors.
For a model, the moments are dicts keyed by parameter name, the leaves
are visited in the reference tree's leaf order (sorted keys; a layer
stack's layers in stack order), and weight decay applies where the
reference's *stacked* leaf has ``ndim >= 2`` — a layer's (d,) norm scale
is one row of an (L, d) leaf there, so it is decayed, and ``final_norm``
is not.  For a dict, the moments mirror the dict and each tensor is its
own leaf.  The update writes parameters and moments in place.

Optimizer moments are kept in fp32 by default regardless of parameter
dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "compress_grads"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0
    compress_int8: bool = False
    # "float32" (default, exact) or "bfloat16": halves optimizer HBM traffic
    # and footprint; update math still runs in fp32 (§Perf lever A3/B3).
    moment_dtype: str = "float32"


def _flatten(tree, prefix: str = "") -> dict:
    """A nested dict's leaves by '/'-joined key path, in sorted key order
    (the reference's leaf order); a flat dict keeps its keys."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _param_tree(params):
    """A model's parameters by name, or the dict itself."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return params


def _leaf_groups(params) -> list[tuple[int, list[tuple[str, torch.Tensor]]]]:
    """(the reference leaf's ndim, [(key, tensor), ...]) in the reference's
    leaf order; keys are those of `_flatten` over the moment dicts."""
    if hasattr(params, "reference_leaves"):
        names = {id(p): n for n, p in params.named_parameters()}
        leaves = params.reference_leaves()
        return [(len(leaves[k][0]), [(names[id(p)], p) for _, p in leaves[k][1]])
                for k in sorted(leaves)]
    return [(t.dim(), [(k, t)]) for k, t in _flatten(params).items()]


def init_opt_state(params, moment_dtype: str = "float32") -> dict:
    """{"m", "v": zeros like each parameter in ``moment_dtype``, "step": an
    int32 0-d tensor}, on the parameters' device."""
    dt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    tree = _param_tree(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(iter(_flatten(tree).values())).device
    return {"m": _map(zeros, tree), "v": _map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _quantize(g: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-tensor absmax/127 scaling, stochastic rounding with ``noise``
    (uniform in [-0.5, 0.5)), int8, back to f32."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    scaled = g32 / scale
    q8 = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q8.float() * scale


def compress_grads(grads, generator: torch.Generator):
    """Simulated int8 all-reduce compression: per-tensor absmax scaling with
    stochastic rounding, quantize -> dequantize.  On hardware the int8
    tensors ride the wire (4x fewer gradient bytes on the data axis); the
    numerics here are bit-identical to that path.  Each leaf (in sorted
    key order) draws its noise from ``generator``, which must live on the
    leaves' device."""
    def one(g):
        noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                           device=g.device) - 0.5
        return _quantize(g, noise)

    return _map(one, grads)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig) -> dict:
    """One AdamW step in place: the parameters, ``state["m"]`` and
    ``state["v"]`` are written, ``state["step"]`` replaced.  ``grads`` is
    keyed as the moments (a missing or None entry is a zero gradient).
    Returns {"grad_norm" (before clipping), "lr"} as 0-d f32 tensors."""
    groups = _leaf_groups(params)
    flat_g = _flatten(grads)
    flat_m, flat_v = _flatten(state["m"]), _flatten(state["v"])
    step = state["step"] + 1
    # Global-norm clip in fp32, summed in the reference's leaf order.
    total = torch.zeros((), dtype=torch.float32, device=step.device)
    for _, items in groups:
        leaf = None
        for key, _p in items:
            g = flat_g.get(key)
            if g is not None:
                sq = torch.sum(torch.square(g.float()))
                leaf = sq if leaf is None else leaf + sq
        if leaf is not None:
            total = total + leaf
    gnorm = torch.sqrt(total)
    clip = torch.full((), cfg.clip_norm, dtype=torch.float32, device=step.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    for ndim, items in groups:
        for key, p in items:
            g, m, v = flat_g.get(key), flat_m[key], flat_v[key]
            g32 = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   if g is None else g.float()) * scale
            m_new = m.float() * b1 + g32 * (1 - b1)
            v_new = v.float() * b2 + g32 * (1 - b2) * g32
            delta = (m_new / bc1).div_(torch.sqrt(v_new / bc2).add_(cfg.eps))
            if ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(p.float() * cfg.weight_decay)
            p.copy_(p.float() - delta.mul_(lr))
            m.copy_(m_new)
            v.copy_(v_new)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
