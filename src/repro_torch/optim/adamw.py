"""AdamW with warmup+cosine schedule, global-norm clipping, and optional
int8 gradient compression (stochastic rounding) for the cross-replica
reduce — torch ops on tensors, no ``torch.optim``.

The update runs the reference's operations in the reference's order, in
f32, so that it rounds as the reference does (``torch.optim.AdamW``
rounds differently: it decays as ``p * (1 - lr * wd)`` and divides by
``sqrt(v) / sqrt(bc2)``).  A ``scalar / tensor`` is written as a tensor
division: torch computes it as a reciprocal times the scalar.

``params`` is a `repro_torch.models.Model` or a nested dict of tensors.
For a model the moments are keyed by the reference leaf's path
(``"layers/attn/wq"``), each the leaf stacked as the reference stacks
it (its layers in stack order), so that they are the reference's
optimizer state; the leaves are visited in the reference tree's leaf
order (sorted keys), and weight decay applies where the stacked leaf
has ``ndim >= 2`` — a layer's (d,) norm scale is one row of an (L, d)
leaf there, so it is decayed, and ``final_norm`` is not.  For a dict,
the moments mirror the dict and each tensor is its own leaf.  The
update writes parameters and moments in place.

On a rank of a mesh of ranks (``mesh_info = (mesh, batch_axes)``, a
`repro_torch.models.Model` holding its position's blocks) each moment
is the block of the stacked leaf that the position holds of it: the
model's block, cut once more over the batch axes on the first
dimension it leaves free (``zero1``; `repro_torch.sharding.planner.zero1_spec`,
the rule of ``plan_opt_state`` applied to what the rank holds).  The
update takes the mean gradient over the batch axes (``reduce_scatter``
to the moment's block under ZeRO-1, else ``all_reduce``; one
collective a leaf, on its stacked layers), sums the squares for the
global norm once over the whole model (a leaf split over ``model``
summed over it, a replicated leaf counted once, a ZeRO-1 block summed
over the batch axes), updates its block elementwise as one card does,
and ``all_gather``s the parameter over the batch axes where the moments
are cut.

Optimizer moments are kept in fp32 by default regardless of parameter
dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.sharding.planner import ShardingPlan, shard_slices, zero1_spec

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "compress_grads",
           "rank_leaves"]


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


@dataclass(frozen=True)
class RankLeaf:
    """A reference leaf as a rank holds it: its path (the moments' key),
    its layers' parameter names in stack order, its stacked shape on the
    rank (``lead`` stack dims, then a layer's block), whether its blocks
    are split over ``model``, the dimension ZeRO-1 cuts over the batch
    axes (None: none) with the rank's block of it, the whole stacked
    leaf's shape and a layer's block of the whole layer, and the specs
    (`repro_torch.sharding.shard_slices`' form) under which the rank
    holds its block of the whole stacked leaf: the parameter's (its
    dims on ``model``) and the moments' (ZeRO-1's dim on the batch axes
    too)."""
    path: str
    names: tuple[str, ...]
    lead: tuple[int, ...]
    shape: tuple[int, ...]
    split: bool
    zdim: int | None
    zblock: slice | None
    whole: tuple[int, ...]
    layer_block: tuple[slice, ...]
    spec: tuple = ()
    moment_spec: tuple = ()

    @property
    def moment_shape(self) -> tuple[int, ...]:
        if self.zdim is None:
            return self.shape
        shape = list(self.shape)
        shape[self.zdim] = len(range(shape[self.zdim])[self.zblock])
        return tuple(shape)

    @property
    def moment_block(self) -> tuple[slice, ...]:
        """The moments' block of the whole stacked leaf."""
        block = [slice(0, n) for n in self.lead] + list(self.layer_block)
        if self.zdim is not None:  # a dimension the model leaves whole
            block[self.zdim] = self.zblock
        return tuple(block)


def rank_leaves(params, mesh_info=None, zero1: bool = False) -> list[RankLeaf]:
    """The leaves of ``params`` in the reference's leaf order, as
    `RankLeaf`s: a model's stacked leaves, on the mesh of ``mesh_info =
    (mesh, batch_axes)`` for a rank's model; a dict's tensors, each its
    own leaf under its '/'-joined key."""
    if not hasattr(params, "reference_leaves"):
        return [RankLeaf(path, (path,), (), tuple(t.shape), False, None, None,
                         tuple(t.shape), tuple(slice(0, n) for n in t.shape))
                for path, t in _flatten(params).items()]
    model = params
    mesh, batch_axes = mesh_info if mesh_info is not None else (None, ())
    plan = ShardingPlan(mesh_shape=mesh.shape, batch_axes=tuple(batch_axes)) \
        if mesh is not None else None
    names = {id(p): n for n, p in model.named_parameters()}
    out = []
    leaves = model.reference_leaves()
    for keys in sorted(leaves):
        shape, items = leaves[keys]
        lead = shape[:len(shape) - items[0][1].dim()]
        order = [names[id(p)] for _, p in sorted(items, key=lambda it: it[0])]
        split = order[0] in model.blocks
        whole, block = model.blocks.get(order[0], (
            shape[len(lead):], tuple(slice(0, n) for n in shape[len(lead):])))
        spec: tuple = ()
        if split:  # the dims the rank holds a block of
            spec = (None,) * len(lead) + tuple(
                "model" if len(range(n)[b]) != n else None
                for n, b in zip(whole, block))
        zdim = zblock = None
        moment_spec = spec
        if zero1 and plan is not None and batch_axes and plan.batch_size_divisor > 1:
            zspec = zero1_spec(plan, spec, shape)
            free = [d for d in range(len(shape))
                    if (zspec + (None,) * len(shape))[d] not in (None, "model")]
            if free:
                zdim = free[0]
                only = tuple(zspec[d] if d == zdim else None
                             for d in range(len(shape)))
                zblock = shard_slices(only, shape, mesh.shape, mesh.coord)[zdim]
                moment_spec = tuple((spec + (None,) * len(shape))[d]
                                    if d != zdim else zspec[d]
                                    for d in range(len(shape)))
        out.append(RankLeaf("/".join(keys), tuple(order), lead, shape, split,
                            zdim, zblock, tuple(lead) + tuple(whole), tuple(block),
                            spec, moment_spec))
    return out


def _moment_dtype(moment_dtype: str) -> torch.dtype:
    return torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32


def init_opt_state(params, moment_dtype: str = "float32", mesh_info=None,
                   zero1: bool = False) -> dict:
    """{"m", "v": zeros in ``moment_dtype``, "step": an int32 0-d tensor},
    on the parameters' device: for a model, each stacked leaf (a rank's
    block of it with ``mesh_info``) by path; for a dict, like each
    tensor (see the module docstring)."""
    dt = _moment_dtype(moment_dtype)
    first = next(iter(_flatten(_param_dict(params)).values()))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if not hasattr(params, "reference_leaves"):
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params), "step": step}
    shapes = {leaf.path: leaf.moment_shape
              for leaf in rank_leaves(params, mesh_info, zero1)}
    return {part: {k: torch.zeros(s, dtype=dt, device=first.device)
                   for k, s in shapes.items()} for part in ("m", "v")} | {"step": step}


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


def _adam(p: torch.Tensor, g32: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, lr, bc1, bc2, decay: bool,
          cfg: AdamWConfig) -> torch.Tensor:
    """The elementwise update of one tensor: writes ``m`` and ``v``,
    returns the new parameter in f32."""
    b1, b2 = cfg.beta1, cfg.beta2
    m_new = m.float() * b1 + g32 * (1 - b1)
    v_new = v.float() * b2 + g32 * (1 - b2) * g32
    delta = (m_new / bc1).div_(torch.sqrt(v_new / bc2).add_(cfg.eps))
    if decay:  # decoupled weight decay on matrices only
        delta.add_(p.float() * cfg.weight_decay)
    m.copy_(m_new)
    v.copy_(v_new)
    return p.float() - delta.mul_(lr)


def _coefficients(step: torch.Tensor, gnorm: torch.Tensor, cfg: AdamWConfig):
    clip = torch.full((), cfg.clip_norm, dtype=torch.float32, device=step.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(step, cfg)
    bc1 = 1 - cfg.beta1 ** step.float()
    bc2 = 1 - cfg.beta2 ** step.float()
    return scale, lr, bc1, bc2


def _stacked(tensors: list, lead: tuple[int, ...]) -> torch.Tensor:
    """A leaf's layers as one tensor of ``lead`` stack dims (the tensor
    itself where the leaf has no stack dims)."""
    if not lead:
        return tensors[0]
    return torch.stack(tensors).reshape(*lead, *tensors[0].shape)


def _layers_held(leaf: RankLeaf) -> tuple[list[int], tuple]:
    """The layers of ``leaf`` (flat indices over its stack dims, in the
    moments' order) whose moments the rank holds, and the index that cuts
    a held layer's block to its moment block."""
    n = int(np.prod(leaf.lead)) if leaf.lead else 1
    index: tuple = (...,)
    if leaf.zdim is None:
        return list(range(n)), index
    if leaf.zdim < len(leaf.lead):  # ZeRO-1 cuts the layer stack
        block = [slice(None)] * len(leaf.lead)
        block[leaf.zdim] = leaf.zblock
        return np.arange(n).reshape(leaf.lead)[tuple(block)].ravel().tolist(), index
    cut = [slice(None)] * (len(leaf.shape) - len(leaf.lead))
    cut[leaf.zdim - len(leaf.lead)] = leaf.zblock
    return list(range(n)), tuple(cut)


def _param_dict(params) -> dict:
    """A model's parameters by name, or the dict itself."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return params


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 mesh_info=None, zero1: bool = False) -> dict:
    """One AdamW step in place: the parameters, ``state["m"]`` and
    ``state["v"]`` are written, ``state["step"]`` replaced.  ``grads`` is
    keyed as the parameters (a missing or None entry is a zero gradient).
    ``mesh_info`` and ``zero1``: a rank's update (module docstring), on
    ``state`` from `init_opt_state` with the same arguments.  Returns
    {"grad_norm" (before clipping), "lr"} as 0-d f32 tensors."""
    mesh, batch_axes = mesh_info if mesh_info is not None else (None, ())
    nb = mesh.size(batch_axes) if mesh is not None and batch_axes else 1
    flat = _flatten(_param_dict(params))
    flat_g = _flatten(grads)
    flat_m, flat_v = _flatten(state["m"]), _flatten(state["v"])
    leaves = rank_leaves(params, mesh_info, zero1)
    step = state["step"] + 1
    dev = step.device
    # Each leaf's gradient on its moment block: the mean over the batch
    # axes (one collective a leaf, on its stacked layers), or, with no
    # batch axis to reduce over, each layer's own gradient.
    local = {}
    for leaf in leaves:
        gs = [flat_g.get(n) if flat_g.get(n) is not None
              else torch.zeros_like(flat[n]) for n in leaf.names]
        if nb > 1:
            g = _stacked(gs, leaf.lead)
            g = (mesh.reduce_scatter(g, batch_axes, leaf.zdim)
                 if leaf.zdim is not None else mesh.all_reduce(g, batch_axes))
            gs = list((g / nb).reshape(-1, *leaf.moment_shape[len(leaf.lead):]))
        local[leaf.path] = gs
    # Squares in f32, a leaf's layers summed before the leaf joins its
    # bucket (split over model, cut over the batch axes), each bucket
    # summed once over the positions that hold different parts of it.
    sums = torch.zeros((2, 2), dtype=torch.float32, device=dev)
    for leaf in leaves:
        sq = None
        for g in local[leaf.path]:
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        sums[int(leaf.split), int(leaf.zdim is not None)] += sq
    if nb > 1 and any(leaf.zdim is not None for leaf in leaves):
        sums[:, 1] = mesh.all_reduce(sums[:, 1], batch_axes)
    split = sums[1].sum()
    if mesh is not None and mesh.size("model") > 1:
        split = mesh.all_reduce(split, "model")
    gnorm = torch.sqrt(sums[0].sum() + split)
    scale, lr, bc1, bc2 = _coefficients(step, gnorm, cfg)

    for leaf in leaves:
        held, cut = _layers_held(leaf)
        layer_shape = leaf.moment_shape[len(leaf.lead):]
        m = flat_m[leaf.path].reshape(-1, *layer_shape)
        v = flat_v[leaf.path].reshape(-1, *layer_shape)
        new = []
        for j, i in enumerate(held):
            p = flat[leaf.names[i]]
            g = local[leaf.path][j]
            out = _adam(p[cut], g.float() * scale, m[j], v[j], lr, bc1, bc2,
                        len(leaf.shape) >= 2, cfg)
            if leaf.zdim is None:
                p.copy_(out)
            else:
                new.append(out.to(p.dtype))
        if leaf.zdim is None:
            continue
        # The ZeRO-1 blocks back over the batch axes: one all_gather a leaf.
        mine = _stacked(new, tuple(leaf.moment_shape[:len(leaf.lead)]))
        whole = mesh.all_gather(mine, batch_axes).movedim(0, leaf.zdim).flatten(
            leaf.zdim, leaf.zdim + 1)
        for name, layer in zip(leaf.names, whole.reshape(-1, *leaf.shape[len(leaf.lead):])):
            flat[name].copy_(layer)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
