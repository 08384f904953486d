"""Train, prefill and serve steps for any (arch, mesh).

`make_*_step` returns a `StepBundle`: the sharding plan and the parameter
specs the planner gives the mesh, and ``jit_for``, which returns the step
as an eager callable (the reference returns a jitted, sharded function;
the port's counterpart of that program is the eager step, with no
``torch.compile`` and no CUDA graphs).  A step takes the model first,
where the reference takes its params: the model holds its weights on its
device, and the step runs there.  The prefill and serve steps run under
``torch.inference_mode()``; the train step turns on the gradients of the
model it trains and updates its parameters in place.

On one card the specs are trivial and nothing applies them.  On a mesh
of ranks (`repro_torch.launch.mesh.make_rank_mesh`) each rank's model
holds its blocks of the specs (`repro_torch.models.Model` with
``ParamShard.of(mesh)``: the model alone decides which leaves it
splits), and every step passes it ``mesh_info = (mesh, batch_axes)``;
the forward acts on what the model holds.  The train step takes the
global batch and runs the loss on the rank's rows (`shard_slices` over
the batch axes; rows that do not divide stay whole, as ``plan_batch``
replicates them; the prefill step cuts them so too), then `adamw_update` on the rank (the mean gradient
over the batch axes, ZeRO-1 with ``zero1``); its reported ``loss`` and
``ce`` are the global batch's mean, the same on every rank, and ``aux``
the reference's ``pmean``.

A rank model built with the planner's ``shard_head_dim_fallback``
(``ParamShard.of(mesh, head_dim_fallback=True)``: head_dim blocks where
the heads do not divide the model axis) is served by a serve step made
with the same flag and by the prefill step; the train step refuses it,
as the reference's train step has no such plan.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.sharding import (ShardingPlan, plan_opt_state, plan_params,
                                  shard_slices)

from .mesh import Mesh, batch_axes_of

__all__ = ["StepBundle", "make_train_step", "make_prefill_step",
           "make_serve_step", "make_plan"]


@dataclass
class StepBundle:
    jit_for: Callable  # shape -> the eager step
    plan: ShardingPlan
    param_specs: dict
    opt_specs: dict | None = None  # train: the m/v/step specs
    init_opt: Callable | None = None  # train: model -> fresh optimizer state


def make_plan(mesh: Mesh, **kw) -> ShardingPlan:
    return ShardingPlan(mesh_shape=mesh.shape, batch_axes=batch_axes_of(mesh), **kw)


def _mesh_info(cfg: ArchConfig, mesh: Mesh | None):
    """``(mesh, batch_axes)`` where the reference runs the expert-parallel
    MoE — a MoE config, a model axis > 1 and ``num_experts`` divisible by
    it — else None: the single-shard MoE, the reference's semantics."""
    if (cfg.is_moe and mesh is not None and mesh.shape.get("model", 1) > 1
            and cfg.num_experts % mesh.shape["model"] == 0):
        return (mesh, batch_axes_of(mesh))
    return None


def _rank_info(mesh: Mesh):
    """The steps' ``mesh_info``: ``(mesh, batch_axes)`` on a mesh of
    ranks, else None (one process holds every leaf whole)."""
    return (mesh, batch_axes_of(mesh)) if mesh.ranks is not None else None


def _rank_rows(batch: dict, mesh: Mesh) -> dict:
    """The rows of each batch tensor that this rank's batch-axes
    coordinate holds (all of them where they do not divide)."""
    axes = batch_axes_of(mesh)
    n = mesh.size(axes) if axes else 1
    out = {}
    for k, t in batch.items():
        if n > 1 and t.shape[0] % n == 0:
            t = t[shard_slices((axes,), t.shape, mesh.shape, mesh.coord)[0]]
        out[k] = t
    return out


def _bundle(cfg, mesh, step, **plan_kw) -> StepBundle:
    plan = make_plan(mesh, **plan_kw)
    pspecs = plan_params(plan, Model(cfg, "meta").param_shapes())
    return StepBundle(jit_for=lambda _shape: step, plan=plan, param_specs=pspecs)


def make_train_step(cfg: ArchConfig, mesh: Mesh, opt: AdamWConfig | None = None,
                    remat: bool = True, zero1: bool = True,
                    kv_chunk: int = 1024,
                    moment_dtype: str | None = None) -> StepBundle:
    """train_step(model, opt_state, batch) -> (opt_state, metrics): the
    loss's gradients by ``loss.backward()``, then `adamw_update` on the
    model's parameters and ``opt_state`` in place; the gradients are set to
    None after the update.  ``batch`` holds tensors on the model's device
    (``tokens``; ``frontend`` for vlm/audio), the global batch.
    ``metrics``: ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr`` as 0-d
    tensors.  ``jit_for(batch)``; ``init_opt(model)`` gives the optimizer
    state.  On a mesh of ranks the step runs the rank's part (module
    docstring) and ``zero1`` cuts the moments over the batch axes."""
    plan = make_plan(mesh)
    opt = opt or AdamWConfig()
    if moment_dtype is not None:
        opt = dataclasses.replace(opt, moment_dtype=moment_dtype)
    shapes = Model(cfg, "meta").param_shapes()
    pspecs = plan_params(plan, shapes)
    ospecs = {"m": plan_opt_state(plan, shapes, zero1),
              "v": plan_opt_state(plan, shapes, zero1), "step": ()}
    minfo = _rank_info(mesh)
    zero1 = zero1 and minfo is not None

    def train_step(model: Model, opt_state: dict, batch: dict):
        if model.shard.head_dim_fallback:
            raise ValueError(
                f"{cfg.name}: a model built with shard_head_dim_fallback "
                "holds head_dim blocks; the train step plans without it, as "
                "the reference's does, so it does not train such a model")
        if minfo is not None:
            batch = _rank_rows(batch, mesh)
        model.requires_grad_(True)
        loss, metrics = model.loss(batch, mesh_info=minfo, remat=remat,
                                   kv_chunk=kv_chunk)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        stats = adamw_update(model, grads, opt_state, opt, mesh_info=minfo,
                             zero1=zero1)
        model.zero_grad(set_to_none=True)
        loss, ce = loss.detach(), metrics["ce"].detach()
        axes = batch_axes_of(mesh)
        if minfo is not None and axes and mesh.size(axes) > 1:
            loss, ce = mesh.all_reduce(torch.stack([loss, ce]), axes) / mesh.size(axes)
        return opt_state, {"loss": loss, "ce": ce,
                           "aux": metrics["aux"].detach(), **stats}

    return StepBundle(jit_for=lambda _batch: train_step, plan=plan,
                      param_specs=pspecs, opt_specs=ospecs,
                      init_opt=functools.partial(
                          init_opt_state, moment_dtype=opt.moment_dtype,
                          mesh_info=minfo, zero1=zero1))


def make_prefill_step(cfg: ArchConfig, mesh: Mesh, cache_len: int,
                      kv_chunk: int = 1024,
                      seq_parallel_decode: bool = True) -> StepBundle:
    """prefill_step(model, batch) -> (last-position logits (B, 1, V),
    caches of ``cache_len``); ``jit_for(batch)``.  On a mesh of ranks
    ``batch`` is the global batch: the step runs the rank's rows (as the
    train step does) and returns their logits and the rank's block of
    the global batch's caches (`Model.init_caches`)."""
    minfo = _rank_info(mesh)

    @torch.inference_mode()
    def prefill_step(model: Model, batch: dict):
        caches = model.init_caches(batch["tokens"].shape[0], cache_len,
                                   seq_parallel_decode)
        if minfo is not None:
            batch = _rank_rows(batch, mesh)
        tokens = batch["tokens"]
        logits, caches, _ = model(tokens, mode="prefill", caches=caches,
                                  frontend=batch.get("frontend"),
                                  mesh_info=minfo, kv_chunk=kv_chunk)
        return logits[:, -1:], caches

    return _bundle(cfg, mesh, prefill_step,
                   seq_parallel_decode=seq_parallel_decode)


def make_serve_step(cfg: ArchConfig, mesh: Mesh, cache_len: int,
                    kv_chunk: int = 1024,
                    seq_parallel_decode: bool = True,
                    shard_head_dim_fallback: bool = False) -> StepBundle:
    """serve_step(model, caches, tokens, positions): one new token per
    sequence against the decode cache, written in place;
    ``jit_for(batch_size)``.  On a mesh of ranks, the rank's rows and its
    block of the caches (the prefill step's).  ``shard_head_dim_fallback``
    is the plan's: where the model splits its leaves (a model axis > 1)
    its shard must have been built with the same flag
    (``ParamShard.of(mesh, head_dim_fallback=...)``), else the step raises
    ValueError rather than run the other layout."""
    minfo = _rank_info(mesh)

    @torch.inference_mode()
    def serve_step(model: Model, caches, tokens, positions):
        if (not model.shard.whole
                and model.shard.head_dim_fallback != shard_head_dim_fallback):
            raise ValueError(
                f"{cfg.name}: the serve step plans with "
                f"shard_head_dim_fallback={shard_head_dim_fallback}, the model "
                f"was built with {model.shard.head_dim_fallback}")
        logits, caches, _ = model(tokens, mode="decode", caches=caches,
                                  positions=positions, mesh_info=minfo,
                                  kv_chunk=kv_chunk)
        return logits, caches

    return _bundle(cfg, mesh, serve_step, seq_parallel_decode=seq_parallel_decode,
                   shard_head_dim_fallback=shard_head_dim_fallback)
