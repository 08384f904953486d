"""Dry run: count every (arch x shape x mesh) cell's step on the meta device.

Where the reference lowers and compiles each cell's jitted, sharded step
for the 16x16 and 2x16x16 meshes and reads XLA's cost and memory analysis
and the partitioned HLO per chip, the port runs its own eager step
(`repro_torch.launch.steps`) on the meta device under
`op_analysis.OpCounter`, twice:

* for one position of the production mesh (its first), as a rank runs
  it: ``Model(cfg, "meta", ParamShard.of(mesh))`` holds the position's
  block of every leaf, the step takes the position's rows of the batch
  (and its caches' blocks), and a counting mesh
  (`repro_torch.launch.mesh.make_abstract_mesh`) records every
  collective the step would issue.  These are the record's per-chip
  ``cost`` and ``collectives`` (`op_analysis.collective_bytes`), with
  ``"partitioned": true``.  ``notes`` (`position_notes`) would name a
  leaf or cache leaf the position holds other than the planner's block:
  every family holds the planner's blocks, so it is empty.
* unsharded, on one device: ``cost_one_card``, and the memory keys
  ``argument_size_in_bytes_one_card``, ``output_size_in_bytes`` and
  ``peak_live_bytes``, which say whether a cell fits one card.  The
  report (`repro_torch.launch.report.dryrun_table`) sets the position's
  FLOPs times ``chips`` (the mesh's size) against ``cost_one_card``'s:
  1 where the mesh splits all the work, more where positions repeat it.

``memory.argument_size_in_bytes`` is the planner's per-device bytes of
the step's arguments (each leaf's bytes over the product of the mesh
axes its spec names), ``argument_size_in_bytes_position`` and
``peak_live_bytes_position`` the counted position's.  An eager step has
no rolled loop, so the reference's ``unroll`` has no counterpart.
Results append to a JSONL ledger so the sweep is resumable.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --out results/torch_dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, applicable,
                                        cache_specs, input_specs)
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model, reference_path
from repro_torch.sharding import (ParamShard, ShardingPlan, plan_batch,
                                  plan_caches, plan_opt_state, plan_params,
                                  shard_slices)

from .mesh import Mesh, batch_axes_of, make_abstract_mesh
from .op_analysis import (NO_COLLECTIVES, collective_bytes, count_ops,
                          op_census)
from .steps import (make_plan, make_prefill_step, make_serve_step,
                    make_train_step)

__all__ = ["cell_step", "count_cell", "plan_cell", "run_cell", "main"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _inputs(cfg: ArchConfig, sp: ShapeSpec, device: torch.device,
            generator: torch.Generator | None) -> dict:
    """The cell's inputs: `input_specs` on meta; elsewhere random tokens
    and labels, a standard-normal frontend, and decode positions at the
    cache's last slot, drawn from ``generator`` on ``device``."""
    specs = input_specs(cfg, sp)
    if device.type == "meta":
        return specs
    out = {}
    for name, s in specs.items():
        if name == "positions":
            out[name] = torch.full(s.shape, sp.seq_len - 1, dtype=s.dtype,
                                   device=device)
        elif s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape, dtype=s.dtype,
                                      generator=generator, device=device)
        else:
            out[name] = torch.randn(s.shape, generator=generator,
                                    device=device).to(s.dtype)
    return out


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of ``t`` that the position of ``mesh`` serves (all of them
    where they do not divide over the batch axes, as ``plan_batch``
    replicates them)."""
    axes = batch_axes_of(mesh)
    if mesh.ranks is None or not axes or t.shape[0] % mesh.size(axes):
        return t
    return t[shard_slices((axes,), t.shape, mesh.shape, mesh.coord)[0]]


def cell_step(cfg: ArchConfig, sp: ShapeSpec, model: Model, *,
              kv_chunk: int = 1024, remat: bool = True,
              generator: torch.Generator | None = None, mesh: Mesh | None = None,
              **step_kwargs) -> tuple:
    """``(call, args)``: the cell's eager step for ``model`` and its
    arguments on the model's device; ``call()`` runs the step once on
    ``args`` (the train step updates the model in place, the serve step
    its caches).  ``step_kwargs`` go to ``make_*_step`` (``zero1``,
    ``moment_dtype``; ``seq_parallel_decode``, ``shard_head_dim_fallback``).
    Without ``mesh`` the step is unsharded: it gets a one-device mesh of
    the model's device.  With a mesh of ranks or a counting mesh, it is
    that position's: ``model`` holds its blocks, the train and prefill
    steps take the global batch (they cut its rows themselves), decode
    takes the position's rows and its block of the caches, as
    `serve_batch` gives them."""
    dev = model.device
    if mesh is None:
        mesh = Mesh(("data", "model"), np.array([[dev]], dtype=object))
    batch = _inputs(cfg, sp, dev, generator)
    if sp.kind == "train":
        bundle = make_train_step(cfg, mesh, remat=remat, kv_chunk=kv_chunk,
                                 **step_kwargs)
        args = (model, bundle.init_opt(model), batch)
    elif sp.kind == "prefill":
        bundle = make_prefill_step(cfg, mesh, cache_len=sp.seq_len,
                                   kv_chunk=kv_chunk, **step_kwargs)
        args = (model, batch)
    else:
        bundle = make_serve_step(cfg, mesh, cache_len=sp.seq_len,
                                 kv_chunk=kv_chunk, **step_kwargs)
        tokens, positions = _rows(batch["tokens"], mesh), _rows(batch["positions"], mesh)
        caches = model.init_caches(sp.global_batch, sp.seq_len,
                                   step_kwargs.get("seq_parallel_decode", True))
        args = (model, caches, tokens, positions)
    step = bundle.jit_for(None)
    return (lambda: step(*args)), args


def _arg_tensors(args) -> list[torch.Tensor]:
    model, rest = args[0], args[1:]
    return list(model.parameters()) + _leaves(list(rest))


def count_cell(cfg: ArchConfig, sp: ShapeSpec, *, kv_chunk: int = 1024,
               remat: bool = True, mesh: Mesh | None = None,
               **step_kwargs) -> dict:
    """The op counts (`op_analysis.OpCounter.record`) of one call of the
    cell's step on the meta device, with the step's memory:
    ``argument_size_in_bytes_one_card`` (parameters, optimizer state,
    inputs and caches), ``output_size_in_bytes`` (the returned tensors
    that are not arguments) and ``peak_live_bytes`` (the arguments plus
    the step's peak allocation), and its ``collectives``
    (`op_analysis.collective_bytes`).  Unsharded without ``mesh``; with
    a counting mesh (`make_abstract_mesh`), its position's step, whose
    memory keys are the position's, and whose model holds the blocks of
    the step's plan (``shard_head_dim_fallback`` among ``step_kwargs``)."""
    shard = (ParamShard.of(mesh, step_kwargs.get("shard_head_dim_fallback", False))
             if mesh is not None else None)
    model = Model(cfg, "meta", shard)
    call, args = cell_step(cfg, sp, model, kv_chunk=kv_chunk, remat=remat,
                           mesh=mesh, **step_kwargs)
    arg_tensors = _arg_tensors(args)
    arg_bytes = sum(_bytes(t) for t in arg_tensors)
    arg_keys = {t.untyped_storage()._cdata for t in arg_tensors}
    mark = mesh.copy_tally() if mesh is not None else None
    t0 = time.perf_counter()
    out, rec = count_ops(call)
    rec["count_s"] = time.perf_counter() - t0
    rec["collectives"] = (collective_bytes(mesh.tally_since(mark))
                          if mesh is not None else dict(NO_COLLECTIVES))
    # ``collective_counts`` (by operation) and ``collectives_by_dtype``
    # (bytes by "operation:dtype") with a mesh.
    if mesh is not None:
        grew = mesh.tally_since(mark)
        rec["collective_counts"] = grew["count"]
        rec["collectives_by_dtype"] = {
            k: v for k, v in grew["bytes_by_dtype"].items() if k != "_count"}
    rec["num_params"] = sum(p.numel() for p in model.parameters())
    rec["memory"] = {
        "argument_size_in_bytes_one_card": arg_bytes,
        "output_size_in_bytes": sum(
            _bytes(t) for t in _leaves(out)
            if t.untyped_storage()._cdata not in arg_keys),
        "peak_live_bytes": arg_bytes + rec["peak_live_bytes"]}
    return rec


def position_notes(cfg: ArchConfig, sp: ShapeSpec, mesh: Mesh) -> list[str]:
    """Where the counted position holds other than the planner gives it:
    the leaves its model keeps whole though their spec splits them, and
    the cache leaves whose block differs from ``plan_caches``' (read
    through `ParamShard.cache_blocks` on `cache_specs`' tree).  Empty
    where the position's step is the reference planner's program."""
    notes = []
    shard = ParamShard.of(mesh)
    model = Model(cfg, "meta", shard)
    whole = sorted({"/".join(reference_path(name)[0])
                    for name, p in model.named_parameters()
                    if name not in model.blocks
                    and shard.block(reference_path(name)[0], p.shape)[0] != ()})
    if whole:
        notes.append(f"position holds whole ({len(whole)} leaves the planner "
                     f"splits): {', '.join(whole)}")
    if sp.kind == "train":
        return notes
    held = dict(_flat_shapes(model.init_caches(sp.global_batch, sp.seq_len)))
    caches = dict(_flat_shapes(cache_specs(cfg, sp)))
    for keys, (_spec, block) in shard.cache_blocks(cache_specs(cfg, sp)).items():
        want = tuple(len(range(n)[b]) for n, b in zip(caches[keys], block))
        if tuple(held.get(keys, ())) != want:
            notes.append(f"cache {'/'.join(keys)}: position holds "
                         f"{held.get(keys)}, plan_caches gives {want}")
    return notes


def _flat_shapes(tree, prefix=(), leaf=None):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_shapes(tree[k], prefix + (k,), leaf)
    elif leaf is not None:
        yield prefix, tree
    else:
        yield prefix, tuple(tree.shape)


def _sharded_bytes(mesh_shape: dict, spec, nbytes: int) -> int:
    div = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                div *= mesh_shape[axis]
    return nbytes // div


def _tree_bytes(mesh_shape: dict, specs, leaves, itemsize: int | None = None) -> int:
    """Per-device bytes of a tree of tensors under its spec tree, at
    ``itemsize`` bytes an element where given, else at each tensor's."""
    if isinstance(leaves, dict):
        return sum(_tree_bytes(mesh_shape, specs[k], leaves[k], itemsize)
                   for k in leaves)
    size = itemsize or leaves.element_size()
    return _sharded_bytes(mesh_shape, specs, leaves.numel() * size)


def _param_tree(model: Model) -> dict:
    """The reference's parameter tree as meta tensors of each leaf's
    stacked shape and dtype (what the planner and the bytes read)."""
    tree: dict = {}
    for keys, (shape, items) in model.reference_leaves().items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, dtype=items[0][1].dtype, device="meta")
    return tree


def plan_cell(cfg: ArchConfig, sp: ShapeSpec, mesh: Mesh, *,
              zero1: bool = True) -> tuple[ShardingPlan, int]:
    """The reference step bundle's plan of this cell on ``mesh`` (its
    parameter, optimizer-state, batch and cache specs, planned in the
    reference's order, so ``notes`` match) and the per-device bytes of the
    step's arguments under it."""
    params = _param_tree(Model(cfg, "meta"))
    specs = input_specs(cfg, sp)
    ms = mesh.shape
    plan = make_plan(mesh)
    total = _tree_bytes(ms, plan_params(plan, params), params)
    if sp.kind == "train":
        for _ in ("m", "v"):  # f32 moments
            total += _tree_bytes(ms, plan_opt_state(plan, params, zero1), params, 4)
        total += 4  # the optimizer's int32 step, replicated
        return plan, total + _tree_bytes(ms, plan_batch(plan, specs), specs)
    if sp.kind == "prefill":
        total += _tree_bytes(ms, plan_batch(plan, specs), specs)
        plan_caches(plan, cache_specs(cfg, sp))  # the step's output layout
        return plan, total
    caches = cache_specs(cfg, sp)
    total += _tree_bytes(ms, plan_caches(plan, caches), caches)
    tok = plan_batch(plan, {"tokens": specs["tokens"]})["tokens"]
    total += 2 * _sharded_bytes(ms, tok, _bytes(specs["tokens"]))
    return plan, total


def run_cell(arch: str, shape: str, multi_pod: bool, kv_chunk: int = 1024,
             zero1: bool = True, remat: bool = True, verbose: bool = True,
             ssm_chunk: int | None = None) -> dict:
    """Count one cell on meta, for the mesh's first position and on one
    card, and plan it on the mesh; returns the JSONL record."""
    rec: dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "kv_chunk": kv_chunk, "zero1": zero1, "remat": remat,
                 "partitioned": True, "chips": 512 if multi_pod else 256}
    cfg = get_config(arch)
    if ssm_chunk is not None and cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
        rec["ssm_chunk"] = ssm_chunk
    ok, reason = applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    sp = SHAPES[shape]
    keys = ("flops", "bytes accessed", "flops_matmul", "flops_matmul_by_dtype",
            "flops_pointwise", "bytes_read", "bytes_written", "host_copies",
            "host_bytes")
    try:
        mesh = make_abstract_mesh(multi_pod=multi_pod)
        plan, per_device = plan_cell(cfg, sp, mesh, zero1=zero1)
        step_kw = {"zero1": zero1} if sp.kind == "train" else {}
        one = count_cell(cfg, sp, kv_chunk=kv_chunk, remat=remat, **step_kw)
        part = count_cell(cfg, sp, kv_chunk=kv_chunk, remat=remat, mesh=mesh,
                          **step_kw)
        cost = {k: part[k] for k in keys}
        rec.update(status="ok", position=dict(mesh.coord),
                   count_s=round(one["count_s"] + part["count_s"], 2), cost=cost,
                   collectives=part["collectives"],
                   collectives_by_dtype=part["collectives_by_dtype"],
                   cost_one_card={k: one[k] for k in keys},
                   memory={"argument_size_in_bytes": per_device, **one["memory"],
                           "argument_size_in_bytes_position":
                               part["memory"]["argument_size_in_bytes_one_card"],
                           "peak_live_bytes_position":
                               part["memory"]["peak_live_bytes"]},
                   ops=op_census(part), num_params=one["num_params"],
                   plan_notes=plan.notes[:20],
                   notes=position_notes(cfg, sp, mesh))
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {rec['mesh']}: OK "
                  f"(count {rec['count_s']:.1f}s on meta, position "
                  f"{rec['position']})")
            print(f"  memory: {rec['memory']}")
            print(f"  cost per chip: flops={cost['flops']:.4e} "
                  f"(matmul {cost['flops_matmul']:.4e}) "
                  f"bytes={cost['bytes accessed']:.4e}; collectives "
                  f"{rec['collectives']}")
    except Exception as e:  # noqa: BLE001 -- a sweep records the cell's failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {rec['mesh']}: "
                  f"FAILED {type(e).__name__}: {e}")
    return rec


def _done_cells(path: Path) -> set[tuple]:
    done = set()
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") in ("ok", "skip"):
                done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.jsonl")
    args = ap.parse_args()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    done = set() if args.force else _done_cells(out)

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                if (arch, shape, "2x16x16" if multi else "16x16") in done:
                    continue
                rec = run_cell(arch, shape, multi, kv_chunk=args.kv_chunk,
                               zero1=not args.no_zero1, remat=not args.no_remat)
                with out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
                n_skip += rec["status"] == "skip"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} errors -> {out}")


if __name__ == "__main__":
    main()
