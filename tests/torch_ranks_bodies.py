"""What the ranks of the rank tests run (`repro_torch.launch.mesh.run_ranks`).

The spawned ranks import this module by name, so it imports neither jax
nor the reference package: the tests compute the reference's side in the
parent process and hand the ranks numpy inputs.  Every rank of a job makes
every mesh of a body (`make_rank_mesh` is collective) and works only on
the meshes that hold it.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.mapping_device import island_sa
from repro_torch.interop import (rank_model_from, rank_state_from,
                                 reference_state, reference_tree,
                                 state_template)
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models import Model, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import rank_leaves
from repro_torch.models.moe import moe_ffn_sharded
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime.elastic import Sharded, remesh_params
from repro_torch.sharding.planner import ParamShard, shard_slices


class Experts:
    """A MoE layer's weights as `moe_ffn` reads them."""

    def __init__(self, router, w_gate, w_up, w_down):
        self.router, self.w_gate, self.w_up, self.w_down = (
            router, w_gate, w_up, w_down)


def moe(cfg, inputs: dict, shapes: list) -> dict:
    """`moe_ffn_sharded` of ``inputs`` (x, router, w_gate, w_up, w_down:
    whole numpy arrays) on a (data, model) mesh of each shape in
    ``shapes`` (over the first ranks): this rank's coordinate, the block of
    rows it served, and its out and aux, by shape."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for shape in shapes:
        mesh = make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))
        if not mesh.is_member:
            continue
        coord = mesh.coord
        rows = shard_slices(("data",), t["x"].shape, mesh.shape, coord)[0]
        experts = shard_slices(("model",), t["w_gate"].shape, mesh.shape,
                               coord)[0]
        p = Experts(t["router"], *(t[k][experts] for k in
                                   ("w_gate", "w_up", "w_down")))
        y, aux = moe_ffn_sharded(t["x"][rows], p, cfg, mesh, ("data",))
        out[shape] = dict(coord=coord, rows=(rows.start, rows.stop),
                          out=y.numpy(), aux=float(aux))
    return out


def _trained(cfg, tree: dict, mesh, batches: list) -> list:
    """The metrics of `make_train_step` over ``batches`` (global (B, S)
    int32 tokens) on ``mesh``, the rank's model carried from ``tree``."""
    model = rank_model_from(cfg, tree, mesh)
    bundle = make_train_step(cfg, mesh, opt=TRAIN_OPT, remat=False, zero1=False)
    state, step = bundle.init_opt(model), bundle.jit_for(None)
    out = []
    for tokens in batches:
        state, m = step(model, state, {"tokens": torch.from_numpy(tokens)})
        out.append({k: float(v) for k, v in m.items()})
    return out


def moe_grads(cfg, inputs: dict, weight: np.ndarray, shapes: list) -> dict:
    """The gradients of ``mean over the data rows' blocks of sum(out *
    weight) + 0.01 aux`` through `moe_ffn_sharded` on a (data, model) mesh
    of each shape in ``shapes``: each rank's loss is its rows' sum plus
    0.01 aux, its gradients averaged over ``data`` (as the train step
    averages them), so ``x``'s rows take the rank's gradient over the
    data ranks' count.  Returns by shape this rank's coordinate, rows,
    experts and the gradients of x (its rows), the router and its
    experts' weights."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for shape in shapes:
        mesh = make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))
        if not mesh.is_member:
            continue
        coord = mesh.coord
        rows = shard_slices(("data",), t["x"].shape, mesh.shape, coord)[0]
        experts = shard_slices(("model",), t["w_gate"].shape, mesh.shape,
                               coord)[0]
        x = t["x"][rows].clone().requires_grad_(True)
        p = Experts(t["router"].clone().requires_grad_(True),
                    *(t[k][experts].clone().requires_grad_(True)
                      for k in ("w_gate", "w_up", "w_down")))
        y, aux = moe_ffn_sharded(x, p, cfg, mesh, ("data",))
        loss = (y * torch.from_numpy(weight)[rows]).sum() + 0.01 * aux
        loss.backward()
        n = shape[0]
        grads = {}
        with torch.no_grad():
            for k in ("router", "w_gate", "w_up", "w_down"):
                grads[k] = (mesh.all_reduce(getattr(p, k).grad, ("data",)) / n).numpy()
        out[shape] = dict(coord=coord, rows=(rows.start, rows.stop),
                          experts=(experts.start, experts.stop),
                          x=(x.grad / n).numpy(), **grads)
    return out


def serve(cfg, tree: dict, prompts: np.ndarray, gen_len: int,
          shapes: list, train_batches: list = ()) -> dict:
    """Greedy `serve_batch` on a (data, model) mesh of each shape, each
    rank's model carried from the reference tree (`rank_model_from`), and
    this rank's experts of a model built from seed 0 (first layer); the
    expert shard is (index, count): the block the model holds of the
    experts, and how many such blocks they make.  On the (1, 2) mesh,
    ``"trained"``: the metrics of `_trained` over ``train_batches``."""
    out = {}
    for shape in shapes:
        mesh = make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))
        if not mesh.is_member:
            continue
        model = rank_model_from(cfg, tree, mesh)
        res = serve_batch(cfg, mesh, prompts, gen_len, model=model,
                          keep_logits=True, print_fn=lambda *_: None,
                          device="cpu")
        seeded = build_model(cfg, "cpu", seed=0,
                             shard=ParamShard.of(mesh)).layers[0].moe
        e_loc = model.layers[0].moe.w_gate.shape[0]
        _, block = model.blocks["layers.0.moe.w_gate"]
        out[shape] = dict(
            coord=mesh.coord,
            shard=(block[0].start // e_loc, cfg.num_experts // e_loc),
            tokens=res["tokens"], logits=res["logits"].numpy(),
            carried={k: getattr(model.layers[0].moe, k).numpy()
                     for k in ("router", "w_gate", "w_up", "w_down")},
            seeded={k: getattr(seeded, k).numpy()
                    for k in ("router", "w_gate", "w_down")})
        if shape == (1, 2) and train_batches:
            out[shape]["trained"] = _trained(cfg, tree, mesh, train_batches)
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def tensor_parallel(cfg, tree, prompts: np.ndarray, gen_len: int,
                    shapes: list, train_batches: list = ()) -> dict:
    """Greedy `serve_batch` on a (data, model) mesh of each shape, each
    rank's model carried from the reference tree (`rank_model_from`):
    this rank's coordinate, tokens, logits and collective tally, and the
    leaves it holds (as the reference's stacked tree) of the carried model
    and of a model built from seed 0 for its position.  On the (1, 2)
    mesh, ``"trained"``: the metrics of `_trained` over
    ``train_batches``."""
    out = {}
    for shape in shapes:
        mesh = make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))
        if not mesh.is_member:
            continue
        model = rank_model_from(cfg, tree, mesh)
        res = serve_batch(cfg, mesh, prompts, gen_len, model=model,
                          keep_logits=True, print_fn=lambda *_: None,
                          device="cpu")
        seeded = build_model(cfg, "cpu", seed=0, shard=ParamShard.of(mesh))
        out[shape] = dict(coord=mesh.coord, tokens=res["tokens"],
                          logits=res["logits"].numpy(),
                          collectives=res["collectives"],
                          carried=_numpy(reference_tree(model)),
                          seeded=_numpy(reference_tree(seeded)))
        if shape == (1, 2) and train_batches:
            out[shape]["trained"] = _trained(cfg, tree, mesh, train_batches)
    return out


def _host(tree):
    """A placed tree with each leaf as numpy: a `Sharded` as its blocks."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return {"blocks": {pos: b.numpy() for pos, b in tree.blocks.items()},
                "shape": tree.shape}
    return None if tree is None else tree.numpy()


def _full(tree):
    """Every leaf of a placed tree whole again (`Sharded.full`)."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return (tree.full() if isinstance(tree, Sharded) else tree).numpy()


def remesh(trees: dict, cases: dict) -> dict:
    """`remesh_params` for each case: ``place`` (shape, specs) puts the
    whole tree ``trees[case["tree"]]`` (nested dicts of numpy leaves) on a
    (data, model) mesh over the first ranks; a case with ``move`` (shape,
    specs) then moves the placed tree to such a mesh.  Returns, by case,
    this rank's blocks and the gathered leaves of the last placement
    (where it holds a position of it)."""
    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.from_numpy(node)

    def mesh_of(shape):
        return make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))

    out = {}
    for name, case in cases.items():
        shape, specs = case["place"]
        mesh = mesh_of(shape)
        placed = remesh_params(tensors(trees[case["tree"]]), mesh, specs)
        if "move" in case:
            shape, specs = case["move"]
            mesh = mesh_of(shape)
            placed = remesh_params(placed, mesh, specs)
        out[name] = dict(member=mesh.is_member, blocks=_host(placed),
                         coord=mesh.coord if mesh.is_member else None,
                         full=_full(placed) if mesh.is_member else None)
    return out


def islands(traffic: np.ndarray, num_cores: int, mesh_w: int,
            trace_length: int, seeds: list, kw: dict) -> dict:
    """`island_sa` with one island a rank (a 1-D ``data`` mesh of every
    rank), by seed."""
    mesh = make_rank_mesh((torch.distributed.get_world_size(),), ("data",),
                          device="cpu")
    out = {}
    for seed in seeds:
        res = island_sa(traffic, num_cores, mesh_w, trace_length, seed=seed,
                        mesh=mesh, axis="data", **kw)
        out[seed] = dict(placement=res.placement, avg_hop=res.avg_hop,
                         evaluations=res.evaluations)
    return out


# Two steps reach the schedule's warm-up: lr 1e-3 and 2e-3.
TRAIN_OPT = AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100)


def train(cfg, batches: list, cases: dict) -> dict:
    """`make_train_step` on a (data, model) rank mesh for each case (name
    -> dict of ``shape``, ``zero1``, ``remat``, ``policy``), the rank's
    model built from seed 0, over ``batches`` (each the global (B, S)
    int32 tokens): this rank's coordinate, each step's metrics, collective
    tally and moments (by leaf path), and after the last step its
    parameters (by name), the blocks it holds (`Model.blocks`) and the
    block of the stacked whole leaf each moment is (`moment_blocks`)."""
    meshes = {}
    out = {}
    for name, case in cases.items():
        shape = tuple(case["shape"])
        if shape not in meshes:
            meshes[shape] = make_rank_mesh(shape, device="cpu",
                                           ranks=range(int(np.prod(shape))))
        mesh = meshes[shape]
        if not mesh.is_member:
            continue
        c = dataclasses.replace(cfg, remat_policy=case.get("policy", "full"))
        model = build_model(c, "cpu", seed=0, shard=ParamShard.of(mesh))
        bundle = make_train_step(c, mesh, opt=TRAIN_OPT, remat=case["remat"],
                                 zero1=case["zero1"])
        state, step = bundle.init_opt(model), bundle.jit_for(None)
        metrics, tallies, moments = [], [], []
        for tokens in batches:
            mark = mesh.copy_tally()
            state, m = step(model, state, {"tokens": torch.from_numpy(tokens)})
            tallies.append(mesh.tally_since(mark))
            metrics.append({k: float(v) for k, v in m.items()})
            moments.append({part: {k: t.numpy().copy() for k, t in state[part].items()}
                            for part in ("m", "v")})
        out[name] = dict(
            coord=mesh.coord, metrics=metrics, tallies=tallies, moments=moments,
            params={n: p.detach().numpy() for n, p in model.named_parameters()},
            blocks=dict(model.blocks),
            moment_blocks=moment_blocks(model, mesh, case["zero1"]))
    return out


def moment_blocks(model, mesh, zero1: bool) -> dict:
    """Each moment's block of its stacked whole leaf (by leaf path): the
    stack dims whole, a layer's block as the model holds it, and the
    ZeRO-1 dimension cut to the rank's block (`RankLeaf.moment_block`)."""
    batch_axes = tuple(a for a in mesh.axis_names if a != "model")
    return {leaf.path: leaf.moment_block
            for leaf in rank_leaves(model, (mesh, batch_axes), zero1)}


def stop_resume(cfg, mesh, ckpt: Path, kw: dict, held: bool = False) -> dict:
    """`train_loop` (``kw``: steps, batch, seq, lr) on ``mesh``: a straight
    run, and the same run stopped after half its steps with a checkpoint
    (the all-zero position writes) and resumed by every rank.  Returns
    this rank's losses of each; with ``held``, what the rank held when
    it stopped (`_held`)."""
    kw = dict(kw, print_fn=lambda *_: None)
    straight = train_loop(cfg, mesh, **kw)["losses"]
    half = kw["steps"] // 2
    first = train_loop(cfg, mesh, ckpt_dir=ckpt, ckpt_every=half, stop_at=half,
                       **kw)
    rest = train_loop(cfg, mesh, ckpt_dir=ckpt, ckpt_every=half, resume=True,
                      **kw)["losses"]
    out = dict(straight=straight, resumed=first["losses"] + rest)
    if held:
        out["held"] = _held(first["model"], first["opt_state"], mesh, False)
    return out


def train_loops(cfg, store: str, kw: dict) -> dict:
    """`stop_resume` on a (2, 1) mesh of the job's two ranks (the state
    replicated) and on (1, 2), whose ranks hold blocks: by shape, this
    rank's losses of each run."""
    return {shape: stop_resume(cfg, make_rank_mesh(shape, device="cpu"),
                               Path(store) / f"ckpt_{shape[0]}x{shape[1]}", kw)
            for shape in ((2, 1), (1, 2))}


def step_tallies(cfg, specs: dict, shapes: list) -> dict:
    """The collective tally of one call of each cell step (`dryrun.
    cell_step`; ``specs``: name -> (ShapeSpec, remat policy)) on a (data,
    model) mesh of each shape, the rank's model built from seed 0: by
    (shape, name), this rank's position and tally."""
    from repro_torch.launch.dryrun import cell_step

    out = {}
    for shape in shapes:
        mesh = make_rank_mesh(shape, device="cpu",
                              ranks=range(int(np.prod(shape))))
        if not mesh.is_member:
            continue
        for name, (sp, policy) in specs.items():
            c = dataclasses.replace(cfg, remat_policy=policy)
            model = build_model(c, "cpu", seed=0, shard=ParamShard.of(mesh))
            call, _ = cell_step(c, sp, model, mesh=mesh,
                                generator=torch.Generator().manual_seed(0))
            mark = mesh.copy_tally()
            call()
            out[shape, name] = dict(position=tuple(mesh.coord.values()),
                                    tally=mesh.tally_since(mark))
    return out


def _shapes(tree, prefix=()):
    """Each leaf's shape by key path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def tp_family(cfgs: dict, tree: dict, serve_cases: dict,
              train_cases: dict) -> dict:
    """One family's tensor-parallel job.  ``cfgs``: name -> config (one
    family, the same parameter tree ``tree``); ``serve_cases``: name ->
    dict of ``cfg`` (a name of ``cfgs``), ``shape``, ``prompts`` (global
    (B, P) int32), ``prompts_frontend`` (or None) and ``gen``: greedy
    `serve_batch` of the rank's model carried from ``tree``, returning
    this rank's coordinate, tokens, logits, collective tally (prefill and
    first decode), the shapes of the caches it holds, the leaves it
    holds of the carried model and of one built from seed 0.
    ``train_cases``: name -> dict of ``cfg``, ``shape``, ``train`` (a list
    of global (B, S) token arrays), ``train_frontend`` (a list of global
    frontend arrays, or None), ``zero1`` and ``remat``: each step's
    metrics of `make_train_step`."""
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_rank_mesh(shape, device="cpu",
                                           ranks=range(int(np.prod(shape))))
        return meshes[shape]

    out = {"serve": {}, "train": {}}
    for name, case in serve_cases.items():
        mesh = mesh_of(tuple(case["shape"]))
        if not mesh.is_member:
            continue
        cfg = cfgs[case["cfg"]]
        model = rank_model_from(cfg, tree, mesh)
        prompts = case["prompts"]
        res = serve_batch(cfg, mesh, prompts, case["gen"],
                          frontend=case.get("prompts_frontend"), model=model,
                          keep_logits=True, print_fn=lambda *_: None,
                          device="cpu")
        caches = model.init_caches(prompts.shape[0], prompts.shape[1] + case["gen"])
        seeded = build_model(cfg, "cpu", seed=0, shard=ParamShard.of(mesh))
        out["serve"][name] = dict(
            coord=mesh.coord, tokens=res["tokens"], logits=res["logits"].numpy(),
            collectives=res["collectives"], cache_shapes=_shapes(caches),
            carried=_numpy(reference_tree(model)),
            seeded=_numpy(reference_tree(seeded)))
    for name, case in train_cases.items():
        mesh = mesh_of(tuple(case["shape"]))
        if not mesh.is_member:
            continue
        cfg = cfgs[case["cfg"]]
        model = rank_model_from(cfg, tree, mesh)
        bundle = make_train_step(cfg, mesh, opt=TRAIN_OPT, remat=case["remat"],
                                 zero1=case["zero1"])
        state, step = bundle.init_opt(model), bundle.jit_for(None)
        metrics = []
        for i, tokens in enumerate(case["train"]):
            batch = {"tokens": torch.from_numpy(tokens)}
            if case["train_frontend"] is not None:
                batch["frontend"] = torch.from_numpy(case["train_frontend"][i])
            state, m = step(model, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out["train"][name] = dict(coord=mesh.coord, metrics=metrics)
    return out


def head_dim(cfgs: dict, trees: dict, cases: dict) -> dict:
    """Greedy `serve_batch` of a model built with the head-dim fallback
    (``shard_head_dim_fallback=True``, which its serve step takes) for each
    case (name -> dict of ``cfg``, a name of ``cfgs`` and ``trees``,
    ``shape``, ``prompts``, ``frontend`` (or None) and ``gen``), each
    rank's model carried from the case's reference tree with the flag
    (`rank_model_from`): this rank's coordinate, tokens, logits,
    collective tally and the leaves it holds (as the reference's stacked
    tree)."""
    meshes = {}
    out = {}
    for name, case in cases.items():
        shape = tuple(case["shape"])
        if shape not in meshes:
            meshes[shape] = make_rank_mesh(shape, device="cpu",
                                           ranks=range(int(np.prod(shape))))
        mesh = meshes[shape]
        if not mesh.is_member:
            continue
        cfg = cfgs[case["cfg"]]
        model = rank_model_from(cfg, trees[case["cfg"]], mesh, head_dim_fallback=True)
        res = serve_batch(cfg, mesh, case["prompts"], case["gen"],
                          frontend=case["frontend"], model=model,
                          keep_logits=True, print_fn=lambda *_: None,
                          device="cpu")
        out[name] = dict(coord=mesh.coord, tokens=res["tokens"],
                         logits=res["logits"].numpy(),
                         collectives=res["collectives"],
                         carried=_numpy(reference_tree(model)))
    return out


def _held(model, state, mesh, zero1: bool) -> dict:
    """What a rank holds of each leaf, by path: its parameter block (its
    layers stacked), moments and step, and the block of the whole
    stacked leaf each is (`RankLeaf`)."""
    named = dict(model.named_parameters())
    batch_axes = tuple(a for a in mesh.axis_names if a != "model")
    out = {}
    for leaf in rank_leaves(model, (mesh, batch_axes), zero1):
        mine = [named[n].detach() for n in leaf.names]
        p = torch.stack(mine).reshape(*leaf.lead, *mine[0].shape) if leaf.lead \
            else mine[0]
        out[leaf.path] = dict(
            whole=leaf.whole, moment_block=leaf.moment_block,
            block=tuple(slice(0, n) for n in leaf.lead) + leaf.layer_block,
            p=p.numpy().copy(), m=state["m"][leaf.path].numpy().copy(),
            v=state["v"][leaf.path].numpy().copy())
    return {"leaves": out, "step": int(state["step"])}


def checkpoints(cfgs: dict, store: str, kw: dict, batches: list) -> dict:
    """Checkpoints of ranks that hold blocks, for each config of ``cfgs``
    (name -> config): `stop_resume` on (1, 2) (its step-2 checkpoint
    under ``<store>/<name>``), what each rank held when it stopped there
    (`_held`); that step restored (`CheckpointManager.restore`,
    `rank_state_from`) on (1, 4) and on (2, 2) without and with ZeRO-1,
    each rank's blocks; and on (2, 2) with ZeRO-1, the state after one
    train step on ``batches[0]`` from seed 0 written by the ranks
    (`reference_state`; the all-zero position writes step 1 under
    ``<store>/<name>_zero1``) and the blocks each held."""
    meshes = {shape: make_rank_mesh(shape, device="cpu",
                                    ranks=range(int(np.prod(shape))))
              for shape in ((1, 2), (1, 4), (2, 2))}
    out = {}
    for name, cfg in cfgs.items():
        ckpt = Path(store) / name
        mesh = meshes[(1, 2)]
        res = {}
        if mesh.is_member:
            res["loop"] = stop_resume(cfg, mesh, ckpt, kw, held=True)
        torch.distributed.barrier()  # the checkpoints are on disk
        for shape, zero1 in (((1, 4), False), ((2, 2), False), ((2, 2), True)):
            mesh = meshes[shape]
            if not mesh.is_member:
                continue
            model = Model(cfg, mesh.device, ParamShard.of(mesh))
            state, _ = CheckpointManager(ckpt).restore(
                state_template(model), step=kw["steps"] // 2)
            batch_axes = tuple(a for a in mesh.axis_names if a != "model")
            opt = rank_state_from(model, state, (mesh, batch_axes), zero1)
            res[f"restored_{shape[0]}x{shape[1]}" + ("_zero1" if zero1 else "")] = \
                dict(_held(model, opt, mesh, zero1), coord=mesh.coord)
        mesh = meshes[(2, 2)]
        if mesh.is_member:
            model = build_model(cfg, "cpu", seed=0, shard=ParamShard.of(mesh))
            bundle = make_train_step(cfg, mesh, opt=TRAIN_OPT, remat=False, zero1=True)
            state = bundle.init_opt(model)
            state, _ = bundle.jit_for(None)(model, state,
                                            {"tokens": torch.from_numpy(batches[0])})
            writer = mesh.coord == {"data": 0, "model": 0}
            tree = reference_state(model, state, (mesh, ("data",)), zero1=True,
                                   keep=writer)
            if writer:
                CheckpointManager(Path(store) / f"{name}_zero1").save(1, tree)
            res["zero1"] = dict(_held(model, state, mesh, True), coord=mesh.coord)
        torch.distributed.barrier()
        out[name] = res
    return out

