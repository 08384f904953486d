"""What the ranks of the rank tests run (`repro_torch.launch.mesh.run_ranks`).

The spawned ranks import this module by name, so it imports neither jax
nor the reference package: the tests compute the reference's side in the
parent process and hand the ranks numpy inputs.  Every rank of a job makes
every mesh of a body (`make_rank_mesh` is collective) and works only on
the meshes that hold it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mapping_device import island_sa
from repro_torch.interop import rank_model_from, reference_tree
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.models import build_model
from repro_torch.models.moe import moe_ffn_sharded
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


def serve(cfg, tree: dict, prompts: np.ndarray, gen_len: int,
          shapes: list) -> dict:
    """Greedy `serve_batch` on a (data, model) mesh of each shape, each
    rank's model carried from the reference tree (`rank_model_from`), and
    this rank's experts of a model built from seed 0 (first layer); the
    expert shard is (index, count): the block the model holds of the
    experts, and how many such blocks they make."""
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
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def tensor_parallel(cfg, tree, prompts: np.ndarray, gen_len: int,
                    shapes: list) -> dict:
    """Greedy `serve_batch` on a (data, model) mesh of each shape, each
    rank's model carried from the reference tree (`rank_model_from`):
    this rank's coordinate, tokens, logits and collective tally, and the
    leaves it holds (as the reference's stacked tree) of the carried model
    and of a model built from seed 0 for its position."""
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
