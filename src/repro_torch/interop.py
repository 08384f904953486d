"""Carry the reference's artifacts over into this package's dataclasses.

The tests feed each stage of the port the reference's own upstream output,
so that a fault shows up in the stage that caused it.  Every function here
takes plain numpy fields — a dict, or any object with the attributes — and
never a type of the reference package, which this package does not import.
Model weights travel as the reference's parameter tree of numpy arrays
(`model_params_from`; one rank's model of a mesh of ranks,
`rank_model_from`) and back (`reference_tree`, `reference_path`), and
AdamW's moments as the reference's optimizer state (`opt_state_from`,
`reference_opt_state`).  A rank's whole training state travels as the
reference's whole ``(params, opt_state)`` tree: gathered leaf by leaf
over the mesh (`reference_state`), and cut back into any mesh's blocks
(`rank_state_from`), which is how a checkpoint written on one mesh
restores on another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, Hypergraph
from repro_torch.core.partition import PartitionResult
from repro_torch.models.model import Model, reference_path
from repro_torch.optim.adamw import rank_leaves
from repro_torch.runtime.elastic import Sharded
from repro_torch.sharding.planner import ParamShard
from repro_torch.snn.simulate import ProfileResult
from repro_torch.snn.topology import SNNTopology

__all__ = ["graph_from", "hypergraph_from", "partition_from", "profile_from",
           "topology_from", "model_params_from", "rank_model_from",
           "load_reference_tree",
           "reference_path", "reference_tree", "opt_state_from",
           "reference_opt_state", "reference_state", "rank_state_from",
           "state_template"]


def _get(obj, name: str, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _arr(obj, name: str) -> np.ndarray:
    return np.array(_get(obj, name))


def topology_from(obj) -> SNNTopology:
    """An `SNNTopology` from ``syn_src``, ``syn_dst``, the dense ``weights``
    and the stimulus fields (``name``, ``layer_sizes``, ``input_size``,
    ``input_rate``, ``input_amp``, ``target_spikes``)."""
    return SNNTopology(
        name=str(_get(obj, "name")),
        layer_sizes=[int(v) for v in _get(obj, "layer_sizes")],
        syn_src=_arr(obj, "syn_src"),
        syn_dst=_arr(obj, "syn_dst"),
        weights=_arr(obj, "weights"),
        input_size=int(_get(obj, "input_size")),
        input_rate=float(_get(obj, "input_rate")),
        input_amp=float(_get(obj, "input_amp")),
        target_spikes=(None if _get(obj, "target_spikes") is None
                       else int(_get(obj, "target_spikes"))),
        meta=dict(_get(obj, "meta", None) or {}),
    )


def hypergraph_from(obj) -> Hypergraph:
    """A `Hypergraph` from its CSR fields (``hxadj``, ``hpins``, ``hwgt``,
    ``hsrc``, ``hfire``, ``num_vertices``)."""
    return Hypergraph(
        hxadj=_arr(obj, "hxadj"), hpins=_arr(obj, "hpins"),
        hwgt=_arr(obj, "hwgt"), hsrc=_arr(obj, "hsrc"),
        hfire=_arr(obj, "hfire"), num_vertices=int(_get(obj, "num_vertices")),
    )


def graph_from(obj) -> Graph:
    """A `Graph` from its CSR fields (``xadj``, ``adjncy``, ``adjwgt``,
    ``vwgt``), with a coarsening level's ``cmap`` and the ``hyper`` view
    attached when the source has them."""
    graph = Graph(_arr(obj, "xadj"), _arr(obj, "adjncy"),
                  _arr(obj, "adjwgt"), _arr(obj, "vwgt"))
    if _get(obj, "cmap") is not None:
        graph.cmap = _arr(obj, "cmap")
    hyper = _get(obj, "hyper")
    if hyper is not None:
        graph.hyper = hypergraph_from(hyper)
    return graph


def profile_from(obj) -> ProfileResult:
    """A `ProfileResult` from a profile's fields, its ``graph`` (and the
    graph's ``hyper``) given the same way."""
    return ProfileResult(
        name=str(_get(obj, "name")),
        graph=graph_from(_get(obj, "graph")),
        trace_t=_arr(obj, "trace_t"),
        trace_src=_arr(obj, "trace_src"),
        trace_dst=_arr(obj, "trace_dst"),
        num_neurons=int(_get(obj, "num_neurons")),
        num_steps=int(_get(obj, "num_steps")),
        fire_counts=_arr(obj, "fire_counts"),
        seconds=float(_get(obj, "seconds", 0.0)),
    )


def partition_from(obj) -> PartitionResult:
    """A `PartitionResult` from ``part``, ``k``, ``edge_cut``, ``capacity``
    and the optional bookkeeping fields."""
    vol = _get(obj, "comm_volume")
    return PartitionResult(
        part=_arr(obj, "part"), k=int(_get(obj, "k")),
        edge_cut=int(_get(obj, "edge_cut")),
        capacity=int(_get(obj, "capacity")),
        num_levels=int(_get(obj, "num_levels", 0)),
        seconds=float(_get(obj, "seconds", 0.0)),
        impl=str(_get(obj, "impl", "scalar")),
        objective=str(_get(obj, "objective", "cut")),
        comm_volume=None if vol is None else int(vol),
    )


# ------------------------------------------------------------ model weights


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _as_tensor(leaf) -> torch.Tensor:
    """A numpy array (bfloat16 included, as jax's ``np.asarray`` gives it)
    or a tensor, as a CPU tensor of the same dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _named_leaves(model: Model) -> dict:
    """`Model.reference_leaves` with each parameter's name:
    keys -> (stacked shape, [(stack index, name, parameter), ...])."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {keys: (shape, [(index, names[id(p)], p) for index, p in items])
            for keys, (shape, items) in model.reference_leaves().items()}


def _unstack(model: Model, tree, put, same_dtype: bool) -> None:
    """Check ``tree`` (the reference's parameter-shaped tree) against the
    model's leaves — every key, each stacked shape and, where
    ``same_dtype``, the parameter's dtype — and call ``put(name,
    parameter, slice)`` for each layer's slice."""
    flat = {k: _as_tensor(v) for k, v in _flatten(tree).items()}
    leaves = _named_leaves(model)
    missing, extra = sorted(set(leaves) - set(flat)), sorted(set(flat) - set(leaves))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, extra {extra}")
    for keys, (shape, items) in leaves.items():
        got, dtype = flat[keys], items[0][2].dtype
        if tuple(got.shape) != shape or (same_dtype and got.dtype != dtype):
            raise ValueError(f"{'/'.join(keys)}: {tuple(got.shape)} {got.dtype}, "
                             f"expected {shape} {dtype}")
        for index, name, param in items:
            put(name, param, got[index])


def _stack(model: Model, value_of) -> dict:
    """The reference's parameter-shaped tree of CPU tensors, each leaf
    stacked from ``value_of(name, parameter)`` of its layers."""
    tree: dict = {}
    for keys, (shape, items) in _named_leaves(model).items():
        first = value_of(items[0][1], items[0][2])
        leaf = torch.empty(shape, dtype=first.dtype)
        for index, name, param in items:
            leaf[index] = value_of(name, param).detach().cpu()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def load_reference_tree(model: Model, tree) -> Model:
    """Copy the reference's parameter tree into ``model``'s parameters in
    place (see `model_params_from`); returns the model."""
    with torch.no_grad():
        _unstack(model, tree, lambda _name, param, value: param.copy_(value),
                 same_dtype=True)
    return model


def model_params_from(cfg, tree, device: "str | torch.device" = "cuda") -> Model:
    """The port's `Model` for ``cfg`` on ``device``, loaded with the
    reference's ``init_params`` tree given as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``) or tensors.  The stacked
    leading (L,) dims — (groups, per) for the VLM's self layers — are
    unstacked; dtypes are kept, bfloat16 included.  Raises ValueError on a
    missing or extra leaf, or a leaf of another shape or dtype."""
    return load_reference_tree(Model(cfg, device), tree)


def _blocks_of(model: Model, tree, keys=()):
    """The reference's whole parameter tree cut to the blocks ``model``
    holds (`Model.leaf_block`), as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _blocks_of(model, v, keys + (str(k),)) for k, v in tree.items()}
    leaf = _as_tensor(tree)
    return leaf[model.leaf_block(keys, leaf.shape)]


def rank_model_from(cfg, tree, mesh, head_dim_fallback: bool = False) -> Model:
    """This rank's `Model` on a mesh of ranks, on the rank's device, from
    the reference's whole parameter tree (as `model_params_from` takes
    it): each stacked leaf is cut to the block the rank's model holds
    (`Model.leaf_block`: the planner's spec of the leaf for the rank's
    position, ``ParamShard.of(mesh, head_dim_fallback)``, through
    `shard_slices`)."""
    model = Model(cfg, mesh.device, ParamShard.of(mesh, head_dim_fallback))
    return load_reference_tree(model, _blocks_of(model, tree))


def reference_tree(model: Model) -> dict:
    """The reverse of `model_params_from`: the reference's parameter tree
    as nested dicts of CPU tensors, each layer stack stacked again (names
    mapped by `reference_path`)."""
    return _stack(model, lambda _name, param: param)


def opt_state_from(model: Model, ref_opt_state, mesh_info=None,
                   zero1: bool = False) -> dict:
    """The port's optimizer state for ``model`` (`repro_torch.optim`:
    moments keyed by the reference leaf's path, each stacked as the
    model's leaf, on the model's device) from the reference's ``{"m":
    tree, "v": tree, "step"}``, its moment trees shaped as the whole
    parameter tree; moment dtypes are kept.  On a rank of a mesh of ranks
    (``mesh_info = (mesh, batch_axes)``, ``model`` holding its blocks)
    each moment is cut to the block the rank's update keeps
    (`repro_torch.optim.adamw.RankLeaf.moment_block`, ZeRO-1's cut with
    ``zero1``).  Raises ValueError on a missing or extra leaf, or a leaf
    of another whole shape."""
    leaves = rank_leaves(model, mesh_info, zero1)
    paths = {leaf.path for leaf in leaves}
    out: dict = {}
    for part in ("m", "v"):
        flat = {"/".join(k): v for k, v in _flatten(ref_opt_state[part]).items()}
        missing, extra = sorted(paths - set(flat)), sorted(set(flat) - paths)
        if missing or extra:
            raise ValueError(f"{part} tree mismatch: missing {missing}, extra {extra}")
        out[part] = {}
        for leaf in leaves:
            whole = _as_tensor(flat[leaf.path])
            if tuple(whole.shape) != leaf.whole:
                raise ValueError(f"{part} {leaf.path}: {tuple(whole.shape)}, "
                                 f"expected {leaf.whole}")
            out[part][leaf.path] = whole[leaf.moment_block].to(
                model.device, copy=True).contiguous()
    out["step"] = _as_tensor(ref_opt_state["step"]).to(torch.int32).to(model.device)
    return out


def rank_state_from(model: Model, state, mesh_info=None,
                    zero1: bool = False) -> dict:
    """Load the reference's whole training state ``state = (params,
    opt_state)`` (trees as `model_params_from` and `opt_state_from` take
    them, with the whole leaves, e.g. a checkpoint's) into ``model`` and
    return its optimizer state (`opt_state_from`): on a rank of a mesh of
    ranks (``mesh_info = (mesh, batch_axes)``), the parameters cut to the
    model's blocks (`Model.leaf_block`, as `rank_model_from` cuts them)
    and the moments to the rank's blocks, ``step`` whole; on one card
    every leaf whole.  A parameter is cast to the model's dtype, as the
    reference's restore casts to its template.  Raises ValueError on a
    missing or extra leaf, or a leaf of another whole shape."""
    params, ref_opt = state
    with torch.no_grad():
        _unstack(model, _blocks_of(model, params),
                 lambda _name, param, value: param.copy_(value), same_dtype=False)
    return opt_state_from(model, ref_opt, mesh_info, zero1)


def reference_state(model: Model, opt_state: dict, mesh_info=None,
                    zero1: bool = False, keep: bool = True):
    """The reverse of `rank_state_from`: the reference's whole ``(params,
    {"m", "v", "step"})`` tree of ``model`` and its optimizer state, as
    CPU tensors.  On one card, `reference_tree` and `reference_opt_state`.
    On a rank of a mesh of ranks (``mesh_info``; ``zero1`` as the state
    was made) every rank of the mesh must call it: each leaf's blocks
    are gathered whole over the axes that split them
    (`repro_torch.runtime.elastic.Sharded.full`, bit for bit), leaf by
    leaf in the reference's leaf order, and moved to the host before the
    next is gathered, so a card never holds more than one whole leaf; a
    rank with ``keep=False`` takes part in the gathers and returns
    None."""
    if mesh_info is None:
        return reference_tree(model), reference_opt_state(model, opt_state)
    mesh = mesh_info[0]
    named = dict(model.named_parameters())
    params: dict = {}
    ref_opt: dict = {"m": {}, "v": {}}
    here = tuple(mesh.coord[a] for a in mesh.axis_names)
    for leaf in rank_leaves(model, mesh_info, zero1):
        mine = [named[n].detach() for n in leaf.names]
        local = (torch.stack(mine).reshape(*leaf.lead, *mine[0].shape)
                 if leaf.lead else mine[0])
        for tree, t, spec in ((params, local, leaf.spec),
                              (ref_opt["m"], opt_state["m"][leaf.path], leaf.moment_spec),
                              (ref_opt["v"], opt_state["v"][leaf.path], leaf.moment_spec)):
            whole = Sharded({here: t}, leaf.whole, mesh, spec).full()
            if keep:
                *keys, name = leaf.path.split("/")
                node = tree
                for k in keys:
                    node = node.setdefault(k, {})
                node[name] = whole.cpu()
            del whole
    if not keep:
        return None
    ref_opt["step"] = opt_state["step"].detach().to("cpu", copy=True)
    return params, ref_opt


def state_template(model: Model):
    """The keys of the whole ``(params, {"m", "v", "step"})`` tree of
    ``model`` with None leaves: a template for
    `repro_torch.runtime.CheckpointManager.restore`, which then returns
    the stored arrays as they are."""
    params: dict = {}
    for keys in model.reference_leaves():
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = None
    return params, {"m": params, "v": params, "step": None}


def reference_opt_state(model: Model, opt_state: dict) -> dict:
    """The reverse of `opt_state_from`: ``{"m", "v"}`` as the reference's
    stacked trees of CPU tensors (copies, which later updates leave as
    they are) and ``step`` as a CPU int32 0-d tensor."""
    out = {"step": opt_state["step"].detach().to("cpu", copy=True)}
    for part in ("m", "v"):
        tree = out[part] = {}
        for path, t in opt_state[part].items():
            *keys, leaf = path.split("/")
            node = tree
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().to("cpu", copy=True)
    return out
