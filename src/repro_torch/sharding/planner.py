"""Sharding plans: the LLM scaffolding's rule-based parameter, cache,
batch and optimizer-state specs, and the partitioning engine's vertex-block
plan.

Parameter rules are keyed on parameter names and *negative* dimension
indices, so the same rule applies whether a leaf is a single layer or
carries one or two leading stack dims.  Every rule is guarded by a
divisibility check against the mesh axis size — a dimension that does not
divide evenly falls back to replication and the drop is recorded in the
plan (`ShardingPlan.notes`, in the reference's wording) rather than
failing (e.g. GQA kv=5 heads on a 16-way model axis).

Layout convention (Megatron-style TP over the `model` axis, DP over
`data`/`pod`):
  * embedding / lm_head: vocab-parallel,
  * attention q/k/v/o: head-parallel,
  * MLP gate/up/down: ffn-parallel,
  * MoE experts: expert-parallel (E dim),
  * SSD in/out projections: inner-dim-parallel,
  * optimizer m/v: parameter sharding + ZeRO-1 over the data axes on the
    first still-replicated divisible dim.

The rules are pure functions of (path names, shape) over a plan that holds
the mesh's *shape* (``{"data": 16, "model": 16}``), not its devices; a
spec is a tuple with one axis name, tuple of axis names or None per
dimension, ``()`` for fully replicated (the reference's ``P()``).  Trees
are nested dicts whose leaves have a ``.shape`` (tensors, shape structs)
or are shapes; they are walked in sorted key order, as the reference
walks the ``jax.eval_shape`` trees it plans (jax returns dicts with sorted
keys), so ``notes`` list the same drops in the same order.  `shard_slices`
gives the block of a leaf that a mesh position holds under a spec: on a
mesh of ranks, `repro_torch.runtime.remesh_params` places any spec with
it, and a rank's model (`repro_torch.models.Model` with a `ParamShard`)
holds the block of every leaf that its position's spec gives
(`ParamShard.block`) and of every decode-cache leaf that ``plan_caches``
gives (`ParamShard.cache_blocks`).

The partitioning engine shards its O(n)/O(m) state over contiguous vertex
blocks (CSR rows stay contiguous per shard, so per-shard adjacency slices
are zero-copy views).  Uneven or device-incompatible layouts degrade
gracefully: the plan stays host-only and records the reason in ``notes``
instead of failing.

Where the reference attaches a ``jax.sharding.NamedSharding`` over a 1-D
``vertex`` mesh axis, the plan here carries a list of torch devices, one
per shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["ShardingPlan", "plan_params", "plan_caches", "plan_batch",
           "plan_opt_state", "zero1_spec", "spec_for_param", "shard_slices",
           "ParamShard", "VertexShardPlan", "plan_vertex_shards"]

Spec = tuple


# (name, neg_dim) -> shard over model axis.  None neg_dim = replicate.
_PARAM_RULES: list[tuple[str, int | None]] = [
    ("embed", -2),
    ("lm_head", -1),
    ("frontend_proj", -1),
    ("wq", -2), ("wk", -2), ("wv", -2), ("wo", -3),
    ("w_q", -2), ("w_uk", -2), ("w_uv", -2), ("w_o", -3),
    ("w_dkv", None), ("w_kpe", None),
    ("router", None),
    ("in_proj", -1), ("out_proj", -2),
    ("conv_w", None), ("dt_bias", None), ("a_log", None), ("d_skip", None),
    ("gate_attn", None), ("gate_mlp", None),
]
_MOE_RULES = {"w_gate": -3, "w_up": -3, "w_down": -3}
_MLP_RULES = {"w_gate": -1, "w_up": -1, "w_down": -2}


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _is_leaf(node) -> bool:
    return not isinstance(node, dict)


def _map_sorted(fn, tree, names=()):
    """``fn(names, leaf)`` over a nested dict, keys visited sorted."""
    if _is_leaf(tree):
        return fn(list(names), tree)
    return {k: _map_sorted(fn, tree[k], names + (str(k),)) for k in sorted(tree)}


@dataclass
class ShardingPlan:
    mesh_shape: dict[str, int]
    model_axis: str = "model"
    batch_axes: tuple[str, ...] = ("data",)
    # Spread a batch-unshardable decode cache's sequence dim over the idle
    # batch axes too ("sequence-parallel decode"). False = the baseline
    # layout (model axis only).
    seq_parallel_decode: bool = True
    # When an attention projection's head count does not divide the model
    # axis (Hymba's 25 heads, GQA kv=5), shard its head_dim instead of
    # replicating.
    shard_head_dim_fallback: bool = False
    notes: list[str] = field(default_factory=list)

    @property
    def batch_size_divisor(self) -> int:
        return int(np.prod([self.mesh_shape[a] for a in self.batch_axes]))


def _shard_dim(plan: ShardingPlan, shape, neg_dim: int | None, axis: str,
               name: str) -> Spec:
    if neg_dim is None:
        return ()
    ndim = len(shape)
    spec = [None] * ndim
    dim = ndim + neg_dim
    if 0 <= dim < ndim:
        if shape[dim] % plan.mesh_shape[axis] == 0:
            spec[dim] = axis
        else:
            plan.notes.append(
                f"{name}: dim {dim} size {shape[dim]} !% {axis}"
                f"({plan.mesh_shape[axis]}) -> replicated")
            return ()
    return tuple(spec)


def spec_for_param(plan: ShardingPlan, names, leaf) -> Spec:
    """The spec of the parameter at path ``names`` (its keys, last the
    leaf name) with shape ``leaf`` (or ``leaf.shape``)."""
    names = list(names)
    leaf_name = names[-1] if names else ""
    under_moe = "moe" in names
    shape = _shape(leaf)
    path = "/".join(names)
    if leaf_name in _MOE_RULES and under_moe:
        return _shard_dim(plan, shape, _MOE_RULES[leaf_name], plan.model_axis, path)
    if leaf_name in _MLP_RULES and not under_moe:
        return _shard_dim(plan, shape, _MLP_RULES[leaf_name], plan.model_axis, path)
    for rule_name, neg_dim in _PARAM_RULES:
        if leaf_name == rule_name:
            spec = _shard_dim(plan, shape, neg_dim, plan.model_axis, path)
            if (spec == () and plan.shard_head_dim_fallback
                    and leaf_name in ("wq", "wk", "wv", "wo", "w_q", "w_uk",
                                      "w_uv", "w_o")):
                hd_dim = -1 if leaf_name not in ("wo", "w_o") else -2
                spec = _shard_dim(plan, shape, hd_dim, plan.model_axis,
                                  path + "(hd-fallback)")
            return spec
    # norms, scales, biases and anything unrecognized: replicate.
    return ()


def shard_slices(spec: Spec, shape, mesh_shape: dict[str, int],
                 coord: dict[str, int]) -> tuple[slice, ...]:
    """The block of a leaf of ``shape`` that the mesh position ``coord``
    (an index per axis) holds under ``spec``: a dimension split over axes
    (a name, or a tuple of names: the first is the major one) is cut into
    as many equal blocks as those axes have positions, and the position
    takes the block of its index flattened over them, as jax places a
    ``NamedSharding``; a dimension with None, or past the spec's end, is
    whole.  Raises ValueError where a split dimension does not divide."""
    out = []
    for dim, size in enumerate(_shape(shape)):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, tuple) else (entry,))
        n, index = 1, 0
        for a in axes:
            n, index = n * mesh_shape[a], index * mesh_shape[a] + coord[a]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(_shape(shape))} does not "
                             f"split over {axes} ({n} positions)")
        block = size // n
        out.append(slice(index * block, (index + 1) * block))
    return tuple(out)


@dataclass(frozen=True)
class ParamShard:
    """One position of a mesh, as a rank holds the parameters there: the
    mesh's shape (axis -> size), the position's index on each axis and
    whether the plan splits an attention projection's head_dim where its
    heads do not divide the model axis (``ShardingPlan.
    shard_head_dim_fallback``).  The default is a one-position mesh,
    whose blocks are every leaf whole."""
    mesh_shape: dict = field(default_factory=lambda: {"model": 1})
    coord: dict = field(default_factory=lambda: {"model": 0})
    head_dim_fallback: bool = False

    @classmethod
    def of(cls, mesh, head_dim_fallback: bool = False) -> "ParamShard":
        """This rank's position on a rank mesh (``mesh.coord``)."""
        return cls(dict(mesh.shape), dict(mesh.coord), head_dim_fallback)

    def at(self, mesh) -> bool:
        """Whether this is the position of ``mesh`` (its shape and this
        rank's coordinate), whatever the flag."""
        return (dict(mesh.shape), dict(mesh.coord)) == (self.mesh_shape, self.coord)

    @property
    def whole(self) -> bool:
        """Whether every leaf's block is the leaf (a model axis of 1)."""
        return self.mesh_shape.get("model", 1) == 1

    def block(self, names, leaf) -> tuple[Spec, tuple[slice, ...]]:
        """The planner's spec of the parameter at path ``names`` with shape
        ``leaf`` (`spec_for_param`, under ``head_dim_fallback``; ``()``
        where the leaf stays whole) and the block of it this position
        holds (`shard_slices`)."""
        shape = _shape(leaf)
        spec = () if self.whole else spec_for_param(
            ShardingPlan(mesh_shape=dict(self.mesh_shape),
                         shard_head_dim_fallback=self.head_dim_fallback),
            names, shape)
        return spec, shard_slices(spec, shape, self.mesh_shape, self.coord)

    def cache_blocks(self, caches, seq_parallel_decode: bool = True) -> dict:
        """The ``plan_caches`` spec of each leaf of the whole decode-cache
        tree ``caches`` (nested dicts of leaves with a ``.shape``) and the
        block of it this position holds, by the leaf's key path: the KV
        groups' ``heads``, ``seq`` and ``replicated`` modes, the batch
        axes joining a sequence split where the batch does not divide
        (``seq_parallel_decode``), the MLA latents' sequence split and
        the SSM state's heads and conv tail's channels.  A one-position
        mesh holds every leaf whole."""
        shape, coord = dict(self.mesh_shape), dict(self.coord)
        shape.setdefault("model", 1)
        coord.setdefault("model", 0)
        out: dict = {}
        if all(n == 1 for n in shape.values()):
            _map_sorted(lambda names, leaf: out.setdefault(tuple(names), (
                (), tuple(slice(0, n) for n in _shape(leaf)))), caches)
            return out
        plan = ShardingPlan(mesh_shape=shape,
                            batch_axes=tuple(a for a in shape if a != "model"),
                            seq_parallel_decode=seq_parallel_decode)
        specs = plan_caches(plan, caches)

        def one(names, leaf):
            spec = specs
            for k in names:
                spec = spec[k]
            out[tuple(names)] = (spec, shard_slices(spec, leaf, shape, coord))

        _map_sorted(one, caches)
        return out


def plan_params(plan: ShardingPlan, params) -> dict:
    return _map_sorted(lambda names, leaf: spec_for_param(plan, names, leaf),
                       params)


# --------------------------------------------------------------- caches

def _batch_entry(plan: ShardingPlan):
    return plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]


def _spec_with(ndim: int, assigns: dict) -> Spec:
    spec: list = [None] * ndim
    for dim, ax in assigns.items():
        if 0 <= dim < ndim:
            spec[dim] = ax
    return tuple(spec)


def _kv_group_specs(plan: ShardingPlan, group: dict, names) -> dict:
    """Joint strategy for a {k, v, pos} KV-cache group.

    Prefer sharding KV heads over the model axis (no extra collectives in
    attention); when head count does not divide (GQA kv < model size),
    shard the SEQUENCE dim instead.  When the batch itself cannot shard
    (long-context decode at batch=1), the otherwise-idle batch axes join
    the sequence sharding ("sequence-parallel decode").
    """
    k = _shape(group["k"])
    msize = plan.mesh_shape[plan.model_axis]
    ndim = len(k)
    kvh_dim, seq_dim = ndim - 2, ndim - 3
    div = plan.batch_size_divisor
    batch_ok = k[ndim - 4] % div == 0
    if not batch_ok:
        plan.notes.append(f"cache {'/'.join(names)}: batch {k[ndim-4]} !% {div}")
    # Sequence sharding axes: model alone, or everything when batch idles.
    seq_axes = (plan.model_axis,) if (batch_ok or not plan.seq_parallel_decode) \
        else tuple(plan.batch_axes) + (plan.model_axis,)
    seq_div = int(np.prod([plan.mesh_shape[a] for a in seq_axes]))
    seq_entry = seq_axes if len(seq_axes) > 1 else seq_axes[0]

    if batch_ok and k[kvh_dim] % msize == 0:
        kv_model = {kvh_dim: plan.model_axis}
        mode = "heads"
    elif k[seq_dim] % seq_div == 0:
        kv_model = {seq_dim: seq_entry}
        mode = "seq"
    elif k[kvh_dim] % msize == 0:
        kv_model = {kvh_dim: plan.model_axis}
        mode = "heads"
    else:
        kv_model = {}
        mode = "replicated"
        plan.notes.append(f"cache {'/'.join(names)}: kv heads {k[kvh_dim]}"
                          f" and seq {k[seq_dim]} unshardable")
    out = {}
    for name in ("k", "v"):
        assigns = dict(kv_model)
        if batch_ok:
            assigns[ndim - 4] = _batch_entry(plan)
        out[name] = _spec_with(ndim, assigns)
    pos_ndim = len(_shape(group["pos"]))
    pos_assigns = {}
    if batch_ok:
        pos_assigns[pos_ndim - 2] = _batch_entry(plan)
    if mode == "seq":
        pos_assigns[pos_ndim - 1] = seq_entry
    out["pos"] = _spec_with(pos_ndim, pos_assigns)
    return out


def _mla_group_specs(plan: ShardingPlan, group: dict, names) -> dict:
    """{c_kv, k_pe, pos}: latent has no head dim; shard the sequence dim."""
    c = _shape(group["c_kv"])
    msize = plan.mesh_shape[plan.model_axis]
    div = plan.batch_size_divisor
    ndim = len(c)
    seq_ok = c[ndim - 2] % msize == 0
    batch_ok = c[ndim - 3] % div == 0
    out = {}
    for name in ("c_kv", "k_pe"):
        assigns = {}
        if batch_ok:
            assigns[ndim - 3] = _batch_entry(plan)
        if seq_ok:
            assigns[ndim - 2] = plan.model_axis
        out[name] = _spec_with(ndim, assigns)
    pos_ndim = len(_shape(group["pos"]))
    pos_assigns = {}
    if batch_ok:
        pos_assigns[pos_ndim - 2] = _batch_entry(plan)
    if seq_ok:
        pos_assigns[pos_ndim - 1] = plan.model_axis
    out["pos"] = _spec_with(pos_ndim, pos_assigns)
    return out


def _ssm_specs(plan: ShardingPlan, leaf, name: str) -> Spec:
    shape = _shape(leaf)
    msize = plan.mesh_shape[plan.model_axis]
    div = plan.batch_size_divisor
    ndim = len(shape)
    if name == "state":  # (..., B, H, N, P)
        assigns = {}
        if shape[ndim - 4] % div == 0:
            assigns[ndim - 4] = _batch_entry(plan)
        if shape[ndim - 3] % msize == 0:
            assigns[ndim - 3] = plan.model_axis
        return _spec_with(ndim, assigns)
    if name == "conv":  # (..., B, K-1, C)
        assigns = {}
        if shape[ndim - 3] % div == 0:
            assigns[ndim - 3] = _batch_entry(plan)
        if shape[ndim - 1] % msize == 0:
            assigns[ndim - 1] = plan.model_axis
        return _spec_with(ndim, assigns)
    return ()


def plan_caches(plan: ShardingPlan, caches) -> dict:
    """Walk the cache tree, handling {k,v,pos} / {c_kv,k_pe,pos} groups
    jointly so every member of a group gets a consistent layout."""

    def walk(node, names):
        if _is_leaf(node):
            return ()
        keys = set(node.keys())
        for members, group_specs in ((("k", "v", "pos"), _kv_group_specs),
                                     (("c_kv", "k_pe", "pos"), _mla_group_specs)):
            if set(members) <= keys:
                specs = group_specs(plan, node, names)
                return {kk: (specs[kk] if kk in specs else walk(node[kk], names + [kk]))
                        for kk in sorted(node)}
        out = {}
        for kk in sorted(node):
            vv = node[kk]
            if kk in ("state", "conv") and _is_leaf(vv):
                out[kk] = _ssm_specs(plan, vv, kk)
            else:
                out[kk] = walk(vv, names + [kk])
        return out

    return walk(caches, [])


def plan_batch(plan: ShardingPlan, batch) -> dict:
    def one(names, leaf):
        shape = _shape(leaf)
        div = plan.batch_size_divisor
        if shape and shape[0] % div == 0:
            return (_batch_entry(plan),) + (None,) * (len(shape) - 1)
        plan.notes.append(
            f"batch {'/'.join(names)}: {shape} !% {div} -> replicated")
        return (None,) * len(shape)
    return _map_sorted(one, batch)


def zero1_spec(plan: ShardingPlan, spec: Spec, shape) -> Spec:
    """``spec``, one entry a dimension, with ZeRO-1's batch-axes entry on
    the first dimension it leaves free that the batch axes divide (and is
    at least their size), where there is one; a 0-d leaf's ``spec``
    unchanged."""
    shape = _shape(shape)
    if len(shape) == 0:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    div = plan.batch_size_divisor
    for d in range(len(shape)):
        if entries[d] is None and shape[d] % div == 0 and shape[d] >= div:
            entries[d] = _batch_entry(plan)
            break
    return tuple(entries)


def plan_opt_state(plan: ShardingPlan, params, zero1: bool = True) -> dict:
    """Adam m/v: parameter spec + ZeRO-1 data-sharding of the first free dim."""
    pspecs = plan_params(plan, params)

    def one(names, leaf):
        spec = pspecs
        for k in names:
            spec = spec[k]
        return zero1_spec(plan, spec, leaf) if zero1 else spec

    return _map_sorted(one, params)


@dataclass
class VertexShardPlan:
    """Contiguous vertex-block decomposition of an n-vertex graph.

    ``bounds`` is an int64 array of length ``num_shards + 1`` with
    ``bounds[0] == 0`` and ``bounds[-1] == n``; shard ``s`` owns the
    half-open vertex range ``[bounds[s], bounds[s+1])``.  When the plan was
    built with device placement and the blocks divide evenly, ``devices``
    holds one torch device per shard for placing O(n) vertex arrays;
    otherwise it is ``None`` and the reason is in ``notes`` (plain numpy
    blocks on the host).
    """

    bounds: np.ndarray
    devices: list[torch.device] | None = None
    notes: list[str] = field(default_factory=list)

    @property
    def num_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def n(self) -> int:
        return int(self.bounds[-1])

    def block(self, s: int) -> tuple[int, int]:
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def owner(self, vertices: np.ndarray) -> np.ndarray:
        """Shard id owning each vertex id."""
        return np.searchsorted(self.bounds, vertices, side="right") - 1

    def split(self, rows: np.ndarray) -> list[np.ndarray]:
        """Split a sorted array of vertex ids into per-shard sub-arrays."""
        cuts = np.searchsorted(rows, self.bounds[1:-1])
        return np.split(rows, cuts)

    def device_put(self, arr: np.ndarray):
        """Place an O(n) vertex array according to the plan.

        Returns one tensor per shard, block ``s`` on ``devices[s]``, when
        the plan carries devices, else the input unchanged (the host numpy
        path).
        """
        if self.devices is None:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return [t[lo:hi].to(dev) for (lo, hi), dev in
                zip((self.block(s) for s in range(self.num_shards)),
                    self.devices)]


def plan_vertex_shards(n: int, num_shards: int,
                       use_devices: bool | str = "auto",
                       device: "str | torch.device" = "cuda") -> VertexShardPlan:
    """Plan ``num_shards`` contiguous near-equal vertex blocks for n vertices.

    ``use_devices="auto"`` attaches one device of ``device``'s type per
    shard when there are at least ``num_shards`` of them (CUDA cards; the
    CPU counts as one) *and* n divides evenly (the reference's rule: jax
    needs equal shards along a mesh axis); otherwise the plan stays
    host-only and records why.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    num_shards = min(num_shards, max(1, n))
    bounds = (np.arange(num_shards + 1, dtype=np.int64) * n) // num_shards
    plan = VertexShardPlan(bounds=bounds)
    if use_devices is False:
        return plan
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if count < num_shards:
        plan.notes.append(
            f"{count} device(s) < {num_shards} shards -> host-only blocks")
        return plan
    if n % num_shards != 0:
        plan.notes.append(
            f"n={n} !% {num_shards} shards -> host-only blocks (needs even)")
        return plan
    plan.devices = ([torch.device("cuda", i) for i in range(num_shards)]
                    if dev.type == "cuda" else [dev])
    return plan
