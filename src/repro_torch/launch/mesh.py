"""Meshes over the visible cards, meshes of ranks, and the production pods'
shapes.

Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod:  2x16x16 = 512 devices, axes (pod, data, model) — the pod axis
carries only the slow inter-pod gradient reductions.

A `Mesh` is a small dataclass: axis names and an object array of
``torch.device``s in the mesh's shape.  Nothing here touches a card
(``torch.device("cuda", i)`` is a name), so a device list can be passed
in to test the index arithmetic.

A rank mesh (`make_rank_mesh`) is the same dataclass bound to the
processes of a ``torch.distributed`` job, one rank a position: ``ranks``
holds the rank at each position, and every set of axes has a process
group (the ranks that differ only along those axes).  A function running
on a rank reads its coordinate (`Mesh.coord`) and sums, gathers or
scatters along axes (`Mesh.all_reduce`, `Mesh.all_max`, `Mesh.all_gather`,
`Mesh.reduce_scatter`), as the body of the reference's ``shard_map``
does with ``axis_index``, ``psum`` and ``all_gather``.  The mesh keeps a
tally of the collectives it issued (`Mesh.tally`): the count and the
bytes this rank sent, by operation, under the keys of the reference's
``hlo_analysis.collective_bytes``, and the bytes by operation and dtype.
`run_ranks` starts such a job on this host: ``world`` processes
(``torch.multiprocessing.spawn``) joined through a ``file://`` store in
a directory the caller gives.  `backend_for` fixes the backend: gloo for
CPU tensors and for ranks that share a card, NCCL where each rank has a
card of its own (written, not yet run on several cards).

Gradients through the collectives follow one rule, Megatron's: a loss
is the same on every position along ``model`` and a rank's gradients
are averaged over the batch axes afterwards (`repro_torch.launch.steps`).
So the backward of `Mesh.all_reduce` is the identity along ``model``
and a sum along the batch axes (each rank's loss holds the global
value, whose share the rank's rows are); `Mesh.copy_to` is the identity
forward and sums its gradient over ``model`` backward (it goes where a
replicated activation or weight enters a product that each rank
computes for its own block); `Mesh.all_gather`'s backward keeps this
rank's block of the gradient (along ``model`` only: elsewhere it
raises).  `Mesh.reduce_scatter` has no backward and refuses a tensor
that needs one.  Collectives issued in a backward pass, or in a
layer's recomputation, enter the tally as in a forward.

Under `repro_torch.models.remat.KeptCollectives.run` (the
``"save_collectives"`` remat policy) every collective output is kept in
the forward and given back, without issuing the collective again, when
the backward recomputes the layer.

A counting mesh (`make_abstract_mesh`) holds one fixed position of the
production mesh on ``meta`` devices: its coordinate answers without a
process group, and its collectives return tensors of the right shape and
enter its tally without communicating, so that one position's step runs
on meta as a rank runs it (`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.remat import kept

__all__ = ["Mesh", "make_production_mesh", "make_counting_mesh",
           "make_abstract_mesh", "make_local_mesh", "make_mesh_with_layout",
           "batch_axes_of", "make_rank_mesh", "run_ranks", "backend_for"]

MODEL = "model"  # the axis a loss is replicated over (see the docstring)

def _no_grad_needed(t: torch.Tensor, op: str) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(f"{op} has no backward; call it on tensors "
                                  "that need no gradient")


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return kept(lambda: mesh._all_reduce(t, axes))

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        summed = tuple(a for a in ctx.axes if a != MODEL)
        if summed and mesh.size(summed) > 1:
            grad = mesh._all_reduce(grad, summed)
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_reduce(grad, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return kept(lambda: mesh._all_gather(t, axes))

    @staticmethod
    def backward(ctx, grad):
        if ctx.axes != (MODEL,):
            raise NotImplementedError(
                f"all_gather over {ctx.axes} has no backward: a loss is "
                "replicated over 'model' only")
        return grad[ctx.mesh.coord[MODEL]], None, None


@dataclass
class Mesh:
    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device, one axis per name
    # A rank mesh: the process rank at each position (an int array in the
    # mesh's shape), and this rank's process group over each set of axes
    # (keyed by the axis names in mesh order) that spans more than one rank.
    ranks: np.ndarray | None = None
    groups: dict = field(default_factory=dict, repr=False)
    # The collectives issued on this rank (one over a single position is
    # none): "count" and "bytes" (the operands' bytes), each by operation
    # ("all-reduce", "all-gather", "reduce-scatter") with "_count" the
    # total count, and "bytes_by_dtype" by "operation:dtype".
    tally: dict = field(default_factory=lambda: {
        "count": {"_count": 0}, "bytes": {"_count": 0},
        "bytes_by_dtype": {"_count": 0}}, repr=False, compare=False)
    # A counting mesh's fixed position (`make_abstract_mesh`): its index
    # on each axis; its collectives communicate nothing.
    position: tuple[int, ...] | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def counting(self) -> bool:
        """Whether this is a counting mesh (one fixed position, no ranks)."""
        return self.position is not None

    def _position(self) -> tuple[int, ...]:
        if self.position is not None:
            return self.position
        if self.ranks is None:
            raise ValueError("a device mesh is bound to no rank; make_rank_mesh "
                             "builds a mesh of ranks")
        hit = np.argwhere(self.ranks == dist.get_rank())
        if not len(hit):
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh "
                             f"(ranks {self.ranks.reshape(-1).tolist()})")
        return tuple(int(i) for i in hit[0])

    @property
    def is_member(self) -> bool:
        """Whether this process's rank holds a position of this rank mesh."""
        if self.counting:
            return True
        return self.ranks is not None and bool((self.ranks == dist.get_rank()).any())

    @property
    def coord(self) -> dict[str, int]:
        """This rank's index on each axis (a rank mesh only)."""
        return dict(zip(self.axis_names, self._position()))

    @property
    def device(self) -> torch.device:
        """This rank's device (a rank mesh only)."""
        return self.devices[self._position()]

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The number of positions along ``axes`` (a name or names)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def _record(self, op: str, t: torch.Tensor) -> None:
        size = t.numel() * t.element_size()
        dtype = str(t.dtype).removeprefix("torch.")
        for part, key, add in (("count", op, 1), ("bytes", op, size),
                               ("bytes_by_dtype", f"{op}:{dtype}", size)):
            tally = self.tally[part]
            tally[key] = tally.get(key, 0) + add
            tally["_count"] += 1

    def tally_since(self, mark: dict) -> dict:
        """The tally's growth since ``mark`` (a copy of `Mesh.tally` taken
        earlier, `copy_tally`), in its form; an operation that did not
        grow is left out."""
        return {part: {op: n - mark[part].get(op, 0) for op, n in tally.items()
                       if op == "_count" or n != mark[part].get(op, 0)}
                for part, tally in self.tally.items()}

    def copy_tally(self) -> dict:
        return {part: dict(tally) for part, tally in self.tally.items()}

    def _group(self, axes):
        return self.groups[self._axes(axes)]

    # The collectives themselves (no autograd): each returns a new tensor.
    def _all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        out = t.clone()
        if self.size(axes) > 1:
            self._record("all-reduce", out)
            if not self.counting:
                dist.all_reduce(out, group=self._group(axes))
        return out

    def _all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        n = self.size(axes)
        if n == 1:
            return t[None].clone()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._record("all-gather", t)
        if not self.counting:
            dist.all_gather(parts, t.contiguous(), group=self._group(axes))
        return torch.stack(parts)

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes`` (``psum``), as a
        new tensor with the same bits on every one of them.  Backward:
        the identity along ``model``, a sum along the other axes."""
        return _AllReduce.apply(t, self, self._axes(axes))

    def all_max(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks along ``axes``
        (``pmax``; the tally counts it as an ``all-reduce``), as a new
        tensor.  No backward: a sequence-sharded decode's softmax takes
        its row maximum with it."""
        _no_grad_needed(t, "all_max")
        out = t.clone()
        if self.size(axes) > 1:
            self._record("all-reduce", out)
            if not self.counting:
                dist.all_reduce(out, op=dist.ReduceOp.MAX,
                                group=self._group(axes))
        return out

    def copy_to(self, t: torch.Tensor, axes=MODEL) -> torch.Tensor:
        """``t`` itself, whose gradient is summed over the ranks along
        ``axes`` in the backward: where a tensor the ranks hold alike
        enters a computation each rank does for its own block."""
        if self.size(axes) == 1:
            return t
        return _CopyTo.apply(t, self, self._axes(axes))

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``(n, *t.shape)``: ``t`` of each of the ``n`` ranks along
        ``axes``, in the order of their positions (row-major over the axes
        in mesh order, rank-major).  Backward (along ``model``): this
        rank's block of the gradient."""
        return _AllGather.apply(t, self, self._axes(axes))

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``t`` over the
        ranks along ``axes``: ``dim`` cut into as many equal blocks as
        they have positions, block i to the i-th position (the order of
        `all_gather`).  The tally counts the operand, ``t``, as the
        reference's ``collective_bytes`` does.  No backward."""
        _no_grad_needed(t, "reduce_scatter")
        n = self.size(axes)
        if n == 1:
            return t.clone()
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n} positions)")
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        self._record("reduce-scatter", src)
        if not self.counting:
            dist.reduce_scatter_tensor(out, src, group=self._group(axes))
        return out.movedim(0, dim)


def _pod(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _visible(device) -> list[torch.device]:
    """Every card of ``device``'s type (the CPU counts as one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _grid(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: "str | torch.device" = "cuda") -> Mesh:
    """The (data, model) pod mesh, or (pod, data, model) over two pods, on
    the first 256 (512) cards; raises where fewer are visible."""
    shape, axes = _pod(multi_pod)
    n = int(np.prod(shape))
    devices = _visible(device)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for {axes} {shape}, have "
                           f"{len(devices)}")
    return Mesh(axes, _grid(devices[:n], shape))


def make_counting_mesh(shape: tuple[int, ...],
                       axis_names: tuple[str, ...] = ("data", "model"),
                       position: tuple[int, ...] | None = None) -> Mesh:
    """A counting mesh of ``shape`` over placeholder ``meta`` devices, at
    ``position`` (an index per axis; default the first): its coordinate
    answers without a process group, and its collectives record in its
    tally without communicating (see the module docstring)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    position = tuple(position) if position is not None else (0,) * len(shape)
    if len(position) != len(shape) or len(axis_names) != len(shape) or not all(
            0 <= i < k for i, k in zip(position, shape)):
        raise ValueError(f"position {position} is not on a {tuple(axis_names)} "
                         f"mesh of shape {shape}")
    return Mesh(tuple(axis_names), _grid([torch.device("meta")] * n, shape),
                ranks=np.arange(n, dtype=np.int64).reshape(shape),
                position=position)


def make_abstract_mesh(*, multi_pod: bool = False,
                       position: tuple[int, ...] | None = None) -> Mesh:
    """The production mesh's axes and shape as a counting mesh at
    ``position`` (default the first): what the planner reads, and what
    one position's step runs on to be counted without its cards
    (`repro_torch.launch.dryrun`)."""
    shape, axes = _pod(multi_pod)
    return make_counting_mesh(shape, axes, position)


def make_local_mesh(model_parallel: int = 1,
                    device: "str | torch.device" = "cuda") -> Mesh:
    """A (data, model) mesh over the visible cards (tests and examples)."""
    devices = _visible(device)
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel="
                         f"{model_parallel}")
    return Mesh(("data", "model"), _grid(devices, (n // model_parallel,
                                                   model_parallel)))


def make_mesh_with_layout(device_order, *, multi_pod: bool = False,
                          devices=None,
                          device: "str | torch.device" = "cuda") -> Mesh:
    """Production mesh with a SNEAP-optimized logical->physical layout
    (`repro_torch.sharding.sneap_device_layout`): ``device_order[i]`` is
    the physical device that logical position i should occupy.
    ``devices`` (default: the visible cards of ``device``'s type) is the
    physical device list the order indexes."""
    shape, axes = _pod(multi_pod)
    devs = list(devices) if devices is not None else _visible(device)
    order = np.asarray(device_order)
    if order.size != int(np.prod(shape)) or order.max() >= len(devs):
        raise RuntimeError(f"need {int(np.prod(shape))} devices for {axes} "
                           f"{shape} (order max {int(order.max())}), have "
                           f"{len(devs)}")
    return Mesh(axes, _grid([devs[i] for i in order.reshape(-1)], shape))


def batch_axes_of(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


# ------------------------------------------------------------ rank meshes


def backend_for(device: "str | torch.device", world: int) -> str:
    """The ``torch.distributed`` backend of ``world`` ranks on ``device``'s
    type: gloo for CPU tensors and for ranks that share a card (NCCL
    refuses two ranks on one device), NCCL where each rank has its own."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(device: "str | torch.device", rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank % count``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_rank_mesh(shape: tuple[int, ...],
                   axis_names: tuple[str, ...] = ("data", "model"),
                   device: "str | torch.device" = "cuda",
                   ranks=None) -> Mesh:
    """A mesh of ``shape`` over the ranks ``ranks`` (default: all of the
    job's, in order), bound to this process's rank.  Positions take the
    ranks in ascending order, row-major.  Collective: every rank of the
    job calls it, members or not, in the same order, since each process
    group is made by all of them (``torch.distributed.new_group``)."""
    members = sorted(range(dist.get_world_size()) if ranks is None else ranks)
    if len(members) != int(np.prod(shape)) or len(shape) != len(axis_names):
        raise ValueError(f"{len(members)} ranks do not fill a {axis_names} "
                         f"mesh of shape {tuple(shape)}")
    grid = np.asarray(members, dtype=np.int64).reshape(shape)
    me = dist.get_rank()
    groups = {}
    n = len(axis_names)
    for size in range(1, n + 1):
        for axes in itertools.combinations(range(n), size):
            # Each row: the ranks that differ only along ``axes``.
            rows = np.moveaxis(grid, axes, range(n - size, n)).reshape(
                -1, int(np.prod([shape[i] for i in axes])))
            if rows.shape[1] == 1:
                continue
            for row in rows:
                group = dist.new_group(row.tolist())
                if me in row:
                    groups[tuple(axis_names[i] for i in axes)] = group
    devices = [_rank_device(device, r) for r in members]
    return Mesh(tuple(axis_names), _grid(devices, tuple(shape)), ranks=grid,
                groups=groups)


def _rank_main(rank: int, world: int, store_dir: str, device_type: str,
               timeout_s: float) -> None:
    fn, args = torch.load(Path(store_dir) / "call.pt", weights_only=False)
    dev = _rank_device(device_type, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # The ranks of one job share this host: gloo binds to its loopback.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend_for(device_type, world),
                            init_method=f"file://{store_dir}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        torch.save(out, Path(store_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, store_dir, *args,
              device: "str | torch.device" = "cuda",
              timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of a new ``torch.distributed``
    job on this host and return each rank's return value, by rank.

    Each rank is a process of its own (``torch.multiprocessing.spawn``:
    ``fn`` is pickled by its import path, so it lives in an importable
    module), sets its card where ``device`` is CUDA (`_rank_device`), and
    joins the job through a ``file://`` store in ``store_dir``.  The call
    and the return values travel through files there (``torch.save``:
    keep the return values on the host), since a start's pipe that
    fills up would make each rank wait for the one before it to finish
    its imports.  A collective that waits longer than ``timeout_s``
    fails.  A rank that raises ends the job: the other ranks are stopped
    and the error is raised here."""
    dev = resolve_device(device)
    store = Path(store_dir).resolve()
    store.mkdir(parents=True, exist_ok=True)
    for stale in [store / "store"] + [store / f"rank{r}.pt" for r in range(world)]:
        stale.unlink(missing_ok=True)
    torch.save((fn, args), store / "call.pt")
    torch.multiprocessing.spawn(
        _rank_main, args=(world, str(store), dev.type, timeout_s),
        nprocs=world, join=True)
    return [torch.load(store / f"rank{r}.pt", map_location="cpu",
                       weights_only=False) for r in range(world)]
