"""Op-level counts of an eager step, where the reference's
``launch/hlo_analysis.py`` reads the compiled, partitioned HLO.

An eager torch step has no compiled module to analyse: `OpCounter`, a
``TorchDispatchMode``, sees every aten op the step dispatches (the
backward's and the recomputed forward's included) and records

* the op's name and calls (``ops``);
* matmul-class FLOPs (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolution and their backward ops), from ``torch.utils.flop_counter``'s
  formulas, summed by the operands' dtype (``flops_matmul_by_dtype``);
* one FLOP per output element of every op tagged ``torch.Tag.pointwise``,
  kept apart as ``flops_pointwise``;
* bytes read and written: each tensor input and output once per op, as the
  distinct elements it addresses (a broadcast operand counts once); views
  and other metadata-only ops (every output aliases an input, none is
  written) and ``empty`` allocations count 0;
* copies from the host to the device (``host_copies``, ``host_bytes``),
  kept out of the op counts and device bytes: a step on the CPU makes
  none of them, and they cross the host link, not device memory;
* the bytes of the storages the step allocates while they live
  (``live_bytes`` at the end, ``peak_live_bytes``).  Tensors that exist
  before the step (parameters, optimizer state, inputs) are not counted:
  the caller adds them.

On the ``meta`` device the step runs without allocating, so a full-size
cell counts on a host in seconds.  A step on one card issues no
collective (``NO_COLLECTIVES``); a step of one position of a mesh runs on
a counting mesh (`repro_torch.launch.mesh.make_abstract_mesh`), whose
tally records each collective it would issue, forward, backward and
recomputation alike, and `collective_bytes` gives that tally in the form
of the reference's ``hlo_analysis.collective_bytes``: the operands'
bytes by operation and the count of operations.  An op counted here is
the rank's own work; the collectives' bytes are kept apart from
``bytes accessed``.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCounter", "count_ops", "op_census", "collective_bytes",
           "NO_COLLECTIVES"]

NO_COLLECTIVES = {"_count": 0}
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd

# aten names -> the reference's census opcodes; the rest keep their names.
_CENSUS = {
    "mm": "dot", "addmm": "dot", "bmm": "dot", "baddbmm": "dot",
    "copy_": "copy", "_to_copy": "copy", "clone": "copy",
    "transpose": "transpose", "t": "transpose", "permute": "transpose",
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "index_put_": "dynamic-update-slice", "index_put": "dynamic-update-slice",
    "slice_scatter": "dynamic-update-slice",
}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.layout == torch.strided]


def _composite(func, ins: list[torch.Tensor]) -> bool:
    """Whether the device runs ``func`` as its C++ decomposition: it has
    one and no kernel of its own for the inputs' device.  Under inference
    mode such ops (einsum, matmul, softmax, ``to``) reach the mode whole,
    where autograd would have decomposed them first."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    return bool(ins) and has(func.name(), _COMPOSITE) and not has(
        func.name(), torch._C._dispatch_key_for_device(ins[0].device.type))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a stride-0 dim,
    a broadcast, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts of the ops dispatched inside ``with OpCounter() as c:``;
    `record` gives them as a dict."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: Counter = Counter()
        self.flops_matmul_by_dtype: Counter = Counter()
        self.flops_pointwise = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.host_copies = 0
        self.host_bytes = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, int] = {}
        self._depth = 0  # the mode re-enters itself to run a decomposition
        self._closed = False

    def _free(self, key: int) -> None:
        if not self._closed:
            self.live_bytes -= self._live.pop(key)

    def __enter__(self):
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        self._closed = self._depth == 0
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if _composite(func, ins):
            with self:
                return func._op_dk(_COMPOSITE, *args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        outs = _tensors(out)
        if name in ("_to_copy", "copy_") and outs[0].device.type != "cpu" \
                and any(t.device.type == "cpu" for t in ins):
            self.host_copies += 1
            self.host_bytes += sum(_distinct_bytes(t) for t in ins
                                   if t.device.type == "cpu")
            return out
        self.ops[name] += 1
        in_keys = {_key(t) for t in ins}
        out_keys = [_key(t) for t in outs]
        if packet in flop_registry:
            dtype = str(ins[0].dtype).removeprefix("torch.")
            self.flops_matmul_by_dtype[dtype] += int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if torch.Tag.pointwise in func.tags and outs:
            self.flops_pointwise += outs[0].numel()
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        metadata_only = not writes and all(k in in_keys for k in out_keys)
        if not metadata_only and not name.startswith(("empty", "new_empty")):
            self.bytes_read += sum(_distinct_bytes(t) for t in ins)
            self.bytes_written += sum(_distinct_bytes(t) for t in outs)
        for t, k in zip(outs, out_keys):
            if k in in_keys or k in self._live:
                continue
            storage = t.untyped_storage()
            self._live[k] = storage.nbytes()
            self.live_bytes += self._live[k]
            weakref.finalize(storage, self._free, k)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out

    def record(self) -> dict:
        """The counts: the reference's cost keys (``flops``: matmul and
        pointwise; ``bytes accessed``) and the split ones."""
        matmul = sum(self.flops_matmul_by_dtype.values())
        return {"flops": matmul + self.flops_pointwise,
                "bytes accessed": self.bytes_read + self.bytes_written,
                "flops_matmul": matmul,
                "flops_matmul_by_dtype": dict(self.flops_matmul_by_dtype),
                "flops_pointwise": self.flops_pointwise,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "host_copies": self.host_copies,
                "host_bytes": self.host_bytes,
                "live_bytes": self.live_bytes,
                "peak_live_bytes": self.peak_live_bytes,
                "ops": dict(self.ops)}


def count_ops(fn, *args, **kwargs) -> tuple[object, dict]:
    """``(fn(*args, **kwargs), its OpCounter record)``."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.record()


def op_census(record: dict) -> dict[str, int]:
    """Calls a census opcode: the reference's names (``dot``, ``copy``,
    ``transpose``, ``reshape``, ``dynamic-update-slice``) where an aten op
    maps to one, the aten name otherwise."""
    census: Counter = Counter()
    for name, calls in record["ops"].items():
        census[_CENSUS.get(name, name)] += calls
    return dict(census)


def collective_bytes(tally: dict) -> dict[str, int]:
    """A mesh's tally (`Mesh.tally`, or its growth over a step,
    `Mesh.tally_since`) as the reference's ``collective_bytes`` returns
    its module's collectives: ``{"all-reduce": bytes, "all-gather":
    bytes, "reduce-scatter": bytes, "_count": n}``, each operation's
    operand bytes summed (one that was not issued is left out) and
    ``_count`` the operations in all.  XLA's combiners merge some
    collectives of the reference's module into one; the port issues
    each, so counts can differ where bytes agree."""
    out = {op: int(n) for op, n in tally["bytes"].items()
           if op != "_count" and tally["count"].get(op, 0)}
    out["_count"] = int(tally["count"]["_count"])
    return out
