"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
planner and model: full-size cells that count fast on the meta device
(llama3-8b ``decode_32k`` on both meshes, mamba2-780m ``long_500k``,
qwen3-moe-30b-a3b ``decode_32k``) end ``ok`` with the reference's
parameter count (``jax.eval_shape`` of its ``init``), the reference
planner's notes (its step bundles on an axis-size stub of the mesh, then
the batch and cache specs in its ``jit_for`` order) and per-device
argument bytes equal to a sum over the reference planner's specs; a
quadratic-attention arch's ``long_500k`` gives the reference's skip; and
`report`'s three tables build from small ledgers."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.sharding import planner as ref_planner  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [("llama3-8b", "decode_32k", False), ("llama3-8b", "decode_32k", True),
         ("mamba2-780m", "long_500k", False),
         ("qwen3-moe-30b-a3b", "decode_32k", False)]


class FakeMesh:
    """Axis-size stub: the reference's step bundles plan without devices."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _sharded_bytes(mesh: dict, specs, tree) -> int:
    """Sum over leaves of bytes / the product of the mesh axes its spec
    names."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        nbytes = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
        assert nbytes % math.prod(mesh[a] for a in axes) == 0
        total += nbytes // math.prod(mesh[a] for a in axes)
    return total


def _reference_decode(arch: str, shape: str, mesh_name: str):
    """(num_params, notes, per-device argument bytes) of the reference's
    serve step for a decode cell, planned as its ``jit_for`` plans it."""
    cfg = ref_config(arch)
    sp = ref_shapes.SHAPES[shape]
    mesh = MESHES[mesh_name]
    bundle = ref_steps.make_serve_step(cfg, FakeMesh(mesh), cache_len=sp.seq_len)
    params = jax.eval_shape(lambda: bundle.model.init(jax.random.PRNGKey(0)))
    caches = ref_shapes.cache_specs(cfg, shape)
    cspecs = ref_planner.plan_caches(bundle.plan, caches)
    tokens = jax.ShapeDtypeStruct((sp.global_batch, 1), jnp.int32)
    tspec = ref_planner.plan_batch(bundle.plan, {"tokens": tokens})["tokens"]
    total = (_sharded_bytes(mesh, bundle.param_specs, params)
             + _sharded_bytes(mesh, cspecs, caches)
             + 2 * _sharded_bytes(mesh, tspec, tokens))
    n_params = sum(math.prod(x.shape) for x in jax.tree.leaves(params))
    return n_params, bundle.plan.notes[:20], total


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_matches_the_reference_plan_and_params(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    assert (rec["status"], rec["mesh"], rec["partitioned"]) == ("ok", mesh_name, False)
    n_params, notes, per_device = _reference_decode(arch, shape, mesh_name)
    assert rec["num_params"] == n_params
    assert rec["plan_notes"] == notes
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == per_device
    assert mem["argument_size_in_bytes_one_card"] >= per_device
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes_one_card"]
    assert rec["collectives"] == {"_count": 0}
    cost = rec["cost"]
    assert cost["flops"] == cost["flops_matmul"] + cost["flops_pointwise"] > 0
    assert cost["flops_matmul"] == sum(cost["flops_matmul_by_dtype"].values())
    assert rec["ops"]["dot"] > 0 and json.loads(json.dumps(rec)) == rec


def test_long_context_cell_gives_the_reference_skip():
    rec = dryrun.run_cell("llama3-8b", "long_500k", False, verbose=False)
    ok, reason = ref_shapes.applicable(ref_config("llama3-8b"), "long_500k")
    assert not ok and (rec["status"], rec["reason"]) == ("skip", reason)


def test_report_tables_build_from_small_ledgers(tmp_path):
    ok = {"arch": "llama3-8b", "shape": "decode_32k", "mesh": "16x16",
          "status": "ok", "count_s": 2.5, "plan_notes": ["a note"],
          "memory": {"argument_size_in_bytes": 4e9,
                     "argument_size_in_bytes_one_card": 5.6e11,
                     "peak_live_bytes": 5.8e11}}
    skip = {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16",
            "status": "skip", "reason": "full quadratic attention"}
    counters = {"flops": 4e12, "flops_matmul:bfloat16": 2e12,
                "flops_matmul:float32": 2e12, "flops_pointwise": 1e9, "bytes": 4e12}
    roof = {"arch": "hymba-1.5b", "shape": "long_500k", "status": "ok",
            "counters": counters, "useful_ratio": 0.5,
            "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0}}
    perf = {**roof, "tag": "hymba.C1_seq_parallel_decode",
            "plan_only": ["seq_parallel_decode"]}
    paths = {}
    for name, recs in (("dry", [ok, skip]), ("roof", [roof]), ("perf", [perf])):
        paths[name] = tmp_path / f"{name}.jsonl"
        paths[name].write_text("".join(json.dumps(r) + "\n" for r in recs))
    dry = report.dryrun_table(paths["dry"])
    assert "| llama3-8b | decode_32k | 16x16 | OK | 2.5 | 4.00 | 560.00 | 580.00 | no |" in dry
    assert "| llama3-8b | long_500k | 16x16 | SKIP |" in dry
    roof_rows = report.roofline_table(paths["roof"]).splitlines()
    assert len(roof_rows) == 3 and roof_rows[2].startswith("| hymba-1.5b | long_500k |")
    perf_rows = report.perf_table(paths["perf"], paths["roof"]).splitlines()
    assert perf_rows[2].startswith("| **hymba-1.5b × long_500k baseline** |")
    assert "seq_parallel_decode: the plan only, not counted" in perf_rows[3]
