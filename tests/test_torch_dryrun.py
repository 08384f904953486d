"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
planner and model: full-size cells that count fast on the meta device
(llama3-8b ``decode_32k`` on both meshes, mamba2-780m ``long_500k``,
qwen3-moe-30b-a3b ``decode_32k``) end ``ok`` with per-chip counts of the
mesh's first position (its collectives from a counting mesh) beside the
unsharded one-card counts, the reference's parameter count (``jax.eval_shape`` of its ``init``), the reference
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


# A decode step's collectives at the first position, per cell: llama3-8b
# sums the embedding and each layer's two row-parallel products and
# gathers the head's vocabulary blocks (2L + 2); qwen3-moe-30b-a3b sums
# the attention's product, the experts' output and the load-balance
# loss over model and over the batch axes (4L + 2).  Their KV heads (8,
# 4) do not divide the model axis, so their caches split by sequence:
# each layer also gathers the queries of every head and takes the
# partial softmax's max and sum (3L).  mamba2-780m gathers each layer's
# in_proj block and conv channels and sums its gated norm's squares and
# out_proj's product (4L; its 50,280 vocabulary rows stay whole).
COLLECTIVES = {"llama3-8b": 5 * 32 + 2, "qwen3-moe-30b-a3b": 7 * 48 + 2,
               "mamba2-780m": 4 * 48}


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_run_cell_matches_the_reference_plan_and_params(arch, shape, multi_pod):
    """The record is the first position's, per chip (``"partitioned":
    true``): its collectives from the counting mesh, its cost below the
    one-card cost (``cost_one_card``) where the model splits; the plan's
    notes, parameter count and per-device argument bytes are the
    reference's."""
    rec = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    assert (rec["status"], rec["mesh"], rec["partitioned"]) == ("ok", mesh_name, True)
    assert rec["position"] == dict.fromkeys(MESHES[mesh_name], 0)
    n_params, notes, per_device = _reference_decode(arch, shape, mesh_name)
    assert rec["num_params"] == n_params
    assert rec["plan_notes"] == notes
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == per_device
    assert mem["argument_size_in_bytes_one_card"] >= per_device
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes_one_card"]
    assert mem["peak_live_bytes_position"] >= mem["argument_size_in_bytes_position"]
    assert rec["collectives"]["_count"] == COLLECTIVES[arch]
    for cost in (rec["cost"], rec["cost_one_card"]):
        assert cost["flops"] == cost["flops_matmul"] + cost["flops_pointwise"] > 0
        assert cost["flops_matmul"] == sum(cost["flops_matmul_by_dtype"].values())
    assert rec["notes"] == []  # the position holds the planner's blocks
    assert mem["argument_size_in_bytes_position"] < \
        mem["argument_size_in_bytes_one_card"]
    assert rec["cost"]["flops_matmul"] < rec["cost_one_card"]["flops_matmul"]
    assert set(rec["collectives"]) == {"all-reduce", "all-gather", "_count"}
    assert rec["ops"]["dot"] > 0 and json.loads(json.dumps(rec)) == rec


# One record of each family the tensor-parallel slice splits.
FAMILY_CELLS = [("deepseek-v2-lite-16b", "decode_32k"), ("mamba2-780m", "long_500k"),
                ("hymba-1.5b", "long_500k"), ("llama-3.2-vision-11b", "decode_32k"),
                ("whisper-medium", "decode_32k")]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (16, 16)], ids=str)
@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_family_positions_hold_the_planners_blocks(arch, shape, mesh_shape):
    """At the first position of a (1, 2) and a (16, 16) counting mesh,
    `dryrun.position_notes` is empty (every parameter and cache leaf is
    the planner's block), and the position's parameter bytes are the sum
    of the reference planner's blocks."""
    from repro.models.model import Model as RefModel
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import make_counting_mesh
    from repro_torch.models import Model
    from repro_torch.sharding import ParamShard

    mesh = make_counting_mesh(mesh_shape)
    cfg = get_config(arch)
    assert dryrun.position_notes(cfg, SHAPES[shape], mesh) == []
    axes = dict(zip(("data", "model"), mesh_shape))
    ref = ref_config(arch)
    params = jax.eval_shape(lambda: RefModel(ref).init(jax.random.PRNGKey(0)))
    specs = ref_planner.plan_params(ref_planner.ShardingPlan(mesh=FakeMesh(axes)),
                                    params)
    rank = Model(cfg, "meta", ParamShard.of(mesh))
    held = sum(p.numel() * p.element_size() for p in rank.parameters())
    assert held == _sharded_bytes(axes, specs, params)


def test_llama_decode_position_collective_bytes():
    """llama3-8b ``decode_32k`` at the first position of 16x16: its 8 rows
    (128 over 16 data positions) of one token; the embedding's bf16 sum,
    64 f32 row-parallel sums of (8, 1, 4096), and the bf16 head's block
    of 128,256 / 16 logits gathered.  Its cache holds 2,048 of the 32,768
    slots (8 KV heads do not divide 16), so each layer gathers its 2
    heads' bf16 queries (8, 1, 2, 128) and sums over ``model`` the f32
    partial softmax's max (8, 1, 8, 4) and its weights' sums beside the
    weighted values (8, 1, 8, 4, 129)."""
    rec = dryrun.run_cell("llama3-8b", "decode_32k", False, verbose=False)
    rows, d, layers = 8, 4096, 32
    seq_sums = rows * 8 * 4 * 4 + rows * 8 * 4 * 129 * 4
    queries = rows * 2 * 128 * 2
    assert rec["collectives"] == {
        "all-reduce": rows * d * 2 + 64 * rows * d * 4 + layers * seq_sums,
        "all-gather": rows * (128_256 // 16) * 2 + layers * queries,
        "_count": 66 + 3 * layers}
    assert rec["collectives_by_dtype"] == {
        "all-reduce:bfloat16": rows * d * 2,
        "all-reduce:float32": 64 * rows * d * 4 + layers * seq_sums,
        "all-gather:bfloat16": rows * (128_256 // 16) * 2 + layers * queries}


def test_long_context_cell_gives_the_reference_skip():
    rec = dryrun.run_cell("llama3-8b", "long_500k", False, verbose=False)
    ok, reason = ref_shapes.applicable(ref_config("llama3-8b"), "long_500k")
    assert not ok and (rec["status"], rec["reason"]) == ("skip", reason)


def test_report_tables_build_from_small_ledgers(tmp_path):
    ok = {"arch": "llama3-8b", "shape": "decode_32k", "mesh": "16x16",
          "status": "ok", "count_s": 2.5, "plan_notes": ["a note"],
          "memory": {"argument_size_in_bytes": 4e9,
                     "argument_size_in_bytes_one_card": 5.6e11,
                     "peak_live_bytes": 5.8e11},
          "chips": 256, "cost": {"flops": 1e12}, "cost_one_card": {"flops": 1.28e14}}
    skip = {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16",
            "status": "skip", "reason": "full quadratic attention"}
    counters = {"flops": 4e12, "flops_matmul:bfloat16": 2e12,
                "flops_matmul:float32": 2e12, "flops_pointwise": 1e9, "bytes": 4e12}
    roof = {"arch": "hymba-1.5b", "shape": "long_500k", "status": "ok",
            "counters": counters, "useful_ratio": 0.5, "chips": 1,
            "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0}}
    perf = {**roof, "tag": "hymba.C2_shard_head_dim",
            "step_kwargs": {"seq_parallel_decode": True,
                            "shard_head_dim_fallback": True},
            "roofline": {"compute_s": 0.5, "memory_s": 1.5, "collective_s": 0.25}}
    paths = {}
    for name, recs in (("dry", [ok, skip]), ("roof", [roof]), ("perf", [perf])):
        paths[name] = tmp_path / f"{name}.jsonl"
        paths[name].write_text("".join(json.dumps(r) + "\n" for r in recs))
    dry = report.dryrun_table(paths["dry"])
    assert "| llama3-8b | decode_32k | 16x16 | OK | 2.5 | 4.00 | 560.00 | 580.00 | no |" in dry
    # The position's FLOPs times the mesh's 256 chips over one card's.
    assert "| no | 2.000 | a note |" in dry
    assert "| llama3-8b | long_500k | 16x16 | SKIP |" in dry
    roof_rows = report.roofline_table(paths["roof"]).splitlines()
    assert len(roof_rows) == 3 and roof_rows[2].startswith("| hymba-1.5b | long_500k |")
    # A per-chip record: 6ND over the count of all its chips.
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import model_flops

    mf = model_flops(get_config("hymba-1.5b"), "long_500k")
    for chips, want in ((1, "1.000"), (4, "0.250")):
        rec = {**roof, "chips": chips, "counters": {**counters, "flops": mf}}
        (tmp_path / "chips.jsonl").write_text(json.dumps(rec) + "\n")
        rows = report.roofline_table(tmp_path / "chips.jsonl").splitlines()
        assert rows[2].split("|")[7].strip() == want
    perf_rows = report.perf_table(paths["perf"], paths["roof"]).splitlines()
    assert perf_rows[2].startswith("| **hymba-1.5b × long_500k baseline** |")
    # A head-dim variant's row prints its own counts, not its baseline's.
    assert perf_rows[3] == ("| hymba.C2_shard_head_dim | 0.5 | 1.5 | 0.25 | "
                            "0.500 | see PERF.md §6 |")
