"""Per-chip counts of one mesh position (`launch.mesh.make_counting_mesh`,
`launch.dryrun.count_cell(..., mesh=...)`) against the ranks that run it.

* The counting mesh's tally of a reduced llama3-8b (2 layers, f32; 4
  heads, 2 KV heads) train step (remat under both policies), prefill and
  decode step on (1, 2) and (2, 2) equals, op by op in count and bytes
  and by dtype, the tally of the real gloo ranks (`run_ranks`, 4 CPU
  ranks; `torch_ranks_bodies.step_tallies`) at the same position.
* A position's counted matmul FLOPs are the unsharded step's divided by
  the mesh size, as exact integers, where every matmul is split (heads,
  ffn, vocabulary and rows).  The train step is compared without remat:
  under ``"full"`` a rank's recomputation makes its MLP's row-parallel
  product again, which the unsharded step's early stop aborts before its
  kernel (the row-parallel product saves its operands once it has made
  its output).
* ``"save_collectives"`` keeps each layer's row-parallel sums: its train
  step issues 2L all_reduces of the layer's f32 activations fewer than
  ``"full"``, and makes the L ``wo`` and L ``w_down`` products fewer.
* `op_analysis.collective_bytes` of the port's expert-parallel MoE on a
  (1, 2) counting mesh gives, by operation, the operand bytes the
  reference's ``hlo_analysis.collective_bytes`` reads from the compiled
  HLO of its ``moe_ffn_sharded`` jitted on (1, 2) forced host devices (a
  subprocess): the routed output's sum and the load-balance loss's mean
  over ``model``, f32, 3,076 bytes.  XLA also keeps the mean over the
  one-position ``data`` axis as an all-reduce whose replica groups hold
  one device each (4 bytes that go nowhere); the port issues no
  collective over one position, so the reference's side leaves such
  instructions out.  The counts differ: XLA's all-reduce combiner merges
  the two sums into one tuple all-reduce (1 operation), where the port
  issues each (2)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks_bodies as bodies  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.launch.dryrun import count_cell  # noqa: E402
from repro_torch.launch.mesh import make_counting_mesh, run_ranks  # noqa: E402
from repro_torch.launch.op_analysis import collective_bytes  # noqa: E402
from repro_torch.models.moe import moe_ffn_sharded  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 2
SHAPES = [(1, 2), (2, 2)]
SPECS = {"train": (ShapeSpec("train_4x16", 16, 4, "train"), "full"),
         "train_save": (ShapeSpec("train_4x16", 16, 4, "train"),
                        "save_collectives"),
         "prefill": (ShapeSpec("prefill_4x16", 16, 4, "prefill"), "full"),
         "decode": (ShapeSpec("decode_4x32", 32, 4, "decode"), "full")}


def _cfg(policy="full"):
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               num_layers=LAYERS, remat_policy=policy)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    got = run_ranks(bodies.step_tallies, 4, tmp_path_factory.mktemp("counts"),
                    _cfg(), SPECS, SHAPES, device="cpu")
    out = {}
    for r in got:
        for key, res in r.items():
            out.setdefault(key, []).append(res)
    return out


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_counting_mesh_tally_equals_the_ranks(ranks, shape, name):
    sp, policy = SPECS[name]
    members = ranks[shape, name]
    assert len(members) == shape[0] * shape[1]
    for r in members:
        mesh = make_counting_mesh(shape, position=r["position"])
        counted = count_cell(_cfg(policy), sp, mesh=mesh)
        tally = r["tally"]
        assert counted["collective_counts"] == tally["count"]
        assert counted["collectives"] == collective_bytes(tally)
        assert counted["collectives_by_dtype"] == {
            k: v for k, v in tally["bytes_by_dtype"].items() if k != "_count"}
        assert mesh.tally_since({p: {} for p in mesh.tally}) == tally


@pytest.mark.parametrize("name", ["train", "prefill", "decode"])
@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_position_matmul_flops_are_the_unsharded_over_the_mesh(shape, name):
    sp = SPECS[name][0]
    kw = {"remat": False} if sp.kind == "train" else {}
    one = count_cell(_cfg(), sp, **kw)
    part = count_cell(_cfg(), sp, mesh=make_counting_mesh(shape), **kw)
    n = shape[0] * shape[1]
    assert part["flops_matmul"] > 0
    assert part["flops_matmul"] * n == one["flops_matmul"]
    assert {k: v * n for k, v in part["flops_matmul_by_dtype"].items()} == \
        one["flops_matmul_by_dtype"]


def test_save_collectives_counts_fewer_collectives_and_products():
    cfg = _cfg()
    sp = SPECS["train"][0]
    mesh = make_counting_mesh((1, 2))
    full = count_cell(cfg, sp, mesh=mesh)
    save = count_cell(_cfg("save_collectives"), sp, mesh=mesh)
    d, h, hd, f = cfg.d_model, cfg.num_heads // 2, cfg.head_dim, cfg.d_ff // 2
    rows = sp.global_batch * sp.seq_len
    act = rows * d * 4
    assert full["collective_counts"]["all-reduce"] - \
        save["collective_counts"]["all-reduce"] == 2 * LAYERS
    assert full["collectives"]["all-reduce"] - save["collectives"]["all-reduce"] \
        == 2 * LAYERS * act
    assert full["collectives"]["all-gather"] == save["collectives"]["all-gather"]
    products = LAYERS * 2 * rows * d * (h * hd + f)  # wo and w_down, per rank
    assert full["flops_matmul"] - save["flops_matmul"] == products


def test_counting_mesh_answers_without_a_process_group():
    mesh = make_counting_mesh((2, 4), position=(1, 3))
    assert mesh.counting and mesh.is_member
    assert mesh.coord == {"data": 1, "model": 3}
    assert mesh.device == torch.device("meta")
    t = torch.ones(3, 5)
    assert mesh.all_reduce(t, "model").shape == (3, 5)
    assert mesh.all_gather(t, "model").shape == (4, 3, 5)
    assert mesh.reduce_scatter(torch.ones(8, 5), ("data", "model")).shape == (1, 5)
    assert mesh.copy_to(t) is not None
    assert mesh.tally["count"] == {"_count": 3, "all-reduce": 1,
                                   "all-gather": 1, "reduce-scatter": 1}
    assert mesh.tally["bytes"]["reduce-scatter"] == 8 * 5 * 4
    with pytest.raises(ValueError, match="position"):
        make_counting_mesh((2, 4), position=(2, 0))


ORACLE = """
import os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import json
from types import SimpleNamespace
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch.hlo_analysis import collective_bytes
from repro.models.moe import moe_ffn_sharded

inp = dict(np.load(sys.argv[1]))
cfg = SimpleNamespace(num_experts=8, top_k=2, capacity_factor=1.25)
p = {k: inp[k] for k in ("router", "w_gate", "w_up", "w_down")}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
fn = jax.jit(lambda x, p: moe_ffn_sharded(x, p, cfg, mesh, ("data",)))
hlo = fn.lower(inp["x"], p).compile().as_text()
alone = re.compile(r"replica_groups=\\{(\\{\\d+\\},?)+\\}")
moving = "\\n".join(l for l in hlo.splitlines() if not alone.search(l))
print(json.dumps([collective_bytes(hlo), collective_bytes(moving)]))
"""


def test_collective_bytes_equal_the_references_on_the_sharded_moe(tmp_path):
    pytest.importorskip("jax")
    rng = np.random.default_rng(7)
    d, f, e = 32, 48, 8
    inputs = {"x": rng.standard_normal((4, 6, d)).astype(np.float32),
              "router": rng.standard_normal((d, e)).astype(np.float32),
              "w_gate": rng.standard_normal((e, d, f)).astype(np.float32),
              "w_up": rng.standard_normal((e, d, f)).astype(np.float32),
              "w_down": rng.standard_normal((e, f, d)).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", ORACLE, str(tmp_path / "in.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    import json
    raw, want = json.loads(run.stdout.strip().splitlines()[-1])
    assert raw["all-reduce"] == want["all-reduce"] + 4  # the one-device mean
    cfg = SimpleNamespace(num_experts=8, top_k=2, capacity_factor=1.25)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    for model in range(2):
        mesh = make_counting_mesh((1, 2), position=(0, model))
        block = slice(model * 4, (model + 1) * 4)
        p = bodies.Experts(t["router"], *(t[k][block] for k in
                                          ("w_gate", "w_up", "w_down")))
        moe_ffn_sharded(t["x"], p, cfg, mesh, ("data",))
        got = collective_bytes(mesh.tally)
        assert {k: v for k, v in got.items() if k != "_count"} == \
            {k: v for k, v in want.items() if k != "_count"}
        assert got == {"all-reduce": 3076, "_count": 2}
        assert want["_count"] == 1  # one tuple all-reduce of both sums
