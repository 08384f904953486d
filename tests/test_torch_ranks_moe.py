"""The port's expert-parallel MoE on gloo ranks against the reference's.

`moe_ffn_sharded` on (data, model) rank meshes of shapes (1, 2), (1, 4)
and (2, 2) (`run_ranks`, 4 CPU ranks, one job) against the reference's
``moe_ffn_sharded`` on jax meshes of the same shapes over 4 forced host
devices (a subprocess, as tests/test_island_sa.py runs it), on the same
numpy inputs in f32 (E = 8, top-2, capacity factor 1.25, so some tokens
drop): out within 1e-6 of max|out|, aux within rtol 1e-6 (the bound
tests/test_torch_models.py holds the single-shard router's aux to: the
port's router logits differ from XLA's in the last bits, and these
inputs' aux lands one f32 ulp, 1.19e-7, from the reference's).  On the
model-only meshes it is also held to the port's unsharded `moe_ffn`
(out within 1e-6 of max|out|, aux within 1e-7): the same experts and the
same global capacity, so it drops the same tokens, and only the order of
the shard sum differs.  Its backward is held to ``jax.grad`` of the
reference's on each shape (jax 0.9 differentiates through the
``shard_map``)."""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks_bodies as bodies  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = SimpleNamespace(num_experts=8, top_k=2, capacity_factor=1.25)
SHAPES = [(1, 2), (1, 4), (2, 2)]
OUT_TOL = 1e-6  # of max|out|
AUX_RTOL = 1e-6  # against the reference
AUX_TOL = 1e-7  # against the port's unsharded MoE
GRAD_TOL = 1e-5  # of the leaf's max|grad|, against the reference's jax.grad

ORACLE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from types import SimpleNamespace
import numpy as np
import jax
from jax.sharding import Mesh
from repro.models.moe import moe_ffn_sharded

inp = dict(np.load(sys.argv[1]))
cfg = SimpleNamespace(num_experts=8, top_k=2, capacity_factor=1.25)
p = {k: inp[k] for k in ("router", "w_gate", "w_up", "w_down")}
out = {}
for data, model in ((1, 2), (1, 4), (2, 2)):
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    mesh = Mesh(devs, ("data", "model"))
    fn = lambda x, p: moe_ffn_sharded(x, p, cfg, mesh, ("data",))
    y, aux = jax.jit(fn)(inp["x"], p)
    out[f"out_{data}x{model}"] = np.asarray(y)
    out[f"aux_{data}x{model}"] = np.asarray(aux)

    def scalar(x, p, data=data, fn=fn):
        y, aux = fn(x, p)
        return (y * inp["weight"]).sum() / data + 0.01 * aux

    gx, gp = jax.jit(jax.grad(scalar, argnums=(0, 1)))(inp["x"], p)
    out[f"grad_x_{data}x{model}"] = np.asarray(gx)
    for k, v in gp.items():
        out[f"grad_{k}_{data}x{model}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(7)
    d, f, e = 32, 48, CFG.num_experts
    return {"x": rng.standard_normal((4, 6, d)).astype(np.float32),
            "router": rng.standard_normal((d, e)).astype(np.float32),
            "w_gate": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
            "w_up": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
            "w_down": (0.2 * rng.standard_normal((e, f, d))).astype(np.float32),
            # the gradients' scalar: sum(out * weight) + 0.01 aux
            "weight": rng.standard_normal((4, 6, d)).astype(np.float32)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_oracle")
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", ORACLE, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each shape's rows: the whole out (assembled from the ranks' rows,
    each block the same on every model rank) and each rank's aux."""
    moe_in = {k: v for k, v in inputs.items() if k != "weight"}
    got = run_ranks(bodies.moe, 4, tmp_path_factory.mktemp("moe_ranks"), CFG,
                    moe_in, SHAPES, device="cpu")
    out = {}
    for shape in SHAPES:
        full = np.zeros_like(inputs["x"])
        seen = {}
        for r in got:
            if shape not in r:
                continue
            lo, hi = r[shape]["rows"]
            if (lo, hi) in seen:  # every model rank of the rows: the same bits
                np.testing.assert_array_equal(r[shape]["out"], seen[(lo, hi)])
            seen[(lo, hi)] = r[shape]["out"]
            full[lo:hi] = r[shape]["out"]
        assert sorted(seen) == [(i * 4 // shape[0], (i + 1) * 4 // shape[0])
                                for i in range(shape[0])]
        out[shape] = dict(out=full, aux=[r[shape]["aux"] for r in got
                                         if shape in r])
    return out


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_moe_ffn_sharded_matches_the_reference(ranks, reference, shape):
    want_out = reference[f"out_{_key(shape)}"]
    want_aux = float(reference[f"aux_{_key(shape)}"])
    got = ranks[shape]
    scale = float(np.abs(want_out).max())
    assert float(np.abs(got["out"] - want_out).max()) <= OUT_TOL * scale
    assert len(got["aux"]) == shape[0] * shape[1]
    for aux in got["aux"]:
        assert abs(aux - want_aux) <= AUX_RTOL * abs(want_aux), (aux, want_aux)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=_key)
def test_moe_ffn_sharded_matches_the_unsharded_moe(ranks, inputs, shape):
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want, aux = moe_ffn(t["x"], bodies.Experts(t["router"], t["w_gate"],
                                               t["w_up"], t["w_down"]),
                        CFG.top_k, CFG.capacity_factor)
    want = want.numpy()
    got = ranks[shape]
    scale = float(np.abs(want).max())
    assert float(np.abs(got["out"] - want).max()) <= OUT_TOL * scale
    for a in got["aux"]:
        assert abs(a - float(aux)) <= AUX_TOL


def test_some_tokens_drop_at_this_capacity(inputs):
    """The inputs exercise the capacity limit that sharded and unsharded
    runs must apply alike: at capacity factor 1.25 some (token, expert)
    pairs overflow their expert."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    p = bodies.Experts(t["router"], t["w_gate"], t["w_up"], t["w_down"])
    capped, _ = moe_ffn(t["x"], p, CFG.top_k, CFG.capacity_factor)
    roomy, _ = moe_ffn(t["x"], p, CFG.top_k, 8.0)
    assert not torch.allclose(capped, roomy)


@pytest.fixture(scope="module")
def grads(inputs, tmp_path_factory):
    """Each rank's gradients (`torch_ranks_bodies.moe_grads`), by shape."""
    moe_in = {k: v for k, v in inputs.items() if k != "weight"}
    got = run_ranks(bodies.moe_grads, 4, tmp_path_factory.mktemp("moe_grads"),
                    CFG, moe_in, inputs["weight"], SHAPES, device="cpu")
    return {shape: [r[shape] for r in got if shape in r] for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_moe_ffn_sharded_gradients_match_the_references_grad(grads, reference,
                                                             shape):
    """The backward of the port's expert-parallel MoE against ``jax.grad``
    of the reference's ``moe_ffn_sharded`` (its ``shard_map`` under
    ``jit``) on the same mesh shape: the scalar ``sum(out * weight) /
    data + 0.01 aux``, the mean over the data ranks of each rank's loss.
    ``x``'s rows, the router (every rank the same) and each rank's
    experts within 1e-5 of the leaf's max|grad|: the sums run in another
    order, and the router's gradient is summed over ``model`` from each
    rank's experts (`Mesh.copy_to`).  On (2, 2) each data rank routes
    its own rows at its own capacity, as the reference's shards do, so
    its gradients are not the unsharded MoE's."""
    key = _key(shape)
    members = grads[shape]
    assert len(members) == shape[0] * shape[1]
    want_x = reference[f"grad_x_{key}"]
    got_x = np.zeros_like(want_x)
    for r in members:
        lo, hi = r["rows"]
        got_x[lo:hi] = r["x"]
    assert np.abs(got_x - want_x).max() <= GRAD_TOL * np.abs(want_x).max()
    for k in ("router", "w_gate", "w_up", "w_down"):
        want = reference[f"grad_{k}_{key}"]
        for r in members:
            block = want if k == "router" else want[slice(*r["experts"])]
            assert r[k].shape == block.shape
            err = np.abs(r[k] - block).max()
            assert err <= GRAD_TOL * np.abs(want).max(), (k, err)
