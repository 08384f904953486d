"""Expert-parallel serving on gloo ranks against the port's unsharded model.

A reduced qwen3-moe-30b-a3b (2 layers, E = 8, top-2, f32), its weights
the reference's ``init`` tree: greedy `serve_batch` (prefill, then
decode) on (data, model) rank meshes of shapes (1, 2), (1, 4) and (2, 2)
(`run_ranks`, 4 CPU ranks, one job), each rank's model carried by
`interop.rank_model_from`, against `serve_batch` of the unsharded model
on the same weights: the same greedy tokens, and every step's logits
within 1e-5 of max|logit| (the shard sum's order is the only
difference).  Also: the carried and seeded expert shards are the whole
model's blocks, and the train step runs on an expert-parallel mesh, its
loss and gradient norm the unsharded step's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_ranks_bodies as bodies  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_params_from  # noqa: E402
from repro_torch.launch import Mesh, make_local_mesh, serve_batch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SHAPES = [(1, 2), (1, 4), (2, 2)]
LOGIT_TOL = 1e-5  # of max|logit|
GEN = 6


def _cfg(get):
    return dataclasses.replace(get("qwen3-moe-30b-a3b").reduced(), num_layers=2)


@pytest.fixture(scope="module")
def tree():
    params = jax.jit(RefModel(_cfg(ref_config)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 512, (4, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def unsharded(tree, prompts):
    cfg = _cfg(get_config)
    model = model_params_from(cfg, tree, device="cpu")
    return serve_batch(cfg, make_local_mesh(device="cpu"), prompts, GEN,
                       model=model, keep_logits=True, print_fn=lambda *_: None)


@pytest.fixture(scope="module")
def train_batches():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, (4, 16)).astype(np.int32) for _ in range(2)]


def _train_unsharded(cfg, tree, batches) -> list:
    """Two steps' metrics of the unsharded train step on the reference
    tree's weights."""
    model = model_params_from(cfg, tree, device="cpu")
    bundle = make_train_step(cfg, make_local_mesh(device="cpu"),
                             opt=bodies.TRAIN_OPT, remat=False)
    state, step = bundle.init_opt(model), bundle.jit_for(None)
    out = []
    for tokens in batches:
        state, m = step(model, state, {"tokens": torch.from_numpy(tokens)})
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def ranks(tree, prompts, train_batches, tmp_path_factory):
    return run_ranks(bodies.serve, 4, tmp_path_factory.mktemp("serve_ranks"),
                     _cfg(get_config), tree, prompts, GEN, SHAPES, train_batches,
                     device="cpu")


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_rank_serve_matches_the_unsharded_model(ranks, unsharded, shape):
    want = unsharded["logits"].numpy()
    scale = float(np.abs(want).max())
    got = [r[shape] for r in ranks if shape in r]
    assert len(got) == shape[0] * shape[1]
    for r in got:  # every rank returns the whole batch
        np.testing.assert_array_equal(r["tokens"], unsharded["tokens"])
        assert r["logits"].shape == want.shape
        assert float(np.abs(r["logits"] - want).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_rank_models_hold_their_expert_block(ranks, tree, shape):
    """`rank_model_from` cuts the reference's expert leaves to the rank's
    block along the expert dimension and keeps the router whole; a model
    built from a seed with the same shard holds the unsharded seeded
    model's block."""
    cfg = _cfg(get_config)
    seeded = build_model(cfg, "cpu", seed=0).layers[0].moe
    moe = tree["layers"]["moe"]
    for r in (r[shape] for r in ranks if shape in r):
        index, count = r["shard"]
        assert (index, count) == (r["coord"]["model"], shape[1])
        e = cfg.num_experts // count
        block = slice(index * e, (index + 1) * e)
        np.testing.assert_array_equal(r["carried"]["router"], moe["router"][0])
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(r["carried"][k], moe[k][0][block])
        np.testing.assert_array_equal(r["seeded"]["router"],
                                      seeded.router.numpy())
        for k in ("w_gate", "w_down"):
            np.testing.assert_array_equal(r["seeded"][k],
                                          getattr(seeded, k)[block].numpy())


def test_train_step_refuses_an_expert_parallel_mesh(ranks, tree, train_batches):
    """The train step no longer refuses an expert-parallel mesh: on a
    (1, 2) rank mesh each rank trains its experts (and its heads), and
    its two steps' loss and gradient norm are the unsharded step's on the
    same weights within rtol 1e-6 (tests/test_torch_ranks_train.py holds
    every leaf's moments and parameters, the router's included).  A mesh
    of devices in one process, and one whose model axis does not divide
    the experts, train the whole model."""
    cfg = _cfg(get_config)
    want = _train_unsharded(cfg, tree, train_batches)
    got = [r[(1, 2)] for r in ranks if (1, 2) in r]
    assert len(got) == 2
    for r in got:
        for m, ref in zip(r["trained"], want):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(m[k], ref[k], rtol=1e-6, err_msg=k)
    for n in (2, 3):  # 8 experts split over 2, not over 3
        devs = np.empty(n, dtype=object)
        devs[:] = [torch.device("cpu")] * n
        bundle = make_train_step(cfg, Mesh(("data", "model"), devs.reshape(1, n)),
                                 opt=bodies.TRAIN_OPT, remat=False)
        model = model_params_from(cfg, tree, device="cpu")
        _, m = bundle.jit_for(None)(model, bundle.init_opt(model),
                                    {"tokens": torch.from_numpy(train_batches[0])})
        np.testing.assert_allclose(float(m["loss"]), want[0]["loss"], rtol=1e-6)
