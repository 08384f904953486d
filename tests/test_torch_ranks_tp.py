"""Tensor-parallel serving on gloo ranks against the port's unsharded model.

A reduced llama3-8b (2 layers, f32; 4 heads, 2 KV heads, vocab 512), its
weights the reference's ``init`` tree: greedy `serve_batch` on (data,
model) rank meshes of shapes (1, 2), (1, 4) and (2, 2) (`run_ranks`, 4
CPU ranks, one job), each rank's model carried by
`interop.rank_model_from`, against `serve_batch` of the unsharded model on
the same weights: the same greedy tokens, and every step's logits within
1e-5 of max|logit| (the partial sums' order is the only difference).  On
(1, 4) the 2 KV heads do not split over 4 ranks: the queries are split,
the KV projections whole, and each rank attends with the KV head its
query head uses.  Also: each rank holds the block of every leaf that the
reference planner's spec gives its position, a seeded rank's leaves are
the seeded unsharded model's blocks bit for bit, a decode step issues
2L + 1 ``all_reduce``s and one ``all_gather``, and the train step runs
on a tensor-parallel mesh, its loss and gradient norm the unsharded
step's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_ranks_bodies as bodies  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.sharding import planner as ref_planner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_params_from, reference_tree  # noqa: E402
from repro_torch.launch import Mesh, make_local_mesh, serve_batch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models.blocks import rank_kv_heads  # noqa: E402
from repro_torch.sharding import ParamShard  # noqa: E402

SHAPES = [(1, 2), (1, 4), (2, 2)]
LOGIT_TOL = 1e-5  # of max|logit|
GEN = 6
BATCH, PROMPT = 4, 8


def _cfg(get):
    return dataclasses.replace(get("llama3-8b").reduced(), num_layers=2)


class FakeMesh:
    """Axis-size stub for the reference planner (no devices needed)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


def _axes(shape):
    return {"data": shape[0], "model": shape[1]}


@pytest.fixture(scope="module")
def tree():
    params = jax.jit(RefModel(_cfg(ref_config)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, 512, (BATCH, PROMPT)).astype(np.int32)


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
    return run_ranks(bodies.tensor_parallel, 4, tmp_path_factory.mktemp("tp_ranks"),
                     _cfg(get_config), tree, prompts, GEN, SHAPES, train_batches,
                     device="cpu")


def _members(ranks, shape):
    got = [r[shape] for r in ranks if shape in r]
    assert len(got) == shape[0] * shape[1]
    return got


def _ref_blocks(tree, shape, coord):
    """Each leaf of ``tree`` cut to the block of the reference planner's
    spec at ``coord``: a dimension the spec puts on ``model`` splits into
    equal blocks, the block at the coordinate's model index."""
    plan = ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape)))
    specs = ref_planner.plan_params(plan, tree)
    n = shape[1]

    def cut(leaf, spec):
        if isinstance(leaf, dict):
            return {k: cut(leaf[k], spec[k]) for k in leaf}
        index = []
        for dim, size in enumerate(leaf.shape):
            if dim < len(spec) and spec[dim] == "model":
                step = size // n
                index.append(slice(coord["model"] * step,
                                   (coord["model"] + 1) * step))
            else:
                index.append(slice(None))
        return np.asarray(leaf)[tuple(index)]

    return cut(tree, specs)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_tensor_parallel_serve_matches_the_unsharded_model(ranks, unsharded, shape):
    want = unsharded["logits"].numpy()
    scale = float(np.abs(want).max())
    for r in _members(ranks, shape):  # every rank returns the whole batch
        np.testing.assert_array_equal(r["tokens"], unsharded["tokens"])
        assert r["logits"].shape == want.shape
        assert float(np.abs(r["logits"] - want).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_rank_models_hold_the_reference_planners_blocks(ranks, tree, shape):
    """`rank_model_from` holds, of every leaf, the block of the reference
    planner's spec for the rank's position; on these meshes the heads,
    ffn and vocabulary blocks are split, and on (1, 4) the 2 KV heads
    stay whole."""
    for r in _members(ranks, shape):
        want = dict(_flat(_ref_blocks(tree, shape, r["coord"])))
        got = dict(_flat(r["carried"]))
        assert sorted(got) == sorted(want)
        for keys, leaf in want.items():
            np.testing.assert_array_equal(got[keys], leaf, err_msg=str(keys))
        n = shape[1]
        assert got[("embed",)].shape == (512 // n, 128)
        assert got[("lm_head",)].shape == (128, 512 // n)
        assert got[("layers", "attn", "wq")].shape == (2, 128, 4 // n, 32)
        assert got[("layers", "mlp", "w_down")].shape == (2, 256 // n, 128)
        kv = 2 // n if 2 % n == 0 else 2
        assert got[("layers", "attn", "wk")].shape == (2, 128, kv, 32)


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_seeded_rank_models_are_the_unsharded_models_blocks(ranks, shape):
    whole = jax.tree.map(np.asarray, reference_tree(
        build_model(_cfg(get_config), "cpu", seed=0)))
    for r in _members(ranks, shape):
        want = dict(_flat(_ref_blocks(whole, shape, r["coord"])))
        got = dict(_flat(r["seeded"]))
        assert sorted(got) == sorted(want)
        for keys, leaf in want.items():
            np.testing.assert_array_equal(got[keys], leaf, err_msg=str(keys))


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_decode_step_issues_two_collectives_a_layer(ranks, shape):
    """One decode step: the embedding's all_reduce, one after the
    attention and one after the MLP of each layer, and the head's
    all_gather: 2L + 2 collectives, each of this rank's rows (B / data)."""
    layers, d, vocab = 2, 128, 512
    rows = BATCH // shape[0]
    for r in _members(ranks, shape):
        for step, seq in (("decode", 1), ("prefill", PROMPT)):
            tally = r["collectives"][step]
            assert tally["count"] == {"all-reduce": 2 * layers + 1,
                                      "all-gather": 1,
                                      "_count": 2 * layers + 2}
            assert tally["bytes"] == {
                "all-reduce": (2 * layers + 1) * rows * seq * d * 4,
                "all-gather": rows * seq * (vocab // shape[1]) * 4,
                "_count": 2 * layers + 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_shape, w_shape", [((2, 3, 16), (16, 8)),
                                              ((2, 3, 4, 5), (4, 5, 8))],
                         ids=["mlp", "attention"])
def test_row_parallel_rounds_the_partial_sum_once(dtype, x_shape, w_shape):
    """`_row_parallel` on one position is the product contracting ``x``'s
    trailing dims with ``w``'s leading ones, accumulated in f32 and
    rounded once to ``x``'s dtype (no f32 copy of the weights on the
    card; the CPU upcasts)."""
    from repro_torch.models.layers import row_parallel as _row_parallel

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(x_shape), dtype=torch.float32).to(dt)
    w = torch.tensor(rng.standard_normal(w_shape), dtype=torch.float32).to(dt)
    got = _row_parallel(x, w, make_local_mesh(device="cpu"))
    k = len(w_shape) - 1
    want = torch.tensordot(x.float(), w.float(), dims=k).to(dt)
    assert got.dtype == dt and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0 if dtype == "bfloat16" else 1e-6)


def test_rank_kv_heads_follow_gqa():
    """The KV heads a rank's query heads use: all where the KV heads split
    with the queries; where only the queries split, those of query head
    h // G, as a slice where they group evenly, else one a query head."""
    cfg = _cfg(get_config)  # 4 heads, 2 KV heads: G = 2
    assert rank_kv_heads(cfg, 4, 2, 0) == slice(None)  # whole
    assert rank_kv_heads(cfg, 2, 1, 1) == slice(None)  # split together
    assert [rank_kv_heads(cfg, 1, 2, i) for i in range(4)] == [
        slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    cfg = dataclasses.replace(cfg, num_heads=12, num_kv_heads=4)  # G = 3
    assert rank_kv_heads(cfg, 4, 4, 0) == [0, 0, 0, 1]
    assert rank_kv_heads(cfg, 4, 4, 1) == slice(1, 3)
    assert rank_kv_heads(cfg, 6, 4, 1) == slice(2, 4)


def test_a_llama3_8b_rank_holds_half_of_every_split_leaf():
    """At full width on (1, 2), shapes only (meta): embed, lm_head,
    wq/wk/wv/wo and w_gate/w_up/w_down are halved; the norms are whole."""
    cfg = get_config("llama3-8b")
    whole = Model(cfg, "meta")
    shard = ParamShard({"data": 1, "model": 2}, {"data": 0, "model": 1})
    rank = Model(cfg, "meta", shard)
    halved = {"embed": 0, "lm_head": 1, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
              "w_gate": 1, "w_up": 1, "w_down": 0}
    params = dict(rank.named_parameters())
    for name, param in whole.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = list(param.shape)
        if leaf in halved:
            want[halved[leaf]] //= 2
            assert rank.blocks[name][0] == tuple(param.shape)
        else:
            assert name not in rank.blocks
        assert list(params[name].shape) == want, name
    whole_bytes = sum(p.numel() for p in whole.parameters())
    rank_bytes = sum(p.numel() for p in rank.parameters())
    assert abs(rank_bytes / whole_bytes - 0.5) < 1e-4
    caches = rank.init_caches(4, 64)["layers"]
    assert caches["k"].shape == (32, 4, 64, 4, 128)  # 8 KV heads / 2


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-14b", "deepseek-67b",
                                  "deepseek-coder-33b", "qwen3-moe-30b-a3b"])
def test_rank_models_of_the_slice_hold_the_reference_planners_blocks(arch):
    """At full width (shapes only: the reference's ``eval_shape`` tree,
    the port's meta model), every leaf of the last rank of a (1, 4) mesh
    has the shape of the reference planner's block."""
    params = jax.eval_shape(lambda: RefModel(ref_config(arch)).init(
        jax.random.PRNGKey(0)))
    shape = (1, 4)
    specs = ref_planner.plan_params(
        ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape))), params)
    rank = Model(get_config(arch), "meta",
                 ParamShard(_axes(shape), {"data": 0, "model": 3}))
    got = dict(_flat(rank.param_shapes()))

    def walk(leaf, spec, keys=()):
        if isinstance(leaf, dict):
            for k in leaf:
                walk(leaf[k], spec[k], keys + (k,))
            return
        want = tuple(n // shape[1] if d < len(spec) and spec[d] == "model"
                     else n for d, n in enumerate(leaf.shape))
        assert tuple(got[keys]) == want, keys

    walk(params, specs)
    assert len(got) == len(jax.tree.leaves(params))


def test_train_step_refuses_a_tensor_parallel_rank_mesh(ranks, tree, train_batches):
    """The train step no longer refuses a tensor-parallel rank mesh: on
    (1, 2) each rank trains its blocks, and its two steps' loss and
    gradient norm are the unsharded step's on the same weights within
    rtol 1e-6 (tests/test_torch_ranks_train.py holds every leaf's
    moments and parameters).  A mesh of devices in one process trains
    the whole model."""
    cfg = _cfg(get_config)
    want = _train_unsharded(cfg, tree, train_batches)
    for r in _members(ranks, (1, 2)):
        assert len(r["trained"]) == len(want)
        for got, ref in zip(r["trained"], want):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cpu")] * 2
    bundle = make_train_step(cfg, Mesh(("data", "model"), devs.reshape(1, 2)),
                             opt=bodies.TRAIN_OPT, remat=False)
    model = model_params_from(cfg, tree, device="cpu")
    _, m = bundle.jit_for(None)(model, bundle.init_opt(model),
                                {"tokens": torch.from_numpy(train_batches[0])})
    np.testing.assert_allclose(float(m["loss"]), want[0]["loss"], rtol=1e-6)


def test_a_rank_model_defaults_to_the_card():
    """No tensor-parallel model lands on the CPU when the card was asked
    for: building one without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    shard = ParamShard({"data": 1, "model": 2}, {"data": 0, "model": 0})
    for build in (lambda: Model(_cfg(get_config), shard=shard),
                  lambda: build_model(_cfg(get_config), seed=0, shard=shard)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
