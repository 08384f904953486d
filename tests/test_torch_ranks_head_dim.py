"""The planner's head-dim fallback in rank models, on gloo ranks against the
port's unsharded model.

Where an attention projection's heads do not divide the model axis, a
model built with ``ParamShard.of(mesh, head_dim_fallback=True)`` holds a
block of its head_dim (the reference planner's
``shard_head_dim_fallback``).  One job of 4 CPU ranks (`run_ranks`; bodies
in `torch_ranks_bodies.head_dim`) serves greedily with
``shard_head_dim_fallback=True``, each rank's model carried from the
reference's ``init`` tree, on reduced configs (2 layers, f32):

* hymba with 5 heads and 1 KV head (its published 5:1 grouping) on (1, 2),
  (1, 4) and (2, 2): every projection falls back, its KV cache splits by
  sequence;
* qwen3-14b with 10 heads and 2 KV heads on (1, 4), for ``qk_norm`` over a
  gathered head_dim;
* llama3-8b (4 heads, 2 KV heads) on (1, 4): the query heads split, the
  KV projections fall back;
* whisper with 3 heads (and 3 KV heads) on (1, 2): encoder, self and
  cross attention;
* deepseek-v2-lite with 3 heads on (1, 2), for MLA: ``w_q`` (128, 3, 48)
  splits on its nope+rope dim, ``w_uk``/``w_uv``/``w_o`` on the head_dim.

Held against `serve_batch` of the unsharded model on the same weights
(itself held to the reference by tests/test_torch_models*.py; the
reference's sharded serve does not run on jax 0.9): the same greedy
tokens, every step's logits within 1e-5 of max|logit|.  Each rank holds
the reference planner's ``plan_params`` block under the flag, and its
tally of the prefill and of a decode step equals a counting mesh's.  The
train step refuses such a model, a serve step whose flag is not the
model's raises, and the flag's counts differ from the plan without it."""
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
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.interop import model_params_from  # noqa: E402
from repro_torch.launch import make_local_mesh, serve_batch  # noqa: E402
from repro_torch.launch.dryrun import count_cell  # noqa: E402
from repro_torch.launch.mesh import make_counting_mesh, run_ranks  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import ParamShard, shard_slices  # noqa: E402

LOGIT_TOL = 1e-5  # of max|logit|
PROMPT, GEN = 8, 8  # a cache of 16 slots

# name -> (arch, overrides of its reduced config, cut to 2 layers)
CONFIGS = {
    "hymba": ("hymba-1.5b", dict(num_heads=5, num_kv_heads=1,
                                 global_attn_layers=(1,), sliding_window=8)),
    "qwen3": ("qwen3-14b", dict(num_heads=10, num_kv_heads=2)),
    "llama": ("llama3-8b", {}),
    "whisper": ("whisper-medium", dict(num_heads=3, num_kv_heads=3)),
    "mla": ("deepseek-v2-lite-16b", dict(num_heads=3, first_dense_layers=1)),
}
# case -> (config, mesh shape)
CASES = {"hymba_1x2": ("hymba", (1, 2)), "hymba_1x4": ("hymba", (1, 4)),
         "hymba_2x2": ("hymba", (2, 2)), "qwen3_1x4": ("qwen3", (1, 4)),
         "llama_1x4": ("llama", (1, 4)), "whisper_1x2": ("whisper", (1, 2)),
         "mla_1x2": ("mla", (1, 2))}
# Leaves a case must hold as head_dim blocks (so the fallback is exercised).
HEAD_DIM_LEAVES = {"hymba": ("wq", "wk", "wv", "wo"), "qwen3": ("wq", "wk", "wv", "wo"),
                   "llama": ("wk", "wv"), "whisper": ("wq", "wk", "wv", "wo"),
                   "mla": ("w_q", "w_uk", "w_uv", "w_o")}


def _cfg(get, name):
    arch, overrides = CONFIGS[name]
    return dataclasses.replace(get(arch).reduced(), num_layers=2, **overrides)


def _axes(shape):
    return {"data": shape[0], "model": shape[1]}


class FakeMesh:
    """Axis-size stub for the reference planner (no devices needed)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = rng.standard_normal(
            (4, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return prompts, frontend


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cfgs = {name: _cfg(get_config, name) for name in CONFIGS}
    trees = {name: jax.tree.map(np.asarray, jax.jit(RefModel(_cfg(ref_config, name)).init)(
        jax.random.PRNGKey(0))) for name in CONFIGS}
    cases = {}
    for case, (name, shape) in CASES.items():
        prompts, frontend = _inputs(cfgs[name])
        cases[case] = dict(cfg=name, shape=shape, prompts=prompts,
                           frontend=frontend, gen=GEN)
    ranks = run_ranks(bodies.head_dim, 4, tmp_path_factory.mktemp("hd_ranks"),
                      cfgs, trees, cases, device="cpu")
    return cfgs, trees, cases, ranks


def _members(ranks, case):
    shape = CASES[case][1]
    got = [r[case] for r in ranks if case in r]
    assert len(got) == shape[0] * shape[1]
    return got


_unsharded: dict = {}


def _unsharded_serve(cfgs, trees, cases, case):
    name = cases[case]["cfg"]
    if name not in _unsharded:
        cfg = cfgs[name]
        model = model_params_from(cfg, trees[name], device="cpu")
        _unsharded[name] = serve_batch(
            cfg, make_local_mesh(device="cpu"), cases[case]["prompts"], GEN,
            frontend=cases[case]["frontend"], model=model, keep_logits=True,
            print_fn=lambda *_: None)
    return _unsharded[name]


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_ranks_serve_as_the_unsharded_model(job, case):
    cfgs, trees, cases, ranks = job
    want = _unsharded_serve(cfgs, trees, cases, case)
    logits = want["logits"].numpy()
    scale = float(np.abs(logits).max())
    for r in _members(ranks, case):
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        assert r["logits"].shape == logits.shape
        assert float(np.abs(r["logits"] - logits).max()) <= LOGIT_TOL * scale


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_ranks_hold_the_reference_planners_blocks(job, case):
    """Every leaf the reference planner's ``plan_params`` block under
    ``shard_head_dim_fallback=True`` (cut by `shard_slices`), the named
    attention leaves as head_dim blocks."""
    cfgs, trees, cases, ranks = job
    name, shape = CASES[case]
    plan = ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape)),
                                    shard_head_dim_fallback=True)
    specs = dict(_flat(ref_planner.plan_params(plan, trees[name])))
    whole = dict(_flat(trees[name]))
    for r in _members(ranks, case):
        got = dict(_flat(r["carried"]))
        assert sorted(got) == sorted(whole)
        for keys, leaf in whole.items():
            spec = tuple(specs[keys])
            block = shard_slices(spec, leaf.shape, _axes(shape), r["coord"])
            np.testing.assert_array_equal(got[keys], np.asarray(leaf)[block],
                                          err_msg=str(keys))
            if keys[-1] in HEAD_DIM_LEAVES[name]:
                dim = -2 if keys[-1] in ("wo", "w_o") else -1
                assert spec[dim] == "model" and got[keys].shape[dim] < leaf.shape[dim], keys


def _counted(cfg, case, coord):
    """The tally of the prefill and of a decode step at ``coord`` on a
    counting mesh (the meta device), the model and the step under the
    flag."""
    shape = case["shape"]
    mesh = make_counting_mesh(shape, position=(coord["data"], coord["model"]))
    model = Model(cfg, "meta", ParamShard.of(mesh, head_dim_fallback=True))
    b = case["prompts"].shape[0]
    batch = {"tokens": torch.empty((b, PROMPT), dtype=torch.int32, device="meta")}
    if case["frontend"] is not None:
        batch["frontend"] = torch.empty(case["frontend"].shape, device="meta")
    cache_len = PROMPT + GEN
    mark = mesh.copy_tally()
    _, caches = make_prefill_step(cfg, mesh, cache_len).jit_for(None)(model, batch)
    prefill = mesh.tally_since(mark)
    tok = torch.empty((b // shape[0], 1), dtype=torch.int32, device="meta")
    mark = mesh.copy_tally()
    make_serve_step(cfg, mesh, cache_len, shard_head_dim_fallback=True).jit_for(None)(
        model, caches, tok, tok)
    return {"prefill": prefill, "decode": mesh.tally_since(mark)}


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_tallies_equal_a_counting_mesh(job, case):
    cfgs, _, cases, ranks = job
    cfg = cfgs[cases[case]["cfg"]]
    for r in _members(ranks, case):
        assert r["collectives"] == _counted(cfg, cases[case], r["coord"])


def _meta(name, shape, flag):
    mesh = make_counting_mesh(shape, position=(0, 0))
    return mesh, Model(_cfg(get_config, name), "meta",
                       ParamShard.of(mesh, head_dim_fallback=flag))


def test_the_train_step_refuses_a_head_dim_model():
    mesh, model = _meta("hymba", (1, 2), True)
    bundle = make_train_step(model.cfg, mesh, remat=False)
    tokens = torch.empty((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="shard_head_dim_fallback"):
        bundle.jit_for(None)(model, bundle.init_opt(model), {"tokens": tokens})


@pytest.mark.parametrize("model_flag", [True, False])
def test_a_serve_step_refuses_a_model_of_the_other_layout(model_flag):
    mesh, model = _meta("hymba", (1, 2), model_flag)
    caches = model.init_caches(4, PROMPT + GEN)
    tok = torch.empty((4, 1), dtype=torch.int32, device="meta")
    step = make_serve_step(model.cfg, mesh, PROMPT + GEN,
                           shard_head_dim_fallback=not model_flag).jit_for(None)
    with pytest.raises(ValueError, match="shard_head_dim_fallback"):
        step(model, caches, tok, tok)


def test_the_flag_moves_the_counted_decode():
    """A decode step counted on a counting mesh under the flag holds fewer
    parameter bytes than without it (hymba's attention split by
    head_dim, not kept whole) and issues more collectives (the q/k/v
    gathers)."""
    cfg = _cfg(get_config, "hymba")
    sp = ShapeSpec("decode_4x16", 16, 4, "decode")
    counts = {flag: count_cell(cfg, sp, mesh=make_counting_mesh((1, 4), position=(0, 0)),
                               shard_head_dim_fallback=flag)
              for flag in (False, True)}
    assert counts[True]["num_params"] < counts[False]["num_params"]
    assert counts[True]["collective_counts"]["all-gather"] > \
        counts[False]["collective_counts"].get("all-gather", 0)
