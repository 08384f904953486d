"""Tensor parallelism of the MLA, Mamba-2, hybrid, VLM and audio families,
with the planner's cache blocks, on gloo ranks against the port's unsharded
model.

For each family (reduced configs, 2 layers, f32; deepseek-v2-lite as one
dense and one MoE layer, hymba as one SWA and one global layer, the VLM as
one self and one cross layer, whisper as 2 encoder and 2 decoder layers)
and for reduced llama3-8b (PR 22's 2 KV heads), one job of 4 CPU ranks
(`run_ranks`) serves greedily on (data, model) meshes of shapes (1, 2),
(1, 4) and (2, 2) with a batch of 4, and on (2, 2) with a batch of 1 (the
batch idles, so a KV cache's sequence splits over ``data`` and ``model``);
each rank's model is carried from the reference's ``init`` tree by
`interop.rank_model_from`.  Held against `serve_batch` of the unsharded
model on the same weights: the same greedy tokens, every step's logits
within 1e-5 of max|logit|.  Also: every parameter block and every cache
block is the reference planner's ``plan_params`` / ``plan_caches`` block
for the position; a seeded rank's leaves are the seeded unsharded model's
blocks bit for bit; each rank's tally of the prefill and of a decode step
equals a counting mesh's count at its position; and a train step on (1, 2)
and on (2, 2) (ZeRO-1, remat) gives the unsharded loss and gradient norm
within 1e-5 relative.  Sequence-sharded caches have cases of their own:
llama's KV cache on (1, 4), Hymba's ring where its length divides the
model axis (window 8) and where it does not (window 6), the MLA latent
cache, and the batch-idle layout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_ranks_bodies as bodies  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.sharding import planner as ref_planner  # noqa: E402
from repro_torch.configs import ARCHS as ALL_ARCHS, get_config  # noqa: E402
from repro_torch.interop import model_params_from, reference_tree  # noqa: E402
from repro_torch.launch import make_local_mesh, serve_batch  # noqa: E402
from repro_torch.launch.mesh import make_counting_mesh, run_ranks  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402
from repro_torch.sharding import ParamShard  # noqa: E402

LOGIT_TOL = 1e-5  # of max|logit|
TRAIN_RTOL = 1e-5
PROMPT, GEN = 8, 8  # a cache of 16 slots: it splits over 2 and 4 ranks

# Each family's reduced config, cut to 2 layers (and its variants by name).
FAMILIES = {
    "deepseek-v2-lite-16b": {"": dict(first_dense_layers=1)},
    "mamba2-780m": {"": {}},
    "hymba-1.5b": {"": dict(global_attn_layers=(1,), sliding_window=8),
                   "w6": dict(global_attn_layers=(1,), sliding_window=6)},
    "llama-3.2-vision-11b": {"": dict(cross_attn_every=1)},
    "whisper-medium": {"": {}},
    "llama3-8b": {"": {}},
}
ARCHS = list(FAMILIES)
# name -> (config variant, mesh shape, batch)
SERVE = {"1x2": ("", (1, 2), 4), "1x4": ("", (1, 4), 4),
         "2x2": ("", (2, 2), 4), "2x2_b1": ("", (2, 2), 1)}
HYMBA_W6 = {"1x4_w6": ("w6", (1, 4), 4)}
TRAIN = {"1x2": dict(shape=(1, 2), zero1=False, remat=False),
         "2x2": dict(shape=(2, 2), zero1=True, remat=True)}


def _serve_cases(arch):
    return {**SERVE, **(HYMBA_W6 if arch == "hymba-1.5b" else {})}


def _cfg(get, arch, variant=""):
    return dataclasses.replace(get(arch).reduced(), num_layers=2,
                               **FAMILIES[arch][variant])


class FakeMesh:
    """Axis-size stub for the reference planner (no devices needed)."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _axes(shape):
    return {"data": shape[0], "model": shape[1]}


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)[:batch]
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = rng.standard_normal(
            (4, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)[:batch]
    return prompts, frontend


def _train_inputs(cfg):
    rng = np.random.default_rng(1)
    tokens = [rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
              for _ in range(2)]
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = [rng.standard_normal((4, cfg.frontend_seq, cfg.frontend_dim))
                    .astype(np.float32) for _ in range(2)]
    return tokens, frontend


class Family:
    """One family's reference tree, unsharded runs and rank job."""

    def __init__(self, arch, store):
        self.arch = arch
        self.cfgs = {v: _cfg(get_config, arch, v) for v in FAMILIES[arch]}
        ref = RefModel(_cfg(ref_config, arch))
        self.tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
        self.serve_cases = {}
        for name, (variant, shape, batch) in _serve_cases(arch).items():
            prompts, frontend = _inputs(self.cfgs[variant], batch, 0)
            self.serve_cases[name] = dict(cfg=variant, shape=shape, prompts=prompts,
                                          prompts_frontend=frontend, gen=GEN)
        tokens, frontend = _train_inputs(self.cfgs[""])
        self.train_cases = {name: dict(case, cfg="", train=tokens,
                                       train_frontend=frontend)
                            for name, case in TRAIN.items()}
        self.ranks = run_ranks(bodies.tp_family, 4, store, self.cfgs, self.tree,
                               self.serve_cases, self.train_cases, device="cpu")
        self._unsharded = {}

    def unsharded_serve(self, name):
        case = self.serve_cases[name]
        key = (case["cfg"], case["prompts"].shape[0])
        if key not in self._unsharded:
            cfg = self.cfgs[case["cfg"]]
            model = model_params_from(cfg, self.tree, device="cpu")
            self._unsharded[key] = serve_batch(
                cfg, make_local_mesh(device="cpu"), case["prompts"], GEN,
                frontend=case["prompts_frontend"], model=model,
                keep_logits=True, print_fn=lambda *_: None)
        return self._unsharded[key]

    def unsharded_train(self, name):
        """The unsharded train step's metrics on the case's batches.  A
        MoE's load-balance loss is each data rank's rows' own (the
        reference's ``pmean``), so on a data axis of n the unsharded
        gradient is the mean of the n row blocks' losses'."""
        case = self.train_cases[name]
        cfg = self.cfgs[case["cfg"]]
        model = model_params_from(cfg, self.tree, device="cpu")
        bundle = make_train_step(cfg, make_local_mesh(device="cpu"),
                                 opt=bodies.TRAIN_OPT, remat=case["remat"])
        state, step = bundle.init_opt(model), bundle.jit_for(None)
        blocks = case["shape"][0] if cfg.is_moe else 1
        out = []
        for i, tokens in enumerate(case["train"]):
            batch = {"tokens": torch.from_numpy(tokens)}
            if case["train_frontend"] is not None:
                batch["frontend"] = torch.from_numpy(case["train_frontend"][i])
            if blocks == 1:
                state, m = step(model, state, batch)
            else:
                model.requires_grad_(True)
                losses = []
                for rows in zip(*(t.chunk(blocks) for t in batch.values())):
                    loss, _ = model.loss(dict(zip(batch, rows)), remat=case["remat"])
                    (loss / blocks).backward()
                    losses.append(loss.detach())
                grads = {n: p.grad for n, p in model.named_parameters()}
                m = adamw_update(model, grads, state, bodies.TRAIN_OPT)
                m["loss"] = torch.stack(losses).mean()
                model.zero_grad(set_to_none=True)
            out.append({k: float(v) for k, v in m.items()})
        return out

    def members(self, part, name):
        shape = (self.serve_cases if part == "serve" else self.train_cases)[name]["shape"]
        got = [r[part][name] for r in self.ranks if name in r[part]]
        assert len(got) == shape[0] * shape[1]
        return got


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Family(arch, tmp_path_factory.mktemp(f"tp_{arch}"))
        return made[arch]

    return get


def _serve_ids():
    return [(a, n) for a in ARCHS for n in _serve_cases(a)]


def _block(shape, spec, mesh_shape, coord):
    """The block of a leaf of ``shape`` a position holds under a reference
    spec (a PartitionSpec): each dimension's index flattened over its
    axes, major first."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n, index = 1, 0
        for a in axes:
            n, index = n * mesh_shape[a], index * mesh_shape[a] + coord[a]
        out.append(slice(index * (size // n), (index + 1) * (size // n)))
    return tuple(out)


def _cut(tree, specs, mesh_shape, coord):
    if isinstance(tree, dict):
        return {k: _cut(tree[k], specs[k], mesh_shape, coord) for k in tree}
    return np.asarray(tree)[_block(tree.shape, specs, mesh_shape, coord)]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _ref_param_blocks(tree, shape, coord):
    plan = ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape)))
    return _cut(tree, ref_planner.plan_params(plan, tree), _axes(shape), coord)


def _ref_cache_shapes(arch, variant, batch, cache_len, shape, coord):
    cfg = _cfg(ref_config, arch, variant)
    caches = jax.eval_shape(lambda: RefModel(cfg).init_caches(batch, cache_len))
    plan = ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape)))
    specs = ref_planner.plan_caches(plan, caches)
    out = {}
    for (keys, leaf), (_, spec) in zip(
            _flat(jax.tree.map(lambda x: x.shape, caches,
                               is_leaf=lambda x: hasattr(x, "shape"))),
            _flat(specs)):
        block = _block(leaf, spec, _axes(shape), coord)
        out[keys] = tuple(len(range(n)[b]) for n, b in zip(leaf, block))
    return out


@pytest.mark.parametrize("arch,name", _serve_ids())
def test_families_serve_as_the_unsharded_model(families, arch, name):
    fam = families(arch)
    want = fam.unsharded_serve(name)
    logits = want["logits"].numpy()
    scale = float(np.abs(logits).max())
    for r in fam.members("serve", name):
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        assert r["logits"].shape == logits.shape
        assert float(np.abs(r["logits"] - logits).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("arch,name", _serve_ids())
def test_families_hold_the_reference_planners_blocks(families, arch, name):
    """Every parameter leaf the reference planner's ``plan_params`` block
    (the carried weights' values), every cache leaf its ``plan_caches``
    block's shape."""
    fam = families(arch)
    case = fam.serve_cases[name]
    batch, cache_len = case["prompts"].shape[0], PROMPT + GEN
    for r in fam.members("serve", name):
        want = dict(_flat(_ref_param_blocks(fam.tree, case["shape"], r["coord"])))
        got = dict(_flat(r["carried"]))
        assert sorted(got) == sorted(want)
        for keys, leaf in want.items():
            np.testing.assert_array_equal(got[keys], leaf, err_msg=str(keys))
        caches = _ref_cache_shapes(arch, case["cfg"], batch, cache_len,
                                   case["shape"], r["coord"])
        assert r["cache_shapes"] == caches


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_family_ranks_are_the_unsharded_models_blocks(families, arch):
    fam = families(arch)
    whole = jax.tree.map(np.asarray, reference_tree(
        build_model(fam.cfgs[""], "cpu", seed=0)))
    for name in ("1x2", "1x4", "2x2"):
        for r in fam.members("serve", name):
            want = dict(_flat(_ref_param_blocks(whole, fam.serve_cases[name]["shape"],
                                                r["coord"])))
            got = dict(_flat(r["seeded"]))
            assert sorted(got) == sorted(want)
            for keys, leaf in want.items():
                np.testing.assert_array_equal(got[keys], leaf, err_msg=str(keys))


def _counted(cfg, case, coord):
    """The tally of the prefill and of a decode step at ``coord`` on a
    counting mesh (the meta device)."""
    shape = case["shape"]
    mesh = make_counting_mesh(shape, position=(coord["data"], coord["model"]))
    model = Model(cfg, "meta", ParamShard.of(mesh))
    b = case["prompts"].shape[0]
    batch = {"tokens": torch.empty((b, PROMPT), dtype=torch.int32, device="meta")}
    if case["prompts_frontend"] is not None:
        batch["frontend"] = torch.empty(case["prompts_frontend"].shape, device="meta")
    cache_len = PROMPT + GEN
    mark = mesh.copy_tally()
    _, caches = make_prefill_step(cfg, mesh, cache_len).jit_for(None)(model, batch)
    prefill = mesh.tally_since(mark)
    rows = b // shape[0] if b % shape[0] == 0 else b
    tok = torch.empty((rows, 1), dtype=torch.int32, device="meta")
    mark = mesh.copy_tally()
    make_serve_step(cfg, mesh, cache_len).jit_for(None)(model, caches, tok, tok)
    return {"prefill": prefill, "decode": mesh.tally_since(mark)}


@pytest.mark.parametrize("arch,name", _serve_ids())
def test_family_tallies_equal_a_counting_mesh(families, arch, name):
    fam = families(arch)
    case = fam.serve_cases[name]
    for r in fam.members("serve", name):
        assert r["collectives"] == _counted(fam.cfgs[case["cfg"]], case, r["coord"])


@pytest.mark.parametrize("arch,name", [(a, n) for a in ARCHS for n in TRAIN])
def test_family_train_step_matches_the_unsharded_step(families, arch, name):
    fam = families(arch)
    want = fam.unsharded_train(name)
    for r in fam.members("train", name):
        assert len(r["metrics"]) == len(want)
        for got, ref in zip(r["metrics"], want):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], ref[k], rtol=TRAIN_RTOL, err_msg=k)


# name -> (arch, serve case, cache path, the rank's block of it, a decode
# step's (all-reduce, all-gather) count).  Where a layer's cache is split
# by sequence, its decode gathers the queries of every head over
# ``model`` (MLA: q_lat and q_pe), takes the row maximum and sums the
# weights and values over the slot holders: one all-gather (two) and two
# all-reduces beyond the head-parallel layer's output sum.
SEQ_CASES = {
    # embedding 1; 2 layers x (gather; max, sum, wo, MLP); head 1
    "gqa_kv_heads_do_not_divide": (
        "llama3-8b", "1x4", ("layers", "k"), (2, 4, 16 // 4, 2, 32), (9, 3)),
    # 2 layers x (attention: gather, max, sum, wo; Mamba: in_proj's and
    # the conv's gathers, the norm's squares, out_proj; MLP)
    "hymba_ring_divides": (
        "hymba-1.5b", "1x4", ("swa", "attn", "k"), (1, 4, 8 // 4, 2, 32), (13, 7)),
    # the ring of 6 slots stays whole (replicated): its layer attends alone
    "hymba_ring_does_not_divide": (
        "hymba-1.5b", "1x4_w6", ("swa", "attn", "k"), (1, 4, 6, 2, 32), (11, 6)),
    # dense0 (q_lat and q_pe gathers, max, sum, w_o, MLP) and the MoE layer
    # (the same attention, the experts' output and aux sums, shared MLP)
    "mla_latent": (
        "deepseek-v2-lite-16b", "1x2", ("layers", "c_kv"), (1, 4, 16 // 2, 32),
        (11, 5)),
    # batch 1 on (2, 2): the sequence splits over data and model, the
    # cache holds both KV heads, so the new K and V are gathered too
    "batch_idle": (
        "llama3-8b", "2x2_b1", ("layers", "k"), (2, 1, 16 // 4, 2, 32), (9, 7)),
}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_sharded_caches(families, case):
    """The rank's cache block is the planner's ``seq`` block (for the ring
    of 6 slots over 4 ranks, ``replicated``), and a decode step issues the
    sequence split's collectives (`SEQ_CASES`)."""
    arch, name, keys, block, (reduces, gathers) = SEQ_CASES[case]
    fam = families(arch)
    for r in fam.members("serve", name):
        assert r["cache_shapes"][keys] == block
        assert r["collectives"]["decode"]["count"] == {
            "all-reduce": reduces, "all-gather": gathers,
            "_count": reduces + gathers}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_holds_the_reference_planners_blocks(arch, shape):
    """At full width (shapes only: the reference's ``eval_shape`` trees,
    the port's meta model), the last position of each mesh holds every
    parameter leaf at the shape of the reference planner's ``plan_params``
    block and every cache leaf of a batch of 4 over 64 slots (and of one
    row, where the batch idles on (2, 2)) at its ``plan_caches`` block."""
    cfg, ref = get_config(arch), RefModel(ref_config(arch))
    coord = {"data": shape[0] - 1, "model": shape[1] - 1}
    params = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
    plan = ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape)))
    specs = ref_planner.plan_params(plan, params)
    rank = Model(cfg, "meta", ParamShard(_axes(shape), coord))
    got = dict(_flat(rank.param_shapes()))
    want = {}
    for (keys, leaf), (_, spec) in zip(_flat(jax.tree.map(
            lambda x: x.shape, params, is_leaf=lambda x: hasattr(x, "shape"))),
            _flat(specs)):
        block = _block(leaf, spec, _axes(shape), coord)
        want[keys] = tuple(len(range(n)[b]) for n, b in zip(leaf, block))
    assert {k: tuple(v) for k, v in got.items()} == want
    for batch in (4, 1):
        held = {k: tuple(v.shape) for k, v in _flat(rank.init_caches(batch, 64))}
        caches = jax.eval_shape(lambda: ref.init_caches(batch, 64))
        cspecs = ref_planner.plan_caches(
            ref_planner.ShardingPlan(mesh=FakeMesh(_axes(shape))), caches)
        want = {}
        for (keys, leaf), (_, spec) in zip(_flat(jax.tree.map(
                lambda x: x.shape, caches, is_leaf=lambda x: hasattr(x, "shape"))),
                _flat(cspecs)):
            block = _block(leaf, spec, _axes(shape), coord)
            want[keys] = tuple(len(range(n)[b]) for n, b in zip(leaf, block))
        assert held == want, batch
