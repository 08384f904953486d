"""The port's model zoo against the reference's, every architecture at its
reduced size: the same weights (carried over by
``interop.model_params_from``) and the same numpy-seeded tokens through
``Model.forward`` of both packages in train, prefill and decode modes.

In f32 (the weights: the port's init with every constant leaf perturbed,
so that norm scales and the VLM's cross gates act): logits and every
cache leaf within 1e-4 * max|ref|, cache positions exact, the MoE aux
loss within rtol 1e-5, the chosen experts exact.  The bf16 cases are in
``test_torch_models_bf16.py``.  The reference runs jitted, each mode once
per architecture (a module-scoped fixture)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_params_from, reference_tree  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402

B, S = 2, 12
F32_TOL = 1e-4
# Leaves the reference initializes to constants: perturbed so that every
# norm scale and gate (the VLM's cross gates start at tanh(0) = 0) acts.
_CONSTANT_LEAVES = {"attn_norm", "mlp_norm", "attn_out_norm", "ssm_out_norm",
                    "self_norm", "cross_norm", "pre_norm", "final_norm",
                    "enc_norm", "q_norm", "k_norm", "norm", "d_skip",
                    "dt_bias", "a_log", "gate_attn", "gate_mlp"}


def configs(name, dtype):
    rcfg, cfg = ref_config(name).reduced(), get_config(name).reduced()
    if dtype != "float32":
        kw = dict(param_dtype=dtype, activation_dtype=dtype)
        rcfg, cfg = dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw)
    return rcfg, cfg


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def weights(cfg, seed=0):
    """The reference's parameter tree (numpy): the port's init from a
    seeded generator, constant leaves perturbed, mapped back."""
    model = build_model(cfg, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[-1] in _CONSTANT_LEAVES:
                p.add_((0.1 * torch.randn(p.shape, generator=gen)).to(p.dtype))
    return jax.tree.map(_to_numpy, reference_tree(model))


def _inputs(cfg, dtype):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    fe = None
    if cfg.family in ("vlm", "audio"):
        fe = rng.standard_normal((B, cfg.frontend_seq, cfg.frontend_dim)).astype(
            np.float32)
    return tokens, fe


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel(ref, got):
    ref, got = _f32(ref), _f32(got)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def run_both(name, dtype, tree, eager=False):
    """Train, prefill and decode through both packages on ``tree``:
    (cfg, reference outputs, port outputs)."""
    rcfg, cfg = configs(name, dtype)
    tokens, fe = _inputs(cfg, dtype)
    rm = RefModel(rcfg)
    params = jax.tree.map(jnp.asarray, tree)
    fwd = rm.forward if eager else jax.jit(rm.forward, static_argnames=("mode",))
    jfe = None if fe is None else jnp.asarray(fe, jnp.dtype(dtype))
    pos = np.full((B, 1), S, np.int32)
    ref = {}
    ref["train"], _, ref["aux"] = fwd(params, jnp.asarray(tokens), mode="train",
                                      frontend=jfe)
    ref["prefill"], rc, _ = fwd(params, jnp.asarray(tokens[:, :S]), mode="prefill",
                                caches=rm.init_caches(B, S + 1), frontend=jfe)
    ref["prefill_caches"] = jax.tree.map(np.asarray, rc)
    ref["decode"], rc, _ = fwd(params, jnp.asarray(tokens[:, S:]), mode="decode",
                               caches=rc, positions=jnp.asarray(pos))
    ref["decode_caches"] = jax.tree.map(np.asarray, rc)

    model = model_params_from(cfg, tree, device="cpu")
    tt = torch.from_numpy(tokens)
    tfe = None if fe is None else torch.from_numpy(fe)
    got = {}
    with torch.inference_mode():
        got["train"], _, got["aux"] = model(tt, mode="train", frontend=tfe)
        caches = model.init_caches(B, S + 1)
        got["prefill"], caches, _ = model(tt[:, :S], mode="prefill", caches=caches,
                                          frontend=tfe)
        got["prefill_caches"] = {k: v.clone() for k, v in flat(caches).items()}
        got["decode"], caches, _ = model(tt[:, S:], mode="decode", caches=caches,
                                         positions=torch.from_numpy(pos))
        got["decode_caches"] = flat(caches)
    return cfg, ref, got


@pytest.fixture(scope="module", params=ARCHS)
def f32_run(request):
    _, cfg = configs(request.param, "float32")
    return run_both(request.param, "float32", weights(cfg))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_logits_match_reference_f32(f32_run, mode):
    cfg, ref, got = f32_run
    assert got[mode].dtype == torch.float32
    assert tuple(got[mode].shape) == tuple(ref[mode].shape)
    assert rel(ref[mode], got[mode]) < F32_TOL, cfg.name


@pytest.mark.parametrize("stage", ["prefill_caches", "decode_caches"])
def test_caches_match_reference_f32(f32_run, stage):
    cfg, ref, got = f32_run
    ref_c = flat(ref[stage])
    assert set(ref_c) == set(got[stage])
    for key, r in ref_c.items():
        g = got[stage][key]
        assert tuple(g.shape) == r.shape, key
        if key[-1] == "pos":
            np.testing.assert_array_equal(g.numpy(), r, err_msg=str(key))
        else:
            assert rel(r, g) < F32_TOL, (cfg.name, key)


def test_moe_aux_loss_matches_reference(f32_run):
    cfg, ref, got = f32_run
    if not cfg.is_moe:
        assert float(got["aux"]) == float(ref["aux"]) == 0.0
        return
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]), rtol=1e-5)


# ------------------------------------------------------------------ MoE


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_router_topk_chooses_the_reference_experts(dtype):
    """Exact expert choices, ties included: bf16 logits on a coarse grid
    tie often, and the lower expert index must win as in lax.top_k."""
    rng = np.random.default_rng(3)
    logits = np.round(rng.standard_normal((64, 8)) * 4) / 4  # many ties
    logits = logits.astype(np.float32).astype(dtype)
    rw, re, raux = ref_moe.router_topk(jnp.asarray(logits), 2)
    tl = torch.from_numpy(logits.astype(np.float32))
    if dtype is not np.float32:
        tl = tl.to(torch.bfloat16)
    w, e, aux = moe.router_topk(tl, 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("name", [n for n in ARCHS if ref_config(n).is_moe])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_ffn_matches_reference(name, capacity_factor):
    """Layer 0's routed experts on the same tokens: the chosen experts
    exact and the output within 1e-4 * max, with drops (factor 0.5) and
    without."""
    _, cfg = configs(name, "float32")
    tree = weights(cfg)
    layer0 = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    x = np.random.default_rng(4).standard_normal((2, 24, cfg.d_model)).astype(
        np.float32)
    ref_out, ref_aux = ref_moe.moe_ffn(jnp.asarray(x), layer0, cfg.top_k,
                                       capacity_factor)
    model = model_params_from(cfg, tree, device="cpu")
    mod = model.layers[0].moe
    out, aux = moe.moe_ffn(torch.from_numpy(x), mod, cfg.top_k, capacity_factor)
    assert rel(ref_out, out) < F32_TOL
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    logits = x.reshape(-1, cfg.d_model) @ layer0["router"]
    _, re, _ = ref_moe.router_topk(jnp.asarray(logits), cfg.top_k)
    _, e, _ = moe.router_topk(torch.from_numpy(logits), cfg.top_k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))


# ------------------------------------------------------------ weights


@pytest.mark.parametrize("name", ARCHS)
def test_param_tree_is_the_reference_tree(name):
    """Same tree, stacked shapes and dtypes as the reference's
    init_params, at full size (shapes only)."""
    cfg = get_config(name)
    want = jax.eval_shape(lambda: RefModel(ref_config(name)).init(
        jax.random.PRNGKey(0)))
    model = Model(cfg, "meta")
    got = {k: (shape, items[0][1].dtype)
           for k, (shape, items) in model.reference_leaves().items()}
    want = {tuple(str(getattr(e, "key", e)) for e in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == set(want)
    for k, (shape, dtype) in got.items():
        assert (shape, str(dtype).replace("torch.", "")) == want[k], k


@pytest.mark.parametrize("name", ["llama3-8b", "llama-3.2-vision-11b"])
def test_model_params_from_carries_the_reference_init(name):
    """The reference's own init tree (the VLM's nested (groups, per) stack
    too) loads unchanged and maps back bitwise; a missing or extra leaf is
    refused."""
    rcfg, cfg = configs(name, "float32")
    params = jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = model_params_from(cfg, tree, device="cpu")
    back = flat(reference_tree(model))
    for key, leaf in flat(tree).items():
        np.testing.assert_array_equal(back[key].numpy(), leaf, err_msg=str(key))
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        model_params_from(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        model_params_from(cfg, dict(tree, bias=tree["final_norm"]), device="cpu")
    short = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        model_params_from(cfg, short, device="cpu")


def test_model_params_from_keeps_bf16():
    rcfg, cfg = configs("mamba2-780m", "bfloat16")
    params = jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = model_params_from(cfg, tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0].mamba.a_log.dtype == torch.float32
    np.testing.assert_array_equal(
        model.layers[1].mamba.in_proj.float().numpy(),
        tree["layers"]["mamba"]["in_proj"][1].astype(np.float32))


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_loss_matches_reference(name):
    """``Model.loss``: next-token cross entropy plus 0.01 * aux, in f32."""
    rcfg, cfg = configs(name, "float32")
    tree = weights(cfg)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10)).astype(
        np.int32)
    ref, ref_m = RefModel(rcfg).loss(jax.tree.map(jnp.asarray, tree),
                                     {"tokens": jnp.asarray(tokens)})
    model = model_params_from(cfg, tree, device="cpu")
    with torch.inference_mode():
        got, got_m = model.loss({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["aux"]), float(ref_m["aux"]), rtol=1e-5)
