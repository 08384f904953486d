"""The port's serving path against the reference: greedy ``serve_batch``
on the reference serve test's ``_tiny`` llama3-8b and mamba2-780m configs
gives the tokens of a reference greedy loop over ``Model.forward``
(prefill, then decode) on the same carried weights, with every step's
logits within 1e-4 * max; plus sampling, the MoE combine's repeatability,
the steps' condition for the expert-parallel MoE, and the meshes."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import model_params_from  # noqa: E402
from repro_torch.launch import (Mesh, batch_axes_of, make_local_mesh,  # noqa: E402
                                make_prefill_step, make_production_mesh,
                                make_serve_step, serve_batch)
from repro_torch.launch.steps import _mesh_info, make_plan  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _tiny(get, name):
    """tests/test_serve_integration.py's ``_tiny`` config."""
    cfg = get(name).reduced()
    fields = dict(num_layers=2, d_model=64, vocab_size=128)
    if cfg.num_heads:
        fields.update(num_heads=2, num_kv_heads=min(cfg.num_kv_heads, 2),
                      head_dim=32)
    return dataclasses.replace(cfg, **fields)


def _reference_greedy(rcfg, params, prompts, gen_len):
    """The reference's serving loop (``serve_batch`` without its jitted,
    sharded steps): prefill, argmax, then one decode step a token."""
    model = RefModel(rcfg)
    fwd = jax.jit(model.forward, static_argnames=("mode",))
    b, plen = prompts.shape
    caches = model.init_caches(b, plen + gen_len)
    logits, caches, _ = fwd(params, jnp.asarray(prompts), mode="prefill",
                            caches=caches)
    steps = [np.asarray(logits[:, -1])]
    tok = logits[:, -1].argmax(-1).reshape(b, 1).astype(jnp.int32)
    out = np.zeros((b, gen_len), np.int32)
    for i in range(gen_len):
        out[:, i] = np.asarray(tok)[:, 0]
        pos = jnp.full((b, 1), plen + i, jnp.int32)
        logits, caches, _ = fwd(params, tok, mode="decode", caches=caches,
                                positions=pos)
        steps.append(np.asarray(logits[:, -1]))
        tok = logits[:, -1].argmax(-1).reshape(b, 1).astype(jnp.int32)
    return out, np.stack(steps)


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-780m"])
def test_greedy_serve_matches_reference_loop(name):
    rcfg, cfg = _tiny(ref_config, name), _tiny(get_config, name)
    params = jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(0))
    model = model_params_from(cfg, jax.tree.map(np.asarray, params), device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(
        np.int32)
    res = serve_batch(cfg, make_local_mesh(device="cpu"), prompts, gen_len=6,
                      model=model, keep_logits=True, print_fn=lambda *_: None)
    ref_tokens, ref_logits = _reference_greedy(rcfg, params, prompts, 6)
    np.testing.assert_array_equal(res["tokens"], ref_tokens)
    assert res["logits"].shape == ref_logits.shape
    err = np.abs(res["logits"].numpy() - ref_logits).max() / np.abs(ref_logits).max()
    assert err < 1e-4


def test_serve_greedy_deterministic_and_sampling_repeatable():
    cfg = _tiny(get_config, "llama3-8b")
    mesh = make_local_mesh(device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(
        np.int32)
    kw = dict(device="cpu", print_fn=lambda *_: None)
    a = serve_batch(cfg, mesh, prompts, gen_len=5, **kw)
    b = serve_batch(cfg, mesh, prompts, gen_len=5, **kw)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    s1 = serve_batch(cfg, mesh, prompts, gen_len=5, temperature=1.0, seed=3, **kw)
    s2 = serve_batch(cfg, mesh, prompts, gen_len=5, temperature=1.0, seed=3, **kw)
    assert s1["tokens"].shape == (2, 5)
    assert (s1["tokens"] >= 0).all() and (s1["tokens"] < cfg.vocab_size).all()
    np.testing.assert_array_equal(s1["tokens"], s2["tokens"])


def test_moe_combine_is_repeatable_and_sums_in_k_order():
    """Two calls give the same bits, and the combine equals each token's
    K weighted expert outputs summed in k order (no scatter-add)."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = build_model(cfg, "cpu", seed=0)
    p = model.layers[0].moe
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        a, _ = moe.moe_ffn(x, p, cfg.top_k, cfg.capacity_factor)
        b, _ = moe.moe_ffn(x, p, cfg.top_k, cfg.capacity_factor)
        assert torch.equal(a, b)
        x2 = x.reshape(-1, cfg.d_model)
        w, e, _ = moe.router_topk(x2 @ p.router, cfg.top_k)
        naive = torch.zeros_like(x2)
        for j in range(cfg.top_k):
            g = torch.nn.functional.silu(torch.einsum("td,tdf->tf", x2, p.w_gate[e[:, j]]))
            u = torch.einsum("td,tdf->tf", x2, p.w_up[e[:, j]])
            naive = naive + w[:, j:j + 1] * torch.einsum("tf,tfd->td", g * u,
                                                         p.w_down[e[:, j]])
    np.testing.assert_allclose(a.reshape(-1, cfg.d_model).numpy(), naive.numpy(),
                               rtol=1e-5, atol=1e-6)


def _mesh(data, model):
    devs = np.empty(data * model, dtype=object)
    devs[:] = [torch.device("cuda", i) for i in range(data * model)]
    return Mesh(("data", "model"), devs.reshape(data, model))


def test_mesh_info_follows_the_reference_condition():
    """`_mesh_info` shards the experts exactly where the reference's does:
    a MoE config, a model axis > 1 and num_experts divisible by it."""
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    dense = get_config("llama3-8b").reduced()
    mesh = _mesh(2, 2)
    assert _mesh_info(moe_cfg, mesh) == (mesh, ("data",))
    assert _mesh_info(moe_cfg.reduced(), mesh) == (mesh, ("data",))
    # 128 experts do not split over a model axis of 3: the single-shard MoE.
    assert _mesh_info(moe_cfg, _mesh(1, 3)) is None
    for make in (make_prefill_step, make_serve_step):
        bundle = make(moe_cfg, mesh, cache_len=16)
        assert bundle.param_specs["layers"]["moe"]["w_gate"] == (
            None, "model", None, None)
    assert _mesh_info(dense, mesh) is None
    assert _mesh_info(moe_cfg, _mesh(4, 1)) is None
    assert make_plan(mesh).batch_axes == ("data",)
    bundle = make_serve_step(dense, mesh, cache_len=16)
    assert bundle.plan.mesh_shape == {"data": 2, "model": 2}
    assert bundle.param_specs["layers"]["attn"]["wq"] == (None, None, "model", None)


def test_meshes():
    mesh = make_local_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert batch_axes_of(mesh) == ("data",)
    assert mesh.devices[0, 0] == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-780m",
         "--reduced", "--batch", "2", "--prompt-len", "6", "--gen", "3",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert "[serve] batch=2 prefill(6 tok)" in out.stdout
    assert "sample generations" in out.stdout
