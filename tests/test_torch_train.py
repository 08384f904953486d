"""The port's training path against the reference's, on the CPU: the
synthetic data (bitwise), AdamW on identical inputs (new parameters and
moments within rtol 1e-6 / atol 1e-7; grad_norm and lr within rtol 1e-6),
the int8 gradient compression (bitwise on the reference's own noise),
the optimizer-state interop, five train steps against the reference's
unsharded ``value_and_grad`` + ``adamw_update`` composition (jitted), and
the three cases of ``tests/test_train_integration.py`` on the port's
``train_loop``.  All inputs are made from a seed with numpy."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefData  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.interop import (model_params_from, opt_state_from,  # noqa: E402
                                 reference_opt_state, reference_tree)
from repro_torch.launch import make_local_mesh, make_train_step, train_loop  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state  # noqa: E402
from repro_torch.optim.adamw import _quantize, compress_grads  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7  # AdamW on identical inputs
STEP_RTOL = 1e-5  # five train steps: loss, grad_norm, lr
# Five steps' parameter drift from the reference, per leaf, as a share of
# the largest change the reference's own five updates made to that leaf
# (measured: at most 2.7e-3; the gradients agree to ~1e-6 of their max,
# and Adam's normalised update passes that on).
DRIFT = 1e-2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ------------------------------------------------------------------ data

def test_data_deterministic_across_restarts():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=1)
    a = SyntheticLMData(cfg).batch(7)
    b = SyntheticLMData(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_data_sharding_partitions_global_batch():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8, seed=2)
    full = SyntheticLMData(cfg).batch(3)["tokens"]
    parts = []
    for shard in range(4):
        c = DataConfig(vocab_size=100, seq_len=8, global_batch=8, seed=2,
                       num_shards=4, shard=shard)
        parts.append(SyntheticLMData(c).batch(3)["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_repeat_task_is_periodic():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=1, pattern_len=8)
    t = SyntheticLMData(cfg).batch(0)["tokens"][0]
    np.testing.assert_array_equal(t[:8], t[8:16])


@pytest.mark.parametrize("seed,step,shards,shard,task", [
    (0, 0, 1, 0, "repeat"), (3, 17, 1, 0, "uniform"), (5, 2, 4, 3, "repeat"),
    (11, 123, 2, 1, "uniform"), (7, 9, 8, 0, "repeat")])
def test_batch_is_the_references_bitwise(seed, step, shards, shard, task):
    kw = dict(vocab_size=1000, seq_len=37, global_batch=8, seed=seed, task=task,
              pattern_len=5, num_shards=shards, shard=shard)
    got = SyntheticLMData(DataConfig(**kw)).batch(step)["tokens"]
    want = RefData(RefDataConfig(**kw)).batch(step)["tokens"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- AdamW

def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(9)).astype(np.float32),
                  "d": (scale * rng.standard_normal((2, 3, 4))).astype(np.float32)}}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference(param_dtype, moment_dtype):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, 3.0)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    tp = jax.tree.map(lambda x: torch.tensor(x).to(tdt), params)
    # Same initial moments on both sides: the reference's, carried over.
    kw = dict(warmup_steps=3, total_steps=10, moment_dtype=moment_dtype)
    js = ref_adamw.init_opt_state(jp, moment_dtype)
    js = {"m": jax.tree.map(lambda m, g: (0.1 * jnp.asarray(g)).astype(m.dtype),
                            js["m"], grads),
          "v": jax.tree.map(lambda v, g: (0.01 * jnp.asarray(g) ** 2).astype(v.dtype),
                            js["v"], grads),
          "step": jnp.asarray(2, jnp.int32)}
    ts = init_opt_state(tp, moment_dtype)
    for part in ("m", "v"):
        for (_, t), (_, j) in zip(sorted(flat(ts[part]).items()),
                                  sorted(flat(js[part]).items())):
            t.copy_(torch.tensor(np.asarray(j, np.float32)))
    ts["step"] = torch.tensor(2, dtype=torch.int32)
    for step in range(4):
        g = jax.tree.map(lambda x: x * (1 + step), grads)
        jp, js, jstats = ref_adamw.adamw_update(
            jp, jax.tree.map(lambda x: jnp.asarray(x, jdt), g), js,
            ref_adamw.AdamWConfig(**kw))
        tstats = adamw_update(tp, jax.tree.map(lambda x: torch.tensor(x).to(tdt), g),
                              ts, AdamWConfig(**kw))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]), rtol=RTOL)
    for part, (tt, jt) in {"params": (tp, jp), "m": (ts["m"], js["m"]),
                           "v": (ts["v"], js["v"])}.items():
        ft, fj = flat(tt), flat(jt)
        assert set(ft) == set(fj)
        for k in ft:
            assert ft[k].dtype == (tdt if part == "params" else
                                   (torch.bfloat16 if moment_dtype == "bfloat16"
                                    else torch.float32)), (part, k)
            np.testing.assert_allclose(_np(ft[k]), np.asarray(fj[k], np.float32),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{part} {k}")
    assert int(ts["step"]) == int(js["step"]) == 6


def _tiny(get, name="llama3-8b"):
    cfg = get(name).reduced()
    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
              vocab_size=128)
    if "moe" in name:  # tests/test_train_integration.py's MoE config
        kw.update(num_experts=4, moe_d_ff=32)
    else:
        kw.update(d_ff=128)
    return dataclasses.replace(cfg, **kw)


def test_adamw_on_a_model_decays_as_the_reference_stacks():
    """On a Model the decay rule reads the reference's stacked leaf: each
    layer's (d,) norm scale is decayed (an (L, d) leaf), final_norm not."""
    rcfg, cfg = _tiny(ref_config), _tiny(get_config)
    params = jax.tree.map(np.asarray, RefModel(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                         params)
    model = model_params_from(cfg, params, device="cpu")
    state = init_opt_state(model)
    names = {id(p): n for n, p in model.named_parameters()}
    tgrads = {}
    for keys, (_, items) in model.reference_leaves().items():
        g = flat(grads)[keys]
        for index, p in items:
            tgrads[names[id(p)]] = torch.tensor(g[index])
    cfg_kw = dict(warmup_steps=0, total_steps=10, lr=1e-2)
    jp, js, jstats = ref_adamw.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        ref_adamw.init_opt_state(params), ref_adamw.AdamWConfig(**cfg_kw))
    tstats = adamw_update(model, tgrads, state, AdamWConfig(**cfg_kw))
    np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                               rtol=RTOL)
    got, want = flat(reference_tree(model)), flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=str(k))
    ref_state = reference_opt_state(model, state)
    for part in ("m", "v"):
        for k, v in flat(jax.tree.map(np.asarray, js[part])).items():
            np.testing.assert_allclose(flat(ref_state[part])[k].numpy(), v,
                                       rtol=RTOL, atol=ATOL)


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = AdamWConfig(lr=0.2, warmup_steps=0, total_steps=200, weight_decay=0.0,
                      clip_norm=100.0)
    for _ in range(150):
        adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip_applied():
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=10)
    stats = adamw_update(params, {"w": torch.full((3,), 100.0)}, state, cfg)
    assert float(stats["grad_norm"]) > 1.0  # reported pre-clip


def test_quantize_on_the_references_noise_is_bitwise():
    key = jax.random.PRNGKey(0)
    grads = {"a": jax.random.normal(key, (1000,)) * 3,
             "b": jax.random.normal(jax.random.PRNGKey(1), (17, 5))}
    want = ref_adamw.compress_grads(grads, key)
    keys = jax.random.split(key, 2)  # the reference's per-leaf keys
    for (name, g), k in zip(sorted(grads.items()), keys):
        noise = np.asarray(jax.random.uniform(k, g.shape, jnp.float32) - 0.5)
        got = _quantize(torch.tensor(np.asarray(g)), torch.tensor(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]))


def test_compress_grads_small_error_and_unbiased():
    g = {"w": torch.tensor(np.random.default_rng(0).standard_normal(1000)
                           .astype(np.float32))}
    out = compress_grads(g, torch.Generator().manual_seed(0))
    err = (out["w"] - g["w"]).abs().max()
    scale = g["w"].abs().max() / 127
    assert float(err) <= float(scale)  # max error bounded by one quant step
    # stochastic rounding: mean error near zero
    assert abs(float((out["w"] - g["w"]).mean())) < float(scale) / 5


def test_opt_state_round_trips_through_the_reference_tree():
    rcfg, cfg = _tiny(ref_config, "qwen3-moe-30b-a3b"), _tiny(get_config, "qwen3-moe-30b-a3b")
    params = jax.tree.map(np.asarray, RefModel(rcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    ref = {"m": jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                             params),
           "v": jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32), params),
           "step": np.asarray(9, np.int32)}
    model = model_params_from(cfg, params, device="cpu")
    state = opt_state_from(model, ref)
    assert set(state["m"]) == {"/".join(k) for k in model.reference_leaves()}
    back = reference_opt_state(model, state)
    for part in ("m", "v"):
        for k, v in flat(ref[part]).items():
            np.testing.assert_array_equal(flat(back[part])[k].numpy(), v)
    assert int(back["step"]) == 9 and back["step"].dtype == torch.int32


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_train_steps_match_the_reference_composition(name):
    rcfg, cfg = _tiny(ref_config, name), _tiny(get_config, name)
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=20)
    rmodel = RefModel(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, params)
    state = ref_adamw.init_opt_state(params)
    model = model_params_from(cfg, start, device="cpu")
    opt_state = opt_state_from(model, jax.tree.map(np.asarray, state))
    step_fn = make_train_step(cfg, make_local_mesh(device="cpu"),
                              opt=AdamWConfig(**kw)).jit_for(None)

    @jax.jit
    def ref_step(params, state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: rmodel.loss(p, batch), has_aux=True)(params)
        params, state, stats = ref_adamw.adamw_update(
            params, grads, state, ref_adamw.AdamWConfig(**kw))
        return params, state, loss, stats

    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=2))
    for step in range(5):
        tokens = data.batch(step)["tokens"]
        params, state, loss, stats = ref_step(params, state,
                                              {"tokens": jnp.asarray(tokens)})
        opt_state, metrics = step_fn(model, opt_state,
                                     {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=STEP_RTOL)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(stats[k]),
                                       rtol=STEP_RTOL)
        assert set(metrics) == {"loss", "ce", "aux", "grad_norm", "lr"}
        assert all(p.grad is None for p in model.parameters())
    got, want = flat(reference_tree(model)), flat(jax.tree.map(np.asarray, params))
    for k, w in want.items():
        moved = np.abs(w - flat(start)[k]).max()
        drift = np.abs(got[k].numpy() - w).max()
        assert drift <= DRIFT * moved, (k, drift, moved)
    assert int(opt_state["step"]) == int(state["step"]) == 5


# ------------------------------------------------------------ train loop
# tests/test_train_integration.py's three cases, as written there, on the
# port's train_loop.

def test_loss_decreases():
    cfg = _tiny(get_config)
    mesh = make_local_mesh(device="cpu")
    out = train_loop(cfg, mesh, steps=80, batch=4, seq=32, lr=1e-2,
                     log_every=200, print_fn=lambda *_: None)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first * 0.97, (first, last)


def test_checkpoint_restart_bit_exact(tmp_path):
    cfg = _tiny(get_config)
    mesh = make_local_mesh(device="cpu")
    full = train_loop(cfg, mesh, steps=20, batch=2, seq=16, lr=1e-3,
                      log_every=100, print_fn=lambda *_: None)
    train_loop(cfg, mesh, steps=20, batch=2, seq=16, lr=1e-3,
               ckpt_dir=tmp_path, ckpt_every=10, log_every=100, stop_at=10,
               print_fn=lambda *_: None)
    resumed = train_loop(cfg, mesh, steps=20, batch=2, seq=16, lr=1e-3,
                         ckpt_dir=tmp_path, resume=True, log_every=100,
                         print_fn=lambda *_: None)
    assert len(resumed["losses"]) == 10
    assert resumed["losses"] == full["losses"][10:]
    for a, b in zip(jax.tree.leaves(reference_tree(full["model"])),
                    jax.tree.leaves(reference_tree(resumed["model"]))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_moe_trains():
    cfg = _tiny(get_config, "qwen3-moe-30b-a3b")
    mesh = make_local_mesh(device="cpu")
    out = train_loop(cfg, mesh, steps=20, batch=2, seq=32, lr=3e-3,
                     log_every=100, print_fn=lambda *_: None)
    assert np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def test_fail_at_exits_17_after_its_checkpoint(tmp_path):
    cfg = _tiny(get_config)
    with pytest.raises(SystemExit) as exc:
        train_loop(cfg, make_local_mesh(device="cpu"), steps=20, batch=2, seq=16,
                   ckpt_dir=tmp_path, ckpt_every=4, fail_at=6,
                   print_fn=lambda *_: None)
    assert exc.value.code == 17
    from repro_torch.runtime import CheckpointManager
    assert CheckpointManager(tmp_path).latest_step() == 4


def test_train_loop_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(_tiny(get_config), make_local_mesh(), steps=1, batch=1, seq=4)
