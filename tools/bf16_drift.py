#!/usr/bin/env python3
"""How far bf16 rounding moves the model zoo's outputs, in the reference
(``src/repro``, JAX) and the port (``src/repro_torch``), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_drift.py parity
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_drift.py jit
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_drift.py drift \\
        --arch mamba2-780m [--reduced] [--layers N]

  parity  every architecture reduced in bf16, the reference's init
          (PRNGKey(0)) carried into the port: the largest
          |port - eager reference| / max|reference| of the train, prefill
          and decode logits (2 prompts of 12 tokens, then one).
  jit     the reference's bf16 train logits jitted against eager, every
          architecture reduced: how far XLA's own rounding moves them.
  drift   the serving invariant in bf16 (full width, or ``--reduced``;
          ``--layers`` sets the depth): the prefill's last logits and 4
          greedy decode steps' against a train forward over prompt +
          generated tokens, as shares of their max|logit| (as
          ``chip_smoke.py`` measures it), in the reference (jitted) and
          in the port.  Full width needs the model in f32 twice over
          (mamba2-780m: ~7 GB).

Like the tests, this imports both packages; the port itself never imports
the reference.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, get_config as ref_config
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from
from repro_torch.launch import make_local_mesh, serve_batch

BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")


def _rel(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        jnp.asarray(got, jnp.float32))
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def _bf16_tree(name, cfg_ref):
    """The reference's init at PRNGKey(0), cast as a bf16 init casts."""
    f32 = ref_config(name) if cfg_ref is None else cfg_ref
    f32 = dataclasses.replace(f32, param_dtype="float32", activation_dtype="float32")
    key = jax.random.PRNGKey(0)
    params = jax.jit(RefModel(f32).init)(key)
    dtypes = jax.eval_shape(RefModel(dataclasses.replace(f32, **BF16)).init, key)
    return jax.tree.map(lambda a, d: a.astype(d.dtype), params, dtypes)


def _frontend(cfg, rng, b):
    if cfg.family not in ("vlm", "audio"):
        return None
    return rng.standard_normal((b, cfg.frontend_seq, cfg.frontend_dim)).astype(
        np.float32)


def parity() -> None:
    b, s = 2, 12
    for name in ARCHS:
        rcfg = dataclasses.replace(ref_config(name).reduced(), **BF16)
        cfg = dataclasses.replace(get_config(name).reduced(), **BF16)
        params = _bf16_tree(name, ref_config(name).reduced())
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        fe = _frontend(cfg, rng, b)
        rm = RefModel(rcfg)
        jfe = None if fe is None else jnp.asarray(fe, jnp.bfloat16)
        pos = np.full((b, 1), s, np.int32)
        rt, _, _ = rm.forward(params, jnp.asarray(tokens), mode="train", frontend=jfe)
        rp, rc, _ = rm.forward(params, jnp.asarray(tokens[:, :s]), mode="prefill",
                               caches=rm.init_caches(b, s + 1), frontend=jfe)
        rd, _, _ = rm.forward(params, jnp.asarray(tokens[:, s:]), mode="decode",
                              caches=rc, positions=jnp.asarray(pos))
        model = model_params_from(cfg, jax.tree.map(np.asarray, params), device="cpu")
        tt, tfe = torch.from_numpy(tokens), None if fe is None else torch.from_numpy(fe)
        with torch.inference_mode():
            t, _, _ = model(tt, mode="train", frontend=tfe)
            c = model.init_caches(b, s + 1)
            p, c, _ = model(tt[:, :s], mode="prefill", caches=c, frontend=tfe)
            d, _, _ = model(tt[:, s:], mode="decode", caches=c,
                            positions=torch.from_numpy(pos))
        print(f"parity {name}: train {_rel(rt, t):.3e} prefill {_rel(rp, p):.3e} "
              f"decode {_rel(rd, d):.3e} of max|logit|", flush=True)


def jit_vs_eager() -> None:
    for name in ARCHS:
        rcfg = dataclasses.replace(ref_config(name).reduced(), **BF16)
        params = _bf16_tree(name, ref_config(name).reduced())
        rng = np.random.default_rng(0)
        tokens = jnp.asarray(rng.integers(0, rcfg.vocab_size, (2, 13)).astype(np.int32))
        fe = _frontend(rcfg, rng, 2)
        fe = None if fe is None else jnp.asarray(fe, jnp.bfloat16)
        m = RefModel(rcfg)
        eager = m.forward(params, tokens, mode="train", frontend=fe)[0]
        jitted = jax.jit(m.forward, static_argnames=("mode",))(
            params, tokens, mode="train", frontend=fe)[0]
        print(f"jit {name}: jitted vs eager {_rel(eager, jitted):.3e} of max|logit|",
              flush=True)


def drift(name: str, reduced: bool, layers: int | None, b: int = 2,
          plen: int = 32, steps: int = 4) -> None:
    kw = dict(BF16, **({} if layers is None else {"num_layers": layers}))
    rbase, base = ref_config(name), get_config(name)
    if reduced:
        rbase, base = rbase.reduced(), base.reduced()
    rcfg = dataclasses.replace(rbase, **kw)
    cfg = dataclasses.replace(base, **kw)
    params = _bf16_tree(name, rcfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (b, plen)).astype(np.int32)
    # The reference: its serving loop, jitted.
    rm = RefModel(rcfg)
    fwd = jax.jit(rm.forward, static_argnames=("mode",))
    logits, caches, _ = fwd(params, jnp.asarray(prompts), mode="prefill",
                            caches=rm.init_caches(b, plen + steps + 1))
    got, toks = [logits[:, -1]], []
    for i in range(steps):
        tok = got[-1].argmax(-1).reshape(b, 1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, caches, _ = fwd(params, tok, mode="decode", caches=caches,
                                positions=jnp.full((b, 1), plen + i, jnp.int32))
        got.append(logits[:, -1])
    full = fwd(params, jnp.asarray(np.concatenate([prompts] + toks, axis=1)),
               mode="train")[0]
    want = np.asarray(full[:, plen - 1:plen + steps], np.float32)
    scale = np.abs(want).max()
    print(f"drift {cfg.name} ({cfg.num_layers} layers) reference: " + ", ".join(
        f"{np.abs(want[:, i] - np.asarray(got[i], np.float32)).max() / scale:.3e}"
        for i in range(steps + 1)), flush=True)
    del caches, full, logits
    # The port: serve_batch, then the train forward.
    model = model_params_from(cfg, jax.tree.map(np.asarray, params), device="cpu")
    del params
    res = serve_batch(cfg, make_local_mesh(device="cpu"), prompts, steps + 1,
                      model=model, keep_logits=True, print_fn=lambda *_: None)
    seq = torch.from_numpy(np.concatenate([prompts, res["tokens"][:, :steps]], axis=1))
    with torch.inference_mode():
        full_t = model(seq, mode="train")[0].float()
    scale = full_t[:, plen - 1:plen + steps].abs().max()
    print(f"drift {cfg.name} ({cfg.num_layers} layers) port: " + ", ".join(
        f"{float((full_t[:, plen - 1 + i] - res['logits'][i]).abs().max() / scale):.3e}"
        for i in range(steps + 1)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=["parity", "jit", "drift"])
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    if args.what == "parity":
        parity()
    elif args.what == "jit":
        jit_vs_eager()
    else:
        drift(args.arch, args.reduced, args.layers)


if __name__ == "__main__":
    main()
