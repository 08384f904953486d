#!/usr/bin/env python3
"""The reference's and the port's training steps side by side, on the CPU:
the same weights (the reference's init, PRNGKey(0)) and the same
`SyntheticLMData` batches through the reference's jitted
``value_and_grad`` + ``adamw_update`` and the port's train step, with the
trainer's schedule for ``--steps`` at ``--lr``; prints each step's loss
and grad norm from both.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/train_dynamics.py \\
        --arch mamba2-780m --layers 4 --batch 2 --seq 512 --steps 10

Runs the configuration at its full width in its own dtype (bf16 for the
published configs), cut to ``--layers``.  Like the tests, this imports
both packages; the port itself never imports the reference.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.data import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.interop import model_params_from, opt_state_from
from repro_torch.launch import make_local_mesh, make_train_step
from repro_torch.optim import AdamWConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args()

    rcfg = dataclasses.replace(ref_config(args.arch), num_layers=args.layers)
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    kw = dict(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
              total_steps=args.steps)
    rmodel = RefModel(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    state = ref_adamw.init_opt_state(params)
    model = model_params_from(cfg, jax.tree.map(np.asarray, params), device="cpu")
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

    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    for step in range(args.steps):
        tokens = data.batch(step)["tokens"]
        params, state, loss, stats = ref_step(params, state,
                                              {"tokens": jnp.asarray(tokens)})
        opt_state, metrics = step_fn(model, opt_state,
                                     {"tokens": torch.from_numpy(tokens)})
        print(f"step {step}: reference loss {float(loss):.4f} grad_norm "
              f"{float(stats['grad_norm']):.2f} | port loss "
              f"{float(metrics['loss']):.4f} grad_norm "
              f"{float(metrics['grad_norm']):.2f}", flush=True)


if __name__ == "__main__":
    main()
