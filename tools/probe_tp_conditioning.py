#!/usr/bin/env python3
"""How far a random Mamba-2's f32 gradients move under one rounding, beside
how far the tensor-parallel ranks' gradients sit from the unsharded ones.

    PYTHONPATH=src python3 tools/probe_tp_conditioning.py [--layers 2 4]

On the CPU: mamba2-780m with d_model 768 (d_inner 1536, 24 heads of 64,
state 128), vocab 4,096, f32, from seed 0, one batch of 4 x 128 tokens.
For each depth it prints the relative change of the gradient norm and
the largest relative L2 change of a leaf's gradient

* ``perturbed``: the unsharded model with one leaf (layer 0's
  ``out_proj``) times 1 + 1e-7 x a standard normal: the model's own
  sensitivity to a change of the size of one rounding;
* ``(1, n)``: each rank of a (1, n) gloo mesh (``run_ranks``), its
  gradients' blocks against the unsharded model's, and the gradient norm
  summed over the ranks as `adamw_update` sums it.

Where the ranks read no further from the unsharded model than the
perturbed model does, the sharded program is as exact as the model's
conditioning lets any other order of sums be.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.interop import rank_model_from, reference_tree
from repro_torch.launch.mesh import make_rank_mesh, run_ranks
from repro_torch.models import build_model

BATCH, SEQ = 4, 128


def config(layers: int):
    return dataclasses.replace(get_config("mamba2-780m"), num_layers=layers,
                               d_model=768, vocab_size=4096,
                               param_dtype="float32", activation_dtype="float32")


def tokens() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 4096, (BATCH, SEQ)).astype(np.int32)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def grads(model, mesh=None) -> dict:
    model.requires_grad_(True)
    info = (mesh, ("data",)) if mesh is not None else None
    loss, _ = model.loss({"tokens": torch.from_numpy(tokens())}, mesh_info=info)
    loss.backward()
    return {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def rank_body(layers: int, tree: dict, shape: tuple) -> dict:
    """One rank's gradients and the blocks it holds."""
    mesh = make_rank_mesh(shape, device="cpu")
    model = rank_model_from(config(layers), tree, mesh)
    return {"grads": grads(model, mesh), "blocks": dict(model.blocks)}


def compare(want: dict, got: dict, blocks: dict | None = None) -> float:
    worst = 0.0
    for name, w in want.items():
        if blocks and name in blocks:
            w = w[blocks[name][1]]
        g = got[name]
        worst = max(worst, float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-300)))
    return worst


def norm(gs: dict) -> float:
    return sum(float((g * g).sum()) for g in gs.values()) ** 0.5


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    args = ap.parse_args()
    for layers in args.layers:
        cfg = config(layers)
        want = grads(build_model(cfg, "cpu", seed=0))
        moved = build_model(cfg, "cpu", seed=0)
        with torch.no_grad():
            w = moved.layers[0].mamba.out_proj
            gen = torch.Generator().manual_seed(5)
            w.mul_(1 + 1e-7 * torch.randn(w.shape, generator=gen))
        moved = grads(moved)
        print(f"{layers} layers, perturbed: gradient norm "
              f"{abs(norm(moved) - norm(want)) / norm(want):.3e}, worst leaf "
              f"{compare(want, moved):.3e}")
        tree = _numpy(reference_tree(build_model(cfg, "cpu", seed=0)))
        for n in args.ranks:
            with tempfile.TemporaryDirectory() as store:
                got = run_ranks(rank_body, n, store, layers, tree, (1, n),
                                device="cpu")
            sq = 0.0
            for i, r in enumerate(got):  # split leaves summed, replicated once
                sq += sum(float((g * g).sum()) for name, g in r["grads"].items()
                          if name in r["blocks"] or i == 0)
            worst = max(compare(want, r["grads"], r["blocks"]) for r in got)
            print(f"{layers} layers, (1, {n}): gradient norm "
                  f"{abs(sq ** 0.5 - norm(want)) / norm(want):.3e}, worst leaf "
                  f"{worst:.3e}")


if __name__ == "__main__":
    main()
