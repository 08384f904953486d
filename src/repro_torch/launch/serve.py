"""Batched serving driver: prefill a batch of prompts, then decode.

Uses the prefill/serve steps of `repro_torch.launch.steps`; greedy or
temperature sampling; reports prefill and per-token decode latency:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --batch 4 --prompt-len 32 --gen 32

(``--reduced`` for the smoke-test size, ``--device cpu`` off the card.)

On a mesh of ranks (`repro_torch.launch.mesh.make_rank_mesh`) every rank
calls `serve_batch`: each holds its blocks of the planner's parameter
and cache specs (`repro_torch.sharding.ParamShard`) and the rows of the
batch of its batch-axes coordinate (all of them where they do not
divide), and every rank returns the whole batch's tokens (gathered over
the batch axes) and the collectives it issued.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import batch_axes_of, make_local_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.model import Model, build_model
from repro_torch.sharding.planner import ParamShard, shard_slices

__all__ = ["main", "serve_batch"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, mesh, prompts: np.ndarray, gen_len: int,
                temperature: float = 0.0, seed: int = 0,
                frontend: np.ndarray | None = None, print_fn=print,
                model: Model | None = None, keep_logits: bool = False,
                device: "str | torch.device" = "cuda") -> dict:
    """prompts: (B, P) int32.  Returns generated tokens (B, gen_len).

    ``model`` serves if given (on its own device), else a model of
    ``cfg`` initialized on ``device`` from a ``torch.Generator`` seeded
    with ``seed``.  ``temperature > 0`` samples with ``torch.multinomial``
    on a generator seeded with ``seed + 1``.  ``keep_logits`` adds
    ``"logits"``: (gen_len + 1, B, V) f32 on the host, the prefill's last
    position and then each decode step's.

    On a mesh of ranks ``device`` is this rank's (``mesh.device``), a
    model built here holds the rank's blocks (``ParamShard.of(mesh)``),
    and the rank serves the rows of ``prompts`` (and ``frontend``) of its
    batch-axes coordinate (all of them where they do not divide, as
    ``plan_batch`` replicates them); tokens and logits are gathered back
    over those axes where they were cut, and ``"collectives"`` holds the
    rank's tally (`Mesh.tally`) of the prefill and of the first decode
    step.  The serve step plans as the model was built
    (``model.shard.head_dim_fallback``, `make_serve_step`): to serve with
    the planner's head_dim blocks where the heads do not divide the model
    axis, pass a model built with ``ParamShard.of(mesh,
    head_dim_fallback=True)``.
    """
    ranks = mesh.ranks is not None
    if model is None:
        model = build_model(cfg, mesh.device if ranks else device, seed=seed,
                            shard=ParamShard.of(mesh) if ranks else None)
    dev = model.device
    batch_axes = batch_axes_of(mesh)
    # The prefill step takes the global batch and cuts the rank's rows.
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if frontend is not None:
        batch["frontend"] = torch.as_tensor(frontend, device=dev)
    n_rows = mesh.size(batch_axes) if ranks and batch_axes else 1
    cut = n_rows > 1 and prompts.shape[0] % n_rows == 0
    if cut:
        prompts = prompts[shard_slices((batch_axes,), prompts.shape, mesh.shape,
                                       mesh.coord)[0]]
    b, plen = prompts.shape
    cache_len = plen + gen_len
    prefill = make_prefill_step(cfg, mesh, cache_len=cache_len).jit_for(prompts.shape)
    decode = make_serve_step(
        cfg, mesh, cache_len=cache_len,
        shard_head_dim_fallback=model.shard.head_dim_fallback).jit_for(b)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def pick(last):  # (B, V) -> (B, 1) int32
        if temperature == 0.0:
            return last.argmax(-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

    tally = {}
    mark = mesh.copy_tally()
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tally["prefill"] = mesh.tally_since(mark)

    kept = [logits[:, -1]] if keep_logits else None
    out = np.zeros((b, gen_len), dtype=np.int32)
    tok = pick(logits[:, -1])
    t0 = time.perf_counter()
    for i in range(gen_len):
        out[:, i] = tok[:, 0].cpu().numpy()
        positions = torch.full((b, 1), plen + i, dtype=torch.int32, device=dev)
        mark = mesh.copy_tally()
        logits, caches = decode(model, caches, tok, positions)
        if i == 0:
            tally["decode"] = mesh.tally_since(mark)
        if keep_logits:
            kept.append(logits[:, -1])
        tok = pick(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print_fn(f"[serve] batch={b} prefill({plen} tok) {t_prefill*1e3:.1f} ms; "
             f"decode {gen_len} tok x {t_decode/gen_len*1e3:.1f} ms/tok")
    res = {"tokens": out, "prefill_s": t_prefill,
           "decode_s_per_tok": t_decode / gen_len}
    if keep_logits:
        res["logits"] = torch.stack(kept).float()
    if ranks:
        res["collectives"] = tally
    if cut:  # the batch axes' rows, in their order
        res["tokens"] = mesh.all_gather(torch.as_tensor(out, device=dev),
                                        batch_axes).flatten(0, 1).cpu().numpy()
        if keep_logits:
            res["logits"] = mesh.all_gather(res["logits"], batch_axes).movedim(
                0, 1).flatten(1, 2)
    if keep_logits:
        res["logits"] = res["logits"].cpu()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    mesh = make_local_mesh(device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = rng.standard_normal(
            (args.batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    res = serve_batch(cfg, mesh, prompts, args.gen, temperature=args.temperature,
                      seed=args.seed, frontend=frontend, device=dev)
    print("[serve] sample generations (first 10 tokens per row):")
    for row in res["tokens"][:4]:
        print("  ", row[:10].tolist())


if __name__ == "__main__":
    main()
