"""Fault-tolerant training loop.

Runs any --arch (full or --reduced) on the local mesh with the eager
train step (`repro_torch.launch.steps.make_train_step`):
checkpoint/restart (atomic, async), deterministic data resume, straggler
bookkeeping, and optional failure injection (--fail-at) to demonstrate
recovery:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --ckpt-every 50
  # simulate a node failure and restart:
  PYTHONPATH=src python -m repro_torch.launch.train ... --fail-at 120
  PYTHONPATH=src python -m repro_torch.launch.train ... --resume

It runs on the card unless ``--device cpu`` is given.  A checkpoint holds
the reference's tree, ``(params, opt_state)`` with the parameters and
moments stacked per layer (`repro_torch.interop.reference_tree`,
`reference_opt_state`), so that either package resumes the other's.

On a mesh of ranks (`repro_torch.launch.mesh.make_rank_mesh`, inside a
`run_ranks` job) every rank runs `train_loop`: its model holds its
position's blocks, each step it takes its rows of the same global batch,
and every rank logs the same loss.  A checkpoint is the same whole tree
on every mesh: every rank takes part in gathering it leaf by leaf
(`repro_torch.interop.reference_state`; the collectives and the copies to
the host run in the step, only the file write in ``save_async``'s
thread), and the rank at the mesh's all-zero coordinate writes it.  On
resume every rank reads the committed step and cuts its own blocks
(`repro_torch.interop.rank_state_from`), so a checkpoint written on one
mesh resumes on any other, or on one card.  Every exit of `train_loop`
waits for the writer's file and then for the mesh's ranks (a barrier),
so a resume called straight after it reads the same step on every rank.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.interop import rank_state_from, reference_state, state_template
from repro_torch.launch.mesh import Mesh, batch_axes_of, make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import CheckpointManager, HeartbeatMonitor
from repro_torch.sharding import ParamShard

__all__ = ["main", "train_loop"]


def train_loop(cfg, mesh: Mesh, steps: int, batch: int, seq: int, ckpt_dir=None,
               ckpt_every: int = 50, resume: bool = False, fail_at: int | None = None,
               lr: float = 3e-4, log_every: int = 10, seed: int = 0,
               remat: bool = False, stop_at: int | None = None,
               print_fn=print, model: Model | None = None) -> dict:
    """`steps` fixes the LR schedule; `stop_at` halts early (clean), so a
    stopped-then-resumed run sees the identical schedule as a straight run.

    Trains on the mesh's device ``model`` (default: `build_model` from
    ``seed`` there), whose parameters it updates in place.  Returns
    {"losses", "final_loss", "seconds", "model", "opt_state"} — the
    reference returns its params; `repro_torch.interop.reference_tree`
    gives them — and each step's "grad_norms" and "step_seconds" (host
    clock around the step and its loss read back, which waits for the
    card), and "checkpoint_seconds": each save's gather and host copy
    (``gather``, the part the step waits for), each file write of this
    process (``write``, the writer's thread) and the restore
    (``restore``).  On a mesh of ranks the device is the rank's, the
    model holds its blocks and every rank saves and restores (module
    docstring)."""
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5), total_steps=steps)
    bundle = make_train_step(cfg, mesh, opt=opt_cfg, remat=remat, zero1=False)
    ranks = mesh.ranks is not None
    device = mesh.device if ranks else mesh.devices.flat[0]
    shard = ParamShard.of(mesh) if ranks else None
    minfo = (mesh, batch_axes_of(mesh)) if ranks else None
    writer = not ranks or mesh.coord == dict.fromkeys(mesh.axis_names, 0)

    data = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))

    if model is None:
        model = build_model(cfg, device, seed=seed, shard=shard)
    opt_state = bundle.init_opt(model)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    ckpt_seconds = {"gather": [], "restore": None,
                    "write": mgr.write_seconds if mgr is not None else []}
    if resume and mgr is not None and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        state, start_step = mgr.restore(state_template(model))
        opt_state = rank_state_from(model, state, minfo)
        ckpt_seconds["restore"] = time.perf_counter() - t0
        print_fn(f"[train] resumed from step {start_step}")

    def make_batch(step):
        b = data.batch(step)
        if cfg.family in ("vlm", "audio"):
            rng = np.random.default_rng(seed * 7919 + step)
            b["frontend"] = rng.standard_normal(
                (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
        return b

    def on_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def save(step):
        """Every rank gathers; the writer writes (its thread)."""
        t0 = time.perf_counter()
        tree = reference_state(model, opt_state, minfo, keep=writer)
        ckpt_seconds["gather"].append(time.perf_counter() - t0)
        if writer:
            mgr.save_async(step, tree)

    def settle():
        """The writer's file is committed before any rank returns."""
        mgr.wait()
        group = mesh.groups.get(mesh.axis_names) if ranks else None
        if group is not None:
            dist.barrier(group=group)

    step_fn = bundle.jit_for(make_batch(0))
    monitor = HeartbeatMonitor(num_hosts=1)
    losses, grad_norms, step_seconds = [], [], []

    def result():
        return {"losses": losses, "final_loss": losses[-1] if losses else None,
                "seconds": time.perf_counter() - t_start, "model": model,
                "opt_state": opt_state, "grad_norms": grad_norms,
                "step_seconds": step_seconds, "checkpoint_seconds": ckpt_seconds}

    t_start = time.perf_counter()
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        opt_state, metrics = step_fn(model, opt_state, on_device(make_batch(step)))
        loss = float(metrics["loss"])
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        step_seconds.append(time.perf_counter() - t0)
        monitor.report(0, step, step_seconds[-1])
        if step % log_every == 0 or step == steps - 1:
            print_fn(f"[train] step {step:5d} loss {loss:8.4f} "
                     f"lr {float(metrics['lr']):.2e} "
                     f"gnorm {grad_norms[-1]:8.3f} "
                     f"({time.perf_counter() - t0:.2f}s/step)")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            save(step + 1)
        if stop_at is not None and step + 1 >= stop_at:
            if mgr:
                settle()
            return result()
        if fail_at is not None and step + 1 >= fail_at:
            print_fn(f"[train] simulated failure at step {step + 1} — restart "
                     "with --resume")
            if mgr:
                settle()
            sys.exit(17)
    if mgr is not None:
        # The last step's state, unless its save came from ckpt_every (or
        # it was restored): every rank decides alike, as all gather.
        if start_step < steps and steps % ckpt_every:
            save(steps)
        settle()
    return result()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_local_mesh(device=args.device)
    out = train_loop(cfg, mesh, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume, fail_at=args.fail_at, lr=args.lr,
                     remat=args.remat, seed=args.seed)
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"in {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
