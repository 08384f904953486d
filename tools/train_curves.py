#!/usr/bin/env python3
"""Loss curves of the port's `train_loop` on the card, one JSON line a run.

    python3 tools/train_curves.py [--arch mamba2-780m] [--layers N] \\
        [--steps 10 20 40] [--dtype bfloat16] [--repeat]

Each run trains ``--arch`` at full width (``--layers`` cuts the depth)
from seed 0 on the repeat task, 8 x 512 tokens, lr 3e-4 with the
trainer's schedule for its step count, remat on, and prints its losses,
grad norms, the means of the first and last 5 losses and its seconds.
``--repeat`` runs the first step count twice (the losses must repeat
bitwise).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--layers", type=int)
    ap.add_argument("--steps", type=int, nargs="+", default=[10, 20, 40])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--repeat", action="store_true")
    args = ap.parse_args()

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_local_mesh, train_loop

    mesh = make_local_mesh(device="cuda")
    cfg = dataclasses.replace(get_config(args.arch), param_dtype=args.dtype,
                              activation_dtype=args.dtype)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    steps = ([args.steps[0]] if args.repeat else []) + args.steps
    for n in steps:
        t0 = time.perf_counter()
        out = train_loop(cfg, mesh, steps=n, batch=8, seq=512, lr=3e-4, seed=0,
                         remat=True, print_fn=lambda *_: None)
        losses = out["losses"]
        print(json.dumps({"arch": args.arch, "layers": cfg.num_layers, "steps": n,
                          "dtype": args.dtype,
                          "first5": sum(losses[:5]) / 5, "last5": sum(losses[-5:]) / 5,
                          "losses": losses, "grad_norms": out["grad_norms"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
