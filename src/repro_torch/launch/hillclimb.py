"""Perf hillclimb: count the reference's optimization variants for its
three chosen cells on one H100's roofline, against each cell's baseline in
``results/torch_roofline_raw.jsonl``.

Each record is one hypothesis -> change -> count iteration: `measure_cell`
on the meta device, per chip at the first position of the 16x16 mesh (a
counting mesh: the position's blocks, rows and collectives), terms at
the H100's data-sheet peaks (`repro_torch.launch.roofline`), bounds from
counts, not times.  Every variant counts its own program:
``seq_parallel_decode`` gives the position's caches the planner's blocks
under it (`repro_torch.models.Model.init_caches`), and
``shard_head_dim_fallback`` the position's model the planner's head_dim
blocks (`repro_torch.sharding.ParamShard`).  Tags already in the output
are skipped; names given on the command line count only the variants
whose tags start with one of them:

  python -m repro_torch.launch.hillclimb
  python -m repro_torch.launch.hillclimb hymba.
"""
from __future__ import annotations

import json
from pathlib import Path

from .mesh import make_abstract_mesh
from .roofline import measure_cell, model_flops, roofline_terms, useful_ratio

__all__ = ["VARIANTS", "main"]

OUT = Path("results/torch_perf_iterations.jsonl")

# (tag, arch, shape, config overrides, step kwargs, hypothesis)
VARIANTS = [
    ("ds67b.A1_save_collectives", "deepseek-67b", "train_4k",
     {"remat_policy": "save_collectives"}, {},
     "the backward's recomputation keeps each layer's row-parallel sums "
     "(attention and MLP outputs) instead of issuing them again: per chip "
     "the all-reduce bytes fall by 2 x 95 layers' f32 activations of the "
     "position's rows, the matmul FLOPs by the recomputed wo and w_down "
     "products, and the collective term with them"),
    ("ds67b.A2_no_zero1", "deepseek-67b", "train_4k",
     {"remat_policy": "save_collectives"}, {"zero1": False},
     "without ZeRO-1 each data rank holds the moments of its whole model "
     "block: the optimizer's moment bytes per chip grow 16x, the "
     "gradients' reduce-scatter becomes an all-reduce of the same operand "
     "bytes and the parameters' all-gather goes away"),
    ("qwen3moe.B1_save_collectives", "qwen3-moe-30b-a3b", "train_4k",
     {"remat_policy": "save_collectives"}, {},
     "as A1 for the MoE stack: the recomputation of a MoE layer issues "
     "only its attention's row-parallel sum again (the experts' sum comes "
     "after its last saved tensor), so the all-reduce bytes fall by one "
     "f32 activation a layer and the FLOPs by the wo product's recompute"),
    ("qwen3moe.B2_capacity_1.0", "qwen3-moe-30b-a3b", "train_4k",
     {"remat_policy": "save_collectives", "capacity_factor": 1.0}, {},
     "dispatch buffers scale with capacity; cf 1.25->1.0 should cut the "
     "expert matmul FLOPs and dispatch bytes 20% at the cost of more "
     "dropped tokens"),
    ("hymba.C1_seq_parallel_decode", "hymba-1.5b", "long_500k",
     {}, {"seq_parallel_decode": True},
     "sequence-parallel decode spreads the global-layer KV cache over the "
     "idle batch axes: each chip holds 1/256 of its 524,288 slots instead "
     "of 1/16, so the attention's bytes fall 16x and each global layer "
     "adds its partial softmax's max and sum over all 256 chips"),
    ("hymba.C0_baseline_relower", "hymba-1.5b", "long_500k",
     {}, {"seq_parallel_decode": False},
     "re-count the paper-faithful baseline layout under the current code "
     "as the control for C1"),
    # --- round 2 ---
    ("ds67b.A3_bf16_moments", "deepseek-67b", "train_4k",
     {"remat_policy": "save_collectives"},
     {"zero1": False, "moment_dtype": "bfloat16"},
     "on top of A2, bf16 Adam moments halve the optimizer's moment reads "
     "and writes on the card (4 of the 8 bytes a parameter each for m and "
     "v); the update math stays fp32"),
    ("qwen3moe.B3_bf16_moments", "qwen3-moe-30b-a3b", "train_4k",
     {"remat_policy": "save_collectives", "capacity_factor": 1.0},
     {"moment_dtype": "bfloat16"},
     "same bf16-moment lever on the MoE cell (expert weights dominate "
     "optimizer state)"),
    ("hymba.C2_shard_head_dim", "hymba-1.5b", "long_500k",
     {}, {"seq_parallel_decode": True, "shard_head_dim_fallback": True},
     "sharding the head_dim of the projections whose 25 heads (5 KV heads) "
     "do not divide the model axis: each chip holds 1/16 of the 32 layers' "
     "6.144 M attention parameters (24.6 MB in bf16) instead of all of "
     "them (0.39 GB), so the bytes a decode step counts fall by about "
     "0.37 GB against C1, and the collectives grow by the q/k/v head_dim "
     "gathers and wo's sum over the model axis"),
]


def main(prefixes=()) -> None:
    from repro_torch.configs import get_config

    OUT.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if OUT.exists():
        for line in OUT.read_text().splitlines():
            try:
                done.add(json.loads(line)["tag"])
            except (json.JSONDecodeError, KeyError):
                continue
    for tag, arch, shape, overrides, step_kwargs, hypothesis in VARIANTS:
        if tag in done or (prefixes and not tag.startswith(tuple(prefixes))):
            continue
        print(f"[hillclimb] {tag} ...")
        rec = measure_cell(arch, shape, overrides=overrides or None,
                           step_kwargs=step_kwargs or None, full=False,
                           mesh=make_abstract_mesh())
        rec["tag"] = tag
        rec["hypothesis"] = hypothesis
        if rec["status"] == "ok":
            rec["roofline"] = roofline_terms(rec["counters"])
            rec["useful_ratio"] = useful_ratio(rec, model_flops(get_config(arch),
                                                                shape))
        with OUT.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[hillclimb] {tag}: {rec['status']} {rec.get('roofline', {})}")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
