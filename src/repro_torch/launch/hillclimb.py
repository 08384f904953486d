"""Perf hillclimb: count the reference's optimization variants for its
three chosen cells on one H100's roofline, against each cell's baseline in
``results/torch_roofline_raw.jsonl``.

Each record is one hypothesis -> change -> count iteration: `measure_cell`
on the meta device, terms at the H100's data-sheet peaks
(`repro_torch.launch.roofline`), bounds from counts, not times.  The
counts are of the unsharded step on one card, so a variant that changes
only the sharding plan (``zero1``, ``seq_parallel_decode``,
``shard_head_dim_fallback``) counts what its baseline counts; its record
says so (``plan_only``) instead of reporting a difference.

  python -m repro_torch.launch.hillclimb
"""
from __future__ import annotations

import json
from pathlib import Path

from .roofline import measure_cell, model_flops, roofline_terms

__all__ = ["VARIANTS", "PLAN_ONLY_KWARGS", "main"]

OUT = Path("results/torch_perf_iterations.jsonl")

# Step kwargs that change only the sharding plan, never the one-card step.
PLAN_ONLY_KWARGS = frozenset({"zero1", "seq_parallel_decode",
                              "shard_head_dim_fallback"})

# (tag, arch, shape, config overrides, step kwargs, hypothesis)
VARIANTS = [
    ("ds67b.A1_save_collectives", "deepseek-67b", "train_4k",
     {"remat_policy": "save_collectives"}, {},
     "the reference saves the tensor-parallel collectives' outputs from the "
     "backward recompute; one card has no collective, so the port "
     "recomputes everything, as 'full' does: the counts should equal the "
     "baseline's"),
    ("ds67b.A2_no_zero1", "deepseek-67b", "train_4k",
     {"remat_policy": "save_collectives"}, {"zero1": False},
     "ZeRO-1 shards the optimizer state over the data axes; replicating it "
     "changes the plan only, so the one-card counts should equal A1's"),
    ("qwen3moe.B1_save_collectives", "qwen3-moe-30b-a3b", "train_4k",
     {"remat_policy": "save_collectives"}, {},
     "same as A1 for the MoE stack: no collective to save on one card, so "
     "the counts should equal the baseline's"),
    ("qwen3moe.B2_capacity_1.0", "qwen3-moe-30b-a3b", "train_4k",
     {"remat_policy": "save_collectives", "capacity_factor": 1.0}, {},
     "dispatch buffers scale with capacity; cf 1.25->1.0 should cut the "
     "expert matmul FLOPs and dispatch bytes 20% at the cost of more "
     "dropped tokens"),
    ("hymba.C1_seq_parallel_decode", "hymba-1.5b", "long_500k",
     {}, {"seq_parallel_decode": True},
     "sequence-parallel decode spreads the global-layer KV cache over the "
     "idle batch axes; a plan change only, so on one card the counts "
     "should equal the baseline's"),
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
     "sharding the head_dim of the projections whose 25 heads do not "
     "divide the model axis changes the plan only: one card reads every "
     "projection whole, so the counts should equal C1's"),
]


def main() -> None:
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
        if tag in done:
            continue
        print(f"[hillclimb] {tag} ...")
        rec = measure_cell(arch, shape, overrides=overrides or None,
                           step_kwargs=step_kwargs or None, full=False)
        rec["tag"] = tag
        rec["hypothesis"] = hypothesis
        rec["plan_only"] = sorted(set(step_kwargs) & PLAN_ONLY_KWARGS)
        if rec["status"] == "ok":
            rec["roofline"] = roofline_terms(rec["counters"])
            mf = model_flops(get_config(arch), shape)
            flops = rec["counters"]["flops"]
            rec["useful_ratio"] = mf / flops if flops else None
        with OUT.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[hillclimb] {tag}: {rec['status']} {rec.get('roofline', {})}"
              + (f"; {', '.join(rec['plan_only'])} change the plan only, not "
                 "the one-card counts" if rec["plan_only"] else ""))


if __name__ == "__main__":
    main()
