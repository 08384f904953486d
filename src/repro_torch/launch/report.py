"""Tables of the dry run, the roofline and the hillclimb from the port's
result ledgers (``results/torch_*.jsonl``), at the H100's data-sheet peaks.

Every time in them is a bound from counts of one position of the
production mesh (per chip, its collectives' bytes over NVLink's rate for
the collective term) or of the unsharded one-card step, not a measured
time.

  python -m repro_torch.launch.report [dryrun|roofline|perf|all]
"""
from __future__ import annotations

import json
from pathlib import Path

from .roofline import (H100_HBM_BYTES, bound_mfu, model_flops,
                       roofline_terms, useful_ratio)

__all__ = ["load_jsonl", "dryrun_table", "roofline_table", "perf_table"]

DRYRUN = "results/torch_dryrun.jsonl"
ROOFLINE = "results/torch_roofline_raw.jsonl"
PERF = "results/torch_perf_iterations.jsonl"


def load_jsonl(path, key=None) -> dict:
    out = {}
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        k = key(r) if key else (r.get("arch"), r.get("shape"), r.get("mesh"))
        out[k] = r  # last record wins
    return out


def dryrun_table(path=DRYRUN) -> str:
    cells = load_jsonl(path)
    rows = ["| arch | shape | mesh | status | count s | args GB/device | "
            "args GB one card | peak GB one card | fits one 80 GB card | "
            "FLOPs per chip x chips / one card | notes |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(cells.items()):
        if r["status"] == "skip":
            rows.append(f"| {arch} | {shape} | {mesh} | SKIP | — | — | — | — | — | "
                        f"— | {r['reason'][:60]} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | {mesh} | ERROR | — | — | — | — | — | "
                        f"— | {r.get('error', '')[:60]} |")
            continue
        one = r.get("cost_one_card", {}).get("flops")
        split = (f"{r['cost']['flops'] * r['chips'] / one:.3f}"
                 if one and "chips" in r else "—")
        mem = r["memory"]
        peak = mem["peak_live_bytes"]
        note = (r.get("plan_notes") or [""])[0][:40]
        rows.append(f"| {arch} | {shape} | {mesh} | OK | {r['count_s']:.1f} | "
                    f"{mem['argument_size_in_bytes'] / 1e9:.2f} | "
                    f"{mem['argument_size_in_bytes_one_card'] / 1e9:.2f} | "
                    f"{peak / 1e9:.2f} | {'yes' if peak <= H100_HBM_BYTES else 'no'} | "
                    f"{split} | {note} |")
    return "\n".join(rows)


def roofline_table(path=ROOFLINE) -> str:
    from repro_torch.configs import get_config

    cells = load_jsonl(path, key=lambda r: (r.get("arch"), r.get("shape")))
    rows = ["| arch | shape | compute s | memory s | collective s | dominant | "
            "6ND/counted | roofline frac | what moves the dominant term |",
            "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        "train": "fused optimizer and elementwise work around the matmuls; bf16 moments",
        "prefill": "bf16 attention products; fewer chunk temporaries; fused QKV",
        "decode": "fewer per-layer casts and copies; quantized KV cache; multi-token decode",
    }
    out = []
    for (arch, shape), r in cells.items():
        if r["status"] != "ok":
            continue
        c = r["counters"]
        rt = roofline_terms(c)
        cfg = get_config(arch)
        mf = model_flops(cfg, shape)
        ratio = useful_ratio(r, mf)
        ratio = float("nan") if ratio is None else ratio
        frac = bound_mfu(r, mf, rt)
        kind = ("train" if shape.startswith("train") else
                "prefill" if shape.startswith("prefill") else "decode")
        out.append((frac, f"| {arch} | {shape} | {rt['compute_s']:.4g} | "
                    f"{rt['memory_s']:.4g} | {rt['collective_s']:.3g} | "
                    f"{rt['dominant'].replace('_s', '')} | {ratio:.3f} | "
                    f"{frac:.4f} | {hints[kind]} |"))
    for _, row in sorted(out, reverse=True):
        rows.append(row)
    for (arch, shape), r in sorted(cells.items()):
        if r["status"] == "skip":
            rows.append(f"| {arch} | {shape} | — | — | — | — | — | SKIP | "
                        f"{r['reason'][:70]} |")
    return "\n".join(rows)


def perf_table(path=PERF, baseline=ROOFLINE) -> str:
    recs = load_jsonl(path, key=lambda r: r.get("tag"))
    base = load_jsonl(baseline, key=lambda r: (r.get("arch"), r.get("shape")))
    rows = ["| iteration | compute s | memory s | collective s | 6ND/counted | "
            "verdict vs hypothesis |",
            "|---|---|---|---|---|---|"]
    for (arch, shape) in [("deepseek-67b", "train_4k"),
                          ("qwen3-moe-30b-a3b", "train_4k"),
                          ("hymba-1.5b", "long_500k")]:
        b = base.get((arch, shape))
        if b and b.get("roofline"):
            rt = b["roofline"]
            rows.append(f"| **{arch} × {shape} baseline** | {rt['compute_s']:.4g} | "
                        f"{rt['memory_s']:.4g} | {rt['collective_s']:.4g} | "
                        f"{b.get('useful_ratio') or 0:.3f} | paper-faithful |")
        for tag, r in sorted(recs.items()):
            if r.get("arch") == arch and r.get("shape") == shape \
                    and r.get("status") == "ok":
                rt = r["roofline"]
                verdict = "see PERF.md §6"
                rows.append(f"| {tag} | {rt['compute_s']:.4g} | {rt['memory_s']:.4g} | "
                            f"{rt['collective_s']:.4g} | {r.get('useful_ratio') or 0:.3f} | "
                            f"{verdict} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("dryrun", "all"):
        print("## Dry run\n")
        print(dryrun_table())
    if which in ("roofline", "all"):
        print("\n## Roofline\n")
        print(roofline_table())
    if which in ("perf", "all"):
        print("\n## Perf\n")
        print(perf_table())
