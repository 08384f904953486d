#!/usr/bin/env python3
"""Readings that the comparison's limits are set from, on the card.

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--jobs 1]
        [--controls bf16,nopolish,linkcap] [--faults search_unchanged,...]

For each seed it sets the cell up as a run does, runs ``--jobs`` of the
run's own jobs (those after the quality jobs, whose mapping seeds come from
the seed) and prints the comparison's numbers (the lower readings), then for
each control asked for:

* ``bf16``: the plain reference's profile computed in bfloat16, put in the
  program's place and judged against the float32 reference (the LIF's
  configured precision is float32);
* ``nopolish``: the program with the greedy polish switched off
  (``mapper_kwargs={"polish": False}``), which breaks the configuration's
  guarantee of a swap-local optimum;
* ``linkcap``: the program's replay with one more packet a link a cycle
  than the configuration's link capacity.

and for each fault of ``bench/faults.py`` asked for, the same jobs with the
fault planted (the profile made again under it), their numbers and
whether they pass the cell's limits.  One JSON line a seed on standard
output.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def readings(spec, seed: int, jobs: int, controls: list[str], device: str,
             planted: list[str] = ()) -> dict:
    import torch

    import faults
    import harness
    from reference import check

    t0 = time.perf_counter()
    cell = harness.Cell(spec, seed, device)
    first = int(spec.cell["quality_jobs"]) + 1
    indices = range(first, first + jobs)
    done = [cell.job(i) for i in indices]
    t_prog = time.perf_counter() - t0
    want = harness.reference_profile(cell)
    numbers, failed = harness.judge(cell, done, device, want)
    out = {"seed": seed, "program": numbers, "failed": failed,
           "avg_hop": [j["avg_hop"] for j in done],
           "edge_cut": [j["edge_cut"] for j in done],
           "program_s": t_prog}
    if "bf16" in controls:
        low = harness.reference_profile(cell, torch.bfloat16)
        out["bf16"] = check.profile_numbers(
            want, harness.profile_arrays(low), cell.network.num_neurons, device)
    if "nopolish" in controls:
        mix = spec.mix["toolchain"]
        ctl = harness.Cell(spec, seed, device, toolchain_overrides={
            "mapper_kwargs": {**mix.get("mapper_kwargs", {}), "polish": False}},
            profile=cell.profile)
        out["nopolish"], _ = harness.judge(
            ctl, [ctl.job(i) for i in indices], device, want)
    if "linkcap" in controls:
        cap = int(spec.config["platform"]["link_capacity"]) + 1
        ctl = harness.Cell(spec, seed, device, profile=cell.profile,
                           toolchain_overrides={"link_capacity": cap})
        out["linkcap"], _ = harness.judge(
            ctl, [ctl.job(i) for i in indices], device, want)
    limits = spec.cell["limits"]
    for name in planted:
        with faults.Planted(faults.FAULTS[name]):
            ctl = harness.Cell(spec, seed, device)
            nums, failed = harness.judge(
                ctl, [ctl.job(i) for i in indices], device, want)
        out[name] = {"numbers": nums, "failed": failed,
                     "correct": all(nums[k] <= limits[k] for k in limits)}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import harness
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 3
        from repro_torch.kernels import _build

        _build.build_all()
    spec = harness.load_spec(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    planted = [f for f in args.faults.split(",") if f]
    for s in args.seeds.split(","):
        print(json.dumps(readings(spec, int(s), args.jobs, controls,
                                  args.device, planted)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
