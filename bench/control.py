#!/usr/bin/env python3
"""Readings that the comparison's limits are set from, on the card.

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--jobs 1]
        [--controls bf16,nopolish,linkcap,replica,unicast]
        [--faults search_unchanged,...]
    python3 bench/control.py --config <file> --mix <file> --cell <file> ...

A cell is a workload of ``BENCHMARK.json``, or a configuration, a traffic
mix and a cell file (``quality_jobs`` and the ``limits`` whose numbers are
read) given as files, so that a deployment can be read at full size before
it has a cell.  For each seed it sets the cell up as a run does, runs
``--jobs`` of the run's own jobs (those after the quality jobs, whose
mapping seeds come from the seed) and prints the comparison's numbers (the
lower readings), the seconds of the set-up, of each job and of the
reference's profile and judgement of each job, then for each control asked
for:

* ``bf16``: the plain reference's profile computed in bfloat16, put in the
  program's place and judged against the float32 reference (the LIF's
  configured precision is float32);
* ``nopolish``: the program with the greedy polish switched off
  (``mapper_kwargs={"polish": False}``), which breaks the configuration's
  guarantee of a swap-local optimum;
* ``linkcap``: the program's replay with one more packet a link a cycle
  than the configuration's link capacity;
* ``replica``: the program's multicast replay with ``engine="ref"``, which
  steps every (firing, destination core) replica on its own: the
  replica-based upper bound that the program documents, in place of the
  tree-fork replay;
* ``unicast``: the program run with ``cast="unicast"`` where the data
  states multicast.

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

    def sync():
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    cell = harness.Cell(spec, seed, device)
    sync()
    setup_s = time.perf_counter() - t0
    first = int(spec.cell["quality_jobs"]) + 1
    indices = range(first, first + jobs)
    done = [cell.job(i) for i in indices]
    t_prog = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = harness.reference_profile(cell)
    sync()
    ref_profile_s = time.perf_counter() - t1
    numbers, failed, judge_s = {}, 0, []
    for job in done:  # one job at a time, to time each judgement
        t1 = time.perf_counter()
        nums, bad = harness.judge(cell, [job], device, want)
        judge_s.append(time.perf_counter() - t1)
        numbers = {k: max(numbers.get(k, 0), v) for k, v in nums.items()}
        failed += bad
    out = {"seed": seed, "program": numbers, "failed": failed,
           "avg_hop": [j["avg_hop"] for j in done],
           "edge_cut": [j["edge_cut"] for j in done],
           "program_s": t_prog, "setup_s": setup_s,
           "job_s": [j["wall_s"] for j in done],
           "reference_profile_s": ref_profile_s, "judge_s": judge_s}
    if "bf16" in controls:
        low = harness.reference_profile(cell, torch.bfloat16)
        out["bf16"] = check.profile_numbers(
            want, harness.profile_arrays(low), cell.network.num_neurons, device)
    overrides = {}
    if "nopolish" in controls:
        overrides["nopolish"] = {"mapper_kwargs": {
            **cell.toolchain.mapper_kwargs, "polish": False}}
    if "linkcap" in controls:
        cap = int(spec.config["platform"]["link_capacity"]) + 1
        overrides["linkcap"] = {"link_capacity": cap}
    if "replica" in controls:
        overrides["replica"] = {"noc_kwargs": {**cell.toolchain.noc_kwargs,
                                               "engine": "ref"}}
    if "unicast" in controls:
        overrides["unicast"] = {"cast": "unicast"}
    for name, over in overrides.items():
        ctl = harness.Cell(spec, seed, device, profile=cell.profile,
                           toolchain_overrides=over)
        out[name], _ = harness.judge(
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
    ap.add_argument("--workload")
    ap.add_argument("--config", help="a configuration file, in place of "
                    "--workload (with --mix and --cell)")
    ap.add_argument("--mix")
    ap.add_argument("--cell")
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
    if args.workload:
        spec = harness.load_spec(args.workload)
    elif args.config and args.mix and args.cell:
        spec = harness.spec_from_files(Path(args.config), Path(args.mix),
                                       Path(args.cell))
    else:
        ap.error("give --workload, or --config, --mix and --cell")
    controls = [c for c in args.controls.split(",") if c]
    planted = [f for f in args.faults.split(",") if f]
    for s in args.seeds.split(","):
        print(json.dumps(readings(spec, int(s), args.jobs, controls,
                                  args.device, planted)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
