"""The benchmark of the SNEAP toolchain's PyTorch and CUDA port.

Everything is found by name from ``BENCHMARK.json``: a workload names its
configuration (``bench/configs/<config>.json``: the network, the steps
profiled and the platform), its traffic mix (``bench/mixes/<traffic>.json``:
what one job runs) and its cell file (``bench/cells/<workload>.json``: the
jobs that quality is averaged over and the limits of the comparison); each
metric is a reader in ``bench/metrics/<name>.py``.

A run loads the program, builds the network, profiles it in set-up where
the mix profiles once, runs one warm-up job, and then runs jobs back to
back, closed loop, for ``seconds`` and at least the cell's ``quality_jobs``
(J).  Afterwards the plain reference (``bench/reference``) judges every
answer of the window.  A traced run traces the jobs that start inside the
window; its per-layer metrics read those, and the quality jobs left after
it run untraced.

A configuration's ``platform`` may state ``cast`` (``unicast`` or
``multicast``); where it does not, the cast follows the objective, as the
program's ``ToolchainConfig.resolve`` documents.  The cast so stated is the
one the reference holds every answer to.

A mix says what one job runs, as data: ``entry`` (``run_toolchain``, the
default, or ``run_sweep``), ``toolchain`` (any field of the program's
``ToolchainConfig``, ``method`` and ``cast`` included, over the
configuration's platform), and for ``run_toolchain`` ``run_kwargs``
(``remap_strategy``, ``remap_kwargs``, ``detect_windows``) and
``fault_schedule`` (a list of ``{"t", "kind", "ids"}`` events), for
``run_sweep`` ``grid`` (a list of ``ToolchainConfig`` overrides, one
configuration each).  Every result a job returns is an answer that the
reference judges.

Seeds.  The network, its drive and the mapping seeds of the J quality jobs
come from the configuration's ``input_seed``, so every run averages its
quality over the same J jobs, in the same order; the run's ``--seed`` seeds
the warm-up job and every job after the J.  A job's mapping seed drives the
program's partition, search and polish streams.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

import snngen
import tracing
from reference import check, lif

__all__ = ["ROOT", "Spec", "load_spec", "spec_from_files", "run"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SEED_NET, SEED_DRIVE, SEED_JOB = 1, 2, 3


@dataclass
class Spec:
    workload: str
    config: dict
    mix: dict
    cell: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int
    root: Path = ROOT


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _for(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Spec(
        workload=workload,
        config=_load(root / configs[w["config"]]["file"]),
        mix=_load(root / "bench" / "mixes" / f"{w['traffic']}.json"),
        cell=_load(root / "bench" / "cells" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _for(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _for(m, workload)],
        chips=int(w["chips"]), root=root)


def spec_from_files(config: Path, mix: Path, cell: Path) -> Spec:
    """A cell that ``BENCHMARK.json`` does not hold: its configuration,
    traffic mix and cell file given by path, with no metrics."""
    return Spec(workload=f"{config.stem}.{mix.stem}", config=_load(config),
                mix=_load(mix), cell=_load(cell), end_to_end=[], per_layer=[],
                chips=1)


def load_reader(name: str, root: Path = ROOT):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a metric's reader reads."""

    spec: Spec
    network: snngen.Network
    jobs: list[dict]  # the window's jobs, in order
    window_s: float
    setup_s: float
    peaks: dict
    traces: list = field(default_factory=list)  # tracing.JobTrace per job

    @property
    def quality_jobs(self) -> list[dict]:
        return self.jobs[: int(self.spec.cell["quality_jobs"])]


def _toolchain_config(spec: Spec, device: str):
    """The configuration's platform (its ``cast`` where it states one),
    then the mix's ``toolchain`` block whole, over the program's
    defaults."""
    from repro_torch.core import ToolchainConfig

    plat, tc = spec.config["platform"], dict(spec.mix["toolchain"])
    noc_kwargs = {"inject_capacity": int(plat["inject_capacity"]),
                  **tc.pop("noc_kwargs", {})}
    base = dict(mesh_w=int(plat["mesh_w"]), mesh_h=int(plat["mesh_h"]),
                capacity=int(plat["capacity"]),
                link_capacity=int(plat["link_capacity"]), device=device)
    if "cast" in plat:
        base["cast"] = plat["cast"]
    return ToolchainConfig(**{**base, **tc, "noc_kwargs": noc_kwargs})


def _fault_schedule(events: list[dict]):
    from repro_torch.runtime.faults import FaultEvent, FaultSchedule

    return FaultSchedule([FaultEvent(int(e["t"]), e["kind"], tuple(e["ids"]))
                          for e in events])


def _optional(x, kind):
    return None if x is None else kind(x)


def answer(res, cfg) -> dict:
    """One result of the program, with the platform that the benchmark's
    data (``cfg``) states for it, its cast included, which the reference
    holds it to; ``objective``, ``cast`` and ``place_objective`` are what
    the program reports it ran."""
    return {"part": res.partition.part, "k": int(res.partition.k),
            "edge_cut": int(res.partition.edge_cut),
            "comm_volume": _optional(res.partition.comm_volume, int),
            "placement": np.asarray(res.mapping.placement),
            "avg_hop": float(res.mapping.avg_hop),
            "tree_hop": _optional(res.mapping.tree_hop, float),
            "objective": res.objective, "cast": res.cast,
            "place_objective": res.place_objective,
            "phase_seconds": dict(res.phase_seconds),
            "noc": {f: getattr(res.noc, f) for f in check.NOC_FIELDS},
            "platform": {"mesh_w": cfg.mesh_w, "mesh_h": cfg.mesh_h,
                         "capacity": cfg.capacity,
                         "link_capacity": cfg.link_capacity,
                         "inject_capacity": int(cfg.noc_kwargs.get(
                             "inject_capacity", 256)),
                         "noc_mode": cfg.noc_mode,
                         "cast": cfg.resolve().cast}}


def communicated(a: dict) -> int:
    """Spikes communicated between partitions under the answer's stated
    cast: the cut (unicast) or the connectivity-1 volume (multicast)."""
    if a["platform"]["cast"] == "multicast":
        return a["comm_volume"]
    return a["edge_cut"]


def profile_arrays(prof) -> dict:
    return {"trace_t": prof.trace_t, "trace_src": prof.trace_src,
            "trace_dst": prof.trace_dst, "fire_counts": prof.fire_counts}


class Cell:
    """One cell's inputs and its program, ready to run jobs."""

    def __init__(self, spec: Spec, seed: int, device: str, hooks=None,
                 toolchain_overrides: dict | None = None, profile=None):
        import repro_torch.snn as snn

        self.spec, self.seed, self.device, self.hooks = spec, seed, device, hooks
        self.snn = snn
        cfg = spec.config
        base = int(cfg["input_seed"])
        self.network = snngen.build(cfg["name"], cfg["snn"],
                                    snngen.derive_seed(base, SEED_NET))
        self.drive_seed = snngen.derive_seed(base, SEED_DRIVE)
        self.quality_seeds = [snngen.derive_seed(base, SEED_JOB, j) for j
                              in range(1, int(spec.cell["quality_jobs"]) + 1)]
        net = self.network
        self.topology = snn.SNNTopology(
            name=cfg["name"], layer_sizes=list(net.layers),
            syn_src=net.syn_src, syn_dst=net.syn_dst,
            weights=snngen.dense_weights(net), input_size=net.input_size,
            input_rate=net.input_rate, input_amp=net.input_amp,
            target_spikes=net.target_spikes)
        self.lif = snn.LIFParams(**net.lif)
        # What the data states, and what the program is run with: the two
        # differ only where a control overrides the program.
        self.stated = self.toolchain = _toolchain_config(spec, device)
        if toolchain_overrides:
            self.toolchain = dataclasses.replace(self.toolchain,
                                                 **toolchain_overrides)
        self.profile = None
        if not spec.mix["profile_in_job"]:
            self.profile = profile or self._profile()

    def _profile(self):
        return self.snn.profile_snn(
            self.topology, num_steps=int(self.spec.config["num_steps"]),
            seed=self.drive_seed, params=self.lif, device=self.device)

    def job_seed(self, i: int) -> int:
        """Job 0 warms up; jobs 1 to J are the quality jobs; later jobs
        are the run's own."""
        if 1 <= i <= len(self.quality_seeds):
            return self.quality_seeds[i - 1]
        return snngen.derive_seed(self.seed, SEED_JOB, i)

    def _entry(self, prof, seed: int) -> list[dict]:
        """The mix's entry on ``prof``; one answer a result."""
        mix = self.spec.mix
        entry = mix.get("entry", "run_toolchain")
        cfg = dataclasses.replace(self.toolchain, seed=seed)
        if entry == "run_toolchain":
            from repro_torch.core import run_toolchain

            kwargs = dict(mix.get("run_kwargs", {}))
            if "fault_schedule" in mix:
                kwargs["fault_schedule"] = _fault_schedule(mix["fault_schedule"])
            return [answer(run_toolchain(prof, config=cfg, **kwargs),
                           self.stated)]
        if entry == "run_sweep":
            from repro_torch.launch.sweep import run_sweep

            cfgs = [dataclasses.replace(cfg, **g, seed=snngen.derive_seed(
                seed, n)) for n, g in enumerate(mix["grid"])]
            out = run_sweep(prof, cfgs)
            return [answer(r, dataclasses.replace(self.stated, **g))
                    for r, g in zip(out.results, mix["grid"])]
        raise ValueError(f"unknown entry {entry!r} in the mix")

    def job(self, i: int) -> dict:
        """Job ``i``: the mix's steps, ending with every answer on the host."""
        if self.hooks is not None:
            self.hooks.take_calls()
            before = self.hooks.read_counters()
        rec = {"index": i, "seed": self.job_seed(i)}
        t0 = time.perf_counter()
        prof = self.profile
        if prof is None:
            prof = self._profile()
            rec["profile_s"] = time.perf_counter() - t0
            rec["profile"] = profile_arrays(prof)
        answers = self._entry(prof, rec["seed"])
        rec["wall_s"] = time.perf_counter() - t0
        n = len(answers)
        phases: dict[str, float] = {}
        for a in answers:
            for name, sec in a["phase_seconds"].items():
                phases[name] = phases.get(name, 0.0) + sec
        rec.update(answers=answers, k=answers[0]["k"],
                   edge_cut=sum(communicated(a) for a in answers) / n,
                   avg_hop=sum(a["avg_hop"] for a in answers) / n,
                   phase_seconds=phases)
        if self.hooks is not None:
            after = self.hooks.read_counters()
            rec["launches"] = {k: after[k] - before[k] for k in after}
            rec["calls"] = self.hooks.take_calls()
        return rec


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _number(x):
    return x if isinstance(x, int) else float(x)


def reference_profile(cell: Cell, dtype=None):
    """The plain reference's profile of the cell's network and drive."""
    import torch

    net = cell.network
    drive = snngen.drive(net, int(cell.spec.config["num_steps"]), cell.drive_seed)
    return lif.simulate(net, drive, dtype or torch.float32)


def judge(cell: Cell, jobs: list[dict], device, want=None) -> tuple[dict, int]:
    """The comparison's numbers that the cell's limits name (worst over
    the jobs' answers) and the jobs that failed one.  Runs the plain
    reference from the generated inputs unless its profile ``want`` is
    given."""
    import torch

    spec, net = cell.spec, cell.network
    if want is None:
        want = reference_profile(cell)
    limits = spec.cell["limits"]
    worst = {name: 0 for name in limits}
    failed = 0
    setup_bad = False
    if cell.profile is not None:
        nums = check.profile_numbers(want, profile_arrays(cell.profile),
                                     net.num_neurons, device)
        nums = {k: v for k, v in nums.items() if k in limits}
        worst.update(nums)
        setup_bad = any(v > limits[k] for k, v in nums.items())
    for job in jobs:
        nums = {}
        if "profile" in job:
            nums.update(check.profile_numbers(want, job["profile"],
                                              net.num_neurons, device))
        for a in job["answers"]:
            platform = {**spec.config["platform"], **a["platform"]}
            got = check.job_numbers(net, want, platform, a,
                                    platform["noc_mode"] == "queued", device,
                                    limits)
            for k, v in got.items():
                nums[k] = max(nums.get(k, 0), v)
        nums = {k: v for k, v in nums.items() if k in limits}
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
        failed += setup_bad or any(v > limits[k] for k, v in nums.items())
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    return {k: _number(v) for k, v in worst.items()}, failed


def _metrics(readers: dict, entries: list[dict], ctx: Context) -> dict:
    out = {}
    for m in entries:
        value = readers[m["name"]].read(ctx)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def short_op(name: str) -> str:
    """A device op's name without its template and argument lists."""
    name = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut][:96]


def _breakdown(traces: list) -> dict:
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    for tr in traces:
        for name, s in tr.ops.items():
            ops[short_op(name)] = ops.get(short_op(name), 0.0) + s
        for name, s in tr.gaps():
            gaps[name] = gaps.get(name, 0.0) + s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def run(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log=print) -> dict:
    """One run of a cell; returns the result line's object."""
    import torch

    on_card = device.startswith("cuda")
    if on_card:
        from repro_torch.kernels import _build

        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    names = [m["name"] for m in (spec.per_layer if trace else spec.end_to_end)]
    readers = {n: load_reader(n, spec.root) for n in names}
    hooks = None
    if trace:
        spans = [tuple(e) for n in names for e in getattr(readers[n], "SPANS", [])]
        counters = [tuple(c) for n in names
                    for c in getattr(readers[n], "COUNTERS", [])]
        hooks = tracing.Hooks(spans, counters)
    try:
        cell = Cell(spec, seed, device, hooks)
        cell.job(0)  # warm-up: every shape of the cell's jobs
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")
        need = int(spec.cell["quality_jobs"])
        jobs, traces = [], []
        t0 = time.perf_counter()
        i = 1
        while True:
            # Traced, a job takes several times as long (the profiler's
            # stop and the reading): only the window's jobs are traced,
            # and the quality jobs left after it run untraced.
            if trace and time.perf_counter() - t0 < seconds:
                rec, tr, attempts, parse_s = tracing.traced_job(
                    lambda: cell.job(i))
                rec["trace_attempts"], rec["trace_parse_s"] = attempts, parse_s
                traces.append(tr)
            else:
                rec = cell.job(i)
            jobs.append(rec)
            log(f"job {i}: {rec['wall_s']:.3f} s, k {rec['k']}, cut "
                f"{rec['edge_cut']}, avg_hop {rec['avg_hop']:.6f}, "
                f"phases {json.dumps(rec['phase_seconds'])}"
                + (f", trace read {rec['trace_parse_s']:.2f} s in "
                   f"{rec['trace_attempts']} attempt(s)"
                   if "trace_parse_s" in rec else ""))
            if time.perf_counter() - t0 >= seconds and len(jobs) >= need:
                break
            i += 1
        window_s = time.perf_counter() - t0
    finally:
        if hooks is not None:
            hooks.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": spec.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
                if on_card else 0}
    peaks = _load(spec.root / "bench" / "peaks.json")
    if trace:  # the per-layer metrics read the traced jobs
        jobs_read = [j for j in jobs if "trace_parse_s" in j]
    else:
        jobs_read = jobs
    ctx = Context(spec=spec, network=cell.network, jobs=jobs_read,
                  window_s=window_s, setup_s=setup_s, peaks=peaks,
                  traces=traces)
    metrics = _metrics(readers, spec.per_layer if trace else spec.end_to_end, ctx)
    out = {"attempted": len(jobs), "metrics": metrics, "device": dev_info}
    if trace:
        out["device"]["busy_s"] = sum(t.busy_s for t in traces)
        out["device"]["window_s"] = sum(t.window[1] - t.window[0] for t in traces)
        out["breakdown"] = _breakdown(traces)
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, failed = judge(cell, jobs, device)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    limits = spec.cell["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    out = {"correct": correct, "attempted": out["attempted"], "failed": failed,
           **{k: v for k, v in out.items() if k != "attempted"},
           "checks": {k: {"value": numbers[k], "limit": limits[k]}
                      for k in limits}}
    return out
