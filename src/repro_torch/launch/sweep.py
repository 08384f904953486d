"""Batched toolchain sweeps (design-space exploration).

The production question is rarely "run the toolchain once" but "which
(k, mesh, objective, mapper, seed) is best for this workload".
`run_sweep` executes a whole `ToolchainConfig` grid over one or more
profiled SNNs through the *same* phase functions as
`repro_torch.core.run_toolchain` (`partition_phase` / `mapping_phase` /
`evaluate_phase`), so every sweep row carries bitwise the stats of the
corresponding single run, while the driver saves wall clock two ways:

  * **phase dedup** — configs agreeing on the partition-relevant knobs
    share one partitioning run (`ToolchainConfig.partition_key`), one
    traffic matrix (`traffic_key`), and one placement-objective build;
  * **device batching** — same-shape ``mapper="sa_jax"`` configs on one
    device are stacked into one device program
    (`repro_torch.core.mapping_device.sa_search_jax_batch`: each
    temperature epoch of the whole bucket is one CUDA graph on the card),
    advancing every config's chain population in lock-step; element i is
    bitwise the single search.

The grid can also carry engine-threshold overrides
(``knobs={"_KERNEL_MAX_N": ...}``, ``score_backend``, ``stepper``,
``screen``) and ``device``, a `ToolchainConfig` field like any other.

Per workload the report flags the Pareto front over
(energy_pj, avg_latency, total_s) — minimum energy, minimum replay
latency, minimum toolchain seconds — the three axes the SNEAP paper
trades.  A port of the reference's `repro.launch.sweep`.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field

import numpy as np

from repro_torch import spans
from repro_torch.core.mapping import OBJECTIVE_AWARE_MAPPERS
from repro_torch.core.mapping_device import sa_search_jax_batch
from repro_torch.core.pipeline import (
    ToolchainConfig,
    ToolchainResult,
    build_traffic,
    evaluate_phase,
    mapping_phase,
    partition_phase,
    phase_seeds,
)
from repro_torch.core.placecost import evaluate_placement, make_objective

__all__ = ["config_grid", "run_sweep", "pareto_flags", "SweepResult"]

PARETO_KEYS = ("energy_pj", "avg_latency", "total_s")

# Grid axes that are not ToolchainConfig fields but sugar over its dicts.
_MAPPER_KW_AXES = ("score_backend",)
_NOC_KW_AXES = ("stepper", "screen")


def config_grid(**axes) -> list[ToolchainConfig]:
    """Cartesian product of config axes -> list of `ToolchainConfig`.

    Each axis value may be a list (swept) or a scalar (fixed).  Axis names
    are `ToolchainConfig` field names plus sugar: ``mesh`` takes
    ``(mesh_w, mesh_h)`` tuples, ``score_backend`` lands in
    ``mapper_kwargs``, ``stepper``/``screen`` in ``noc_kwargs``.  Order is
    deterministic (row-major over the axes as given).

        config_grid(mesh=[(8, 8), (16, 16)], seed=[0, 1, 2],
                    objective=["cut", "volume"], mapper="sa_jax")
    """
    fields = {f.name for f in dataclasses.fields(ToolchainConfig)}
    for name in axes:
        if name != "mesh" and name not in _MAPPER_KW_AXES \
                and name not in _NOC_KW_AXES and name not in fields:
            raise ValueError(f"unknown sweep axis {name!r}")
    names = list(axes)
    lists = [v if isinstance(v, (list, tuple)) else [v] for v in axes.values()]
    out = []
    for combo in itertools.product(*lists):
        kw: dict = {}
        mk: dict = {}
        nk: dict = {}
        for name, value in zip(names, combo):
            if name == "mesh":
                kw["mesh_w"], kw["mesh_h"] = value
            elif name in _MAPPER_KW_AXES:
                mk[name] = value
            elif name in _NOC_KW_AXES:
                nk[name] = value
            elif name == "mapper_kwargs":
                mk.update(value)
            elif name == "noc_kwargs":
                nk.update(value)
            else:
                kw[name] = value
        out.append(ToolchainConfig(mapper_kwargs=mk, noc_kwargs=nk, **kw))
    return out


def pareto_flags(rows: list[dict], keys: tuple = PARETO_KEYS) -> list[bool]:
    """Non-dominated flags (minimization on every key) for one workload."""
    vals = [tuple(float(r[k]) for k in keys) for r in rows]
    flags = [True] * len(rows)
    for i, a in enumerate(vals):
        for b in vals:
            if b != a and all(y <= x for x, y in zip(a, b)):
                flags[i] = False
                break
        else:
            # Duplicate points dominate each other under strict `!=` only;
            # equal rows are all kept on the front.
            continue
    return flags


@dataclass
class SweepResult:
    """All sweep rows plus the grid-level wall clock.

    ``rows`` holds one dict per (workload, config): the run's
    `ToolchainResult.summary()` stats (bitwise those of the matching
    single `run_toolchain` call) plus the config axes and a ``pareto``
    flag computed per workload over `PARETO_KEYS`.  Shared-phase seconds
    are amortized over the configs that shared them, so summing
    ``total_s`` over rows reproduces the sweep's real compute.
    ``results`` holds each row's `ToolchainResult` (partition, placement,
    NoC stats), in row order — a port addition, for callers that check
    placements rather than stats.
    """

    rows: list[dict] = field(default_factory=list)
    seconds: float = 0.0
    pareto_keys: tuple = PARETO_KEYS
    results: list = field(default_factory=list)

    def front(self, workload: str | None = None) -> list[dict]:
        return [r for r in self.rows
                if r["pareto"] and workload in (None, r["snn"])]

    def write_csv(self, path) -> None:
        import csv

        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(self.rows[0]))
            writer.writeheader()
            writer.writerows(self.rows)


def _bucketable(cfg: ToolchainConfig) -> bool:
    """True when the config's search can join a batched sa_jax bucket."""
    return (cfg.method == "sneap" and cfg.mapper == "sa_jax"
            and "objective" not in cfg.mapper_kwargs)


def run_sweep(
    profiles,
    configs: list[ToolchainConfig],
    batch_device: bool = True,
    pareto_keys: tuple = PARETO_KEYS,
    progress=None,
) -> SweepResult:
    """Run a config grid over profiled SNN workload(s); see module docstring.

    ``profiles`` is one `ProfileResult` or a list; ``configs`` typically
    comes from `config_grid`.  ``batch_device=False`` disables the batched
    sa_jax bucketing (each search then runs through `mapping_phase` like
    any host mapper — useful for parity diffs).  ``progress`` is an
    optional callable receiving short status strings.
    """
    if not isinstance(profiles, (list, tuple)):
        profiles = [profiles]
    say = progress if progress is not None else (lambda msg: None)
    all_rows: list[dict] = []
    all_results: list[ToolchainResult] = []

    # The root span of the sweep's steps; a row's phase seconds are its
    # phase spans' own clock reads.
    with spans.phase("sneap.sweep", configs=len(configs)) as root:
        for profile in profiles:
            hyper = profile.graph.hyper
            cfgs = [c.resolve(hyper) for c in configs]
            n = len(cfgs)

            # -- partition phase, deduplicated --------------------------------
            # parts: partition_key -> [PartitionResult, seconds, share_count]
            parts: dict = {}
            for c in cfgs:
                key = c.partition_key()
                if key not in parts:
                    with spans.phase("sneap.partition") as ph:
                        pres = partition_phase(profile, c)
                    parts[key] = [pres, ph.seconds, 0]
                parts[key][2] += 1
            say(f"{profile.name}: {len(parts)} partition runs for {n} configs")

            # -- shared traffic matrices and placement objectives --------------
            traffics: dict = {}
            for c in cfgs:
                tk = c.traffic_key()
                if tk not in traffics:
                    traffics[tk] = build_traffic(
                        profile, parts[c.partition_key()][0], c)
            objectives: dict = {}

            # -- mapping phase: device buckets + host singles ------------------
            # mapping_out[i] = (mres, place_objective, traffic, trace_len, sec)
            mapping_out: list = [None] * n
            buckets: dict = {}
            for i, c in enumerate(cfgs):
                if batch_device and _bucketable(c):
                    bkey = (c.num_cores, c.mesh_w,
                            tuple(sorted(c.mapper_kwargs.items())), c.device)
                    buckets.setdefault(bkey, []).append(i)

            for bkey, idxs in buckets.items():
                with spans.phase("sneap.mapping", configs=len(idxs)) as ph:
                    bc = [cfgs[i] for i in idxs]
                    for c in bc:
                        if c.requested_place == "tree":
                            raise ValueError(
                                "mapper 'sa_jax' cannot run the tree objective"
                            )
                    trs = [traffics[c.traffic_key()] for c in bc]
                    tls = [int(t.sum()) for t in trs]
                    seeds = [phase_seeds(c.seed)[1] for c in bc]
                    say(f"{profile.name}: sa_jax bucket of {len(idxs)} configs "
                        f"(cores={bkey[0]})")
                    mk = dict(bc[0].mapper_kwargs)
                    mk.setdefault("device", bc[0].device)
                    mresults = sa_search_jax_batch(
                        trs, bc[0].num_cores, bc[0].mesh_w, tls, seeds, **mk)
                    for i, c, mres, tr, tl in zip(idxs, bc, mresults, trs, tls):
                        pres = parts[c.partition_key()][0]
                        # Same reporting path as mapping_phase's device branch.
                        with spans.span("sneap.mapping.score"):
                            mres.avg_hop, mres.tree_hop = evaluate_placement(
                                mres.placement, tr, c.num_cores, c.mesh_w, tl,
                                mesh_h=c.mesh_h, hyper=hyper, part=pres.part,
                            )
                        po = ("pairwise" if c.place_objective == "tree"
                              else c.place_objective)
                        mapping_out[i] = (mres, po, tr, tl, None)
                per = ph.seconds / len(idxs)
                for i in idxs:
                    mapping_out[i] = mapping_out[i][:4] + (per,)

            for i, c in enumerate(cfgs):
                if mapping_out[i] is not None:
                    continue
                pres = parts[c.partition_key()][0]
                traffic = traffics[c.traffic_key()]
                obj = None
                mapper_name = "pso" if c.method == "spinemap" else c.mapper
                if (c.method != "sco" and mapper_name in OBJECTIVE_AWARE_MAPPERS
                        and "objective" not in c.mapper_kwargs):
                    okey = c.traffic_key() + (c.place_objective, c.mesh_w,
                                              c.mesh_h)
                    if okey not in objectives:
                        objectives[okey] = make_objective(
                            c.place_objective, traffic, c.num_cores, c.mesh_w,
                            mesh_h=c.mesh_h, hyper=hyper, part=pres.part,
                        )
                    obj = objectives[okey]
                with spans.phase("sneap.mapping") as ph:
                    mres, po, traffic, tl = mapping_phase(
                        profile, pres, c, traffic=traffic, objective=obj)
                mapping_out[i] = (mres, po, traffic, tl, ph.seconds)

            # -- evaluation phase + rows ---------------------------------------
            rows: list[dict] = []
            results: list[ToolchainResult] = []
            for i, c in enumerate(cfgs):
                entry = parts[c.partition_key()]
                pres, psec = entry[0], entry[1] / entry[2]
                mres, po, traffic, tl, msec = mapping_out[i]
                with spans.phase("sneap.evaluate") as ph:
                    noc = evaluate_phase(profile, pres, mres, c)
                esec = ph.seconds
                result = ToolchainResult(
                    method=c.method, snn=profile.name, partition=pres,
                    mapping=mres, noc=noc,
                    phase_seconds={"partition": psec, "mapping": msec,
                                   "evaluate": esec},
                    objective=c.objective, cast=c.cast, place_objective=po,
                )
                row = result.summary()
                row.update(
                    mapper=c.mapper, seed=c.seed, mesh_w=c.mesh_w,
                    mesh_h=c.mesh_h, capacity=c.capacity,
                    partition_impl=c.partition_impl,
                    score_backend=c.mapper_kwargs.get("score_backend", ""),
                    stepper=c.noc_kwargs.get("stepper", "numpy"),
                    screen=c.noc_kwargs.get("screen", "numpy"),
                    knobs=";".join(f"{k}={v}"
                                   for k, v in sorted(c.knobs.items())),
                )
                rows.append(row)
                results.append(result)
            for row, flag in zip(rows, pareto_flags(rows, pareto_keys)):
                row["pareto"] = int(flag)
            all_rows.extend(rows)
            all_results.extend(results)
            say(f"{profile.name}: {sum(r['pareto'] for r in rows)} of "
                f"{len(rows)} configs on the Pareto front")

    return SweepResult(rows=all_rows,
                       seconds=root.seconds,
                       pareto_keys=pareto_keys, results=all_results)
