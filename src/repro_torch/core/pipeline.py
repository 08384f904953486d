"""End-to-end SNEAP toolchain: profile -> partition -> map -> evaluate.

Also drives the two baseline toolchains (SpiNeMap: greedy-KL partition +
PSO placement; SCO: sequential packing + sequential placement,
`repro_torch.core.baselines`) over the same profiled trace, so the
paper's Figures 4-8 comparisons are apples-to-apples.

The ``objective`` knob threads the partitioning metric through the whole
stack: ``"cut"`` (spikes on cut synapses, the paper's metric) or
``"volume"`` (multicast communication volume).  ``cast`` independently
selects the NoC traffic model used for placement scoring and replay —
by default it follows the objective ("volume" → "multicast"), so the
partitioner, the placement search, and the simulator all measure the same
quantity.  ``ToolchainResult.summary()`` reports both metrics for every
run, which is what lets Figures 4-8 be regenerated under either model.

One config path serves two drivers: `run_toolchain` executes one
`ToolchainConfig` end to end through the phase functions
(`partition_phase` / `mapping_phase` / `evaluate_phase`), and
`repro_torch.launch.sweep.run_sweep` executes a whole grid of them through
the same functions, sharing partitions and traffic across configs and
stacking ``mapper="sa_jax"`` searches into one device program — so a
sweep row carries the stats of the matching single run.  With a
``fault_schedule`` the evaluation replays the trace in segments across
core and link failures and re-maps between them (`repro_torch.core.remap`).
``ToolchainConfig.device`` says where the device hot spots run: the card
by default, the CPU when the caller asks for it.  The results do not
depend on the device except where a kernel's f32 arithmetic feeds a
search (the SA's ``score_backend="auto"`` deltas).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from repro_torch import spans
from repro_torch.device import resolve_device
from repro_torch.nocsim import NoCStats, combine_stats, simulate_noc
from repro_torch.runtime.faults import FaultSchedule, FaultState, heartbeat_detect
from repro_torch.runtime.health import HeartbeatMonitor

if TYPE_CHECKING:  # avoid core <-> snn circular import; only a type hint
    from repro_torch.snn.simulate import ProfileResult

from .baselines import greedy_kl_partition, sco_partition, sco_place
from .hopcost import traffic_matrix
from .mapping import (
    DEVICE_MAPPERS,
    MAPPERS,
    OBJECTIVE_AWARE_MAPPERS,
    MappingResult,
)
from .partition import PartitionResult, sneap_partition
from .placecost import evaluate_placement, make_objective, validate_objective
from .remap import incremental_remap, scratch_remap

__all__ = [
    "ToolchainConfig",
    "ToolchainResult",
    "phase_seeds",
    "apply_knobs",
    "partition_phase",
    "mapping_phase",
    "evaluate_phase",
    "run_toolchain",
]


def phase_seeds(seed: int) -> tuple[int, int, int]:
    """Independent per-phase child seeds of one run seed.

    ``(partition_seed, mapping_seed, remap_seed)``, derived via
    ``np.random.SeedSequence(seed).spawn()`` so the phases' random streams
    are statistically independent.  Historically the one run ``seed`` was
    threaded verbatim into both ``sneap_partition`` and the mapper search,
    so sweep replicates that varied only the seed drew lockstep-correlated
    partition and placement streams; deriving children fixes that (and
    deterministically changes every seeded run's exact results relative to
    pre-fix versions — same quality, different draws).
    """
    children = np.random.SeedSequence(seed).spawn(3)
    return tuple(int(c.generate_state(1)[0]) for c in children)


@dataclass
class ToolchainConfig:
    """Full configuration of one toolchain run.

    Mirrors `run_toolchain`'s keyword surface one-for-one (minus the
    fault-scenario arguments, which stay per-call); `repro_torch.launch.
    sweep` builds grids of these and runs them through the shared phase
    functions.  ``resolve()`` fills the ``cast``/``place_objective``
    defaults and validates the enums; ``requested_place`` preserves
    whether the caller *explicitly* asked for a placement objective
    (explicit tree requests must error loudly on searches that cannot
    honor them, while defaulted ones silently fall back).
    """

    method: str = "sneap"
    mesh_w: int = 5
    mesh_h: int = 5
    capacity: int = 256
    mapper: str = "sa"
    seed: int = 0
    noc_mode: str = "queued"
    link_capacity: int = 4
    mapper_kwargs: dict = field(default_factory=dict)
    partition_impl: str = "scalar"
    objective: str = "cut"
    cast: str | None = None
    place_objective: str | None = None
    partition_kwargs: dict = field(default_factory=dict)
    noc_kwargs: dict = field(default_factory=dict)
    # Module-level engine threshold overrides applied for the run's
    # duration, e.g. {"_KERNEL_MAX_N": 1024} to move the vec refiner's
    # device-kernel crossover (see `repro_torch.core.refine_vec`).  Swept
    # by `repro_torch.launch.sweep` to measure data-driven defaults.
    knobs: dict = field(default_factory=dict)
    # Where the device hot spots run: "cuda" (default) or "cpu".
    device: str = "cuda"
    # Filled by resolve(); callers normally never set these directly.
    requested_place: str | None = None
    resolved: bool = False

    @property
    def num_cores(self) -> int:
        return self.mesh_w * self.mesh_h

    def resolve(self, hyper=None) -> "ToolchainConfig":
        """Validated copy with the ``cast``/``place_objective`` defaults filled."""
        if self.resolved:
            return self
        if self.objective not in ("cut", "volume"):
            raise ValueError(f"unknown objective {self.objective!r}")
        cast = self.cast
        if cast is None:
            cast = "multicast" if self.objective == "volume" else "unicast"
        place = self.place_objective
        if place is None:
            # Only SNEAP upgrades to the tree objective by default: the
            # baselines reproduce published toolchains that place with
            # pairwise spike counts (SpiNeMap's PSO, SCO's sequence), so
            # they keep Eq. 2 unless the caller explicitly overrides.
            place = ("tree" if cast == "multicast" and hyper is not None
                     and self.method == "sneap" else "pairwise")
        if place not in ("pairwise", "tree"):
            raise ValueError(f"unknown place_objective {place!r}")
        if self.method not in ("sneap", "spinemap", "sco"):
            raise ValueError(f"unknown method {self.method!r}")
        return dataclasses.replace(
            self, cast=cast, place_objective=place,
            requested_place=self.place_objective,
            mapper_kwargs=dict(self.mapper_kwargs),
            partition_kwargs=dict(self.partition_kwargs),
            noc_kwargs=dict(self.noc_kwargs),
            knobs=dict(self.knobs),
            resolved=True,
        )

    # -- sweep sharing keys ------------------------------------------------
    def partition_key(self) -> tuple:
        """Configs with equal keys produce bitwise-identical partitions.

        The mapping/evaluation knobs are excluded on purpose: two sweep
        configs that differ only there share one partitioning run.  The
        seed component is the *derived* partition child seed, so configs
        with different run seeds never collide, and sco (which draws no
        randomness) keys seed-free.  ``device`` is excluded too: the
        partition does not depend on where the refiner's kernel runs.
        """
        part_seed = 0 if self.method == "sco" else phase_seeds(self.seed)[0]
        impl = self.partition_impl if self.method == "sneap" else ""
        kw = self.partition_kwargs if self.method == "sneap" else {}
        return (self.method, self.capacity, self.num_cores, impl,
                self.objective, part_seed, tuple(sorted(kw.items())),
                tuple(sorted(self.knobs.items())))

    def traffic_key(self) -> tuple:
        """Configs with equal keys share one (k, k) traffic matrix."""
        return self.partition_key() + (self.cast,)


@dataclass
class ToolchainResult:
    method: str
    snn: str
    partition: PartitionResult
    mapping: MappingResult
    noc: NoCStats
    phase_seconds: dict = field(default_factory=dict)
    objective: str = "cut"
    cast: str = "unicast"
    place_objective: str = "pairwise"
    # Fault-scenario bookkeeping (None on fault-free runs): remap event
    # count/strategy, total remap seconds, neurons migrated/evicted, final
    # dead core/link counts — see run_toolchain's fault_schedule.
    degradation: dict | None = None

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    def summary(self) -> dict:
        out = {
            "method": self.method,
            "snn": self.snn,
            "objective": self.objective,
            "cast": self.cast,
            "place_objective": self.place_objective,
            "k": self.partition.k,
            "edge_cut": self.partition.edge_cut,
            "comm_volume": self.partition.comm_volume,
            "avg_hop": self.mapping.avg_hop,
            "tree_hop": self.mapping.tree_hop,
            "avg_latency": self.noc.avg_latency,
            "energy_pj": self.noc.dynamic_energy_pj,
            "congestion": self.noc.congestion_count,
            "edge_var": self.noc.edge_variance,
            "spikes_dropped": self.noc.spikes_dropped,
            "detour_hops": self.noc.detour_hops,
            "partition_s": self.phase_seconds.get("partition", 0.0),
            "mapping_s": self.phase_seconds.get("mapping", 0.0),
            "evaluate_s": self.phase_seconds.get("evaluate", 0.0),
            "total_s": self.total_seconds,
        }
        if self.degradation is not None:
            out["remap_s"] = self.degradation["remap_s"]
            out["neurons_migrated"] = self.degradation["neurons_migrated"]
            out["remap_events"] = self.degradation["remap_events"]
            out["remap_strategy"] = self.degradation["remap_strategy"]
        return out


@contextmanager
def apply_knobs(knobs: dict):
    """Temporarily override `repro_torch.core.refine_vec` module thresholds.

    Knob names must be existing refine_vec attributes (e.g.
    ``_KERNEL_MAX_N``, ``_KERNEL_MIN_K``, ``_PHI_MAX_ENTRIES``,
    ``_DEG_CACHE_ENTRIES``, ``_DENSE_EVAL_ENTRIES``); unknown names raise
    rather than silently sweeping a no-op axis.  Originals are restored on
    exit even on error, so one config's knobs never leak into the next.
    """
    if not knobs:
        yield
        return
    from . import refine_vec

    saved = {}
    for name in knobs:
        if not hasattr(refine_vec, name):
            raise ValueError(f"unknown refine_vec knob {name!r}")
        saved[name] = getattr(refine_vec, name)
    try:
        for name, value in knobs.items():
            setattr(refine_vec, name, value)
        yield
    finally:
        for name, value in saved.items():
            setattr(refine_vec, name, value)


def partition_phase(profile: "ProfileResult", cfg: ToolchainConfig) -> PartitionResult:
    """Run the configured partitioner (seeded with the partition child seed).

    ``cfg.knobs`` overrides are live for the duration of this phase only —
    they tune refiner thresholds, which nothing downstream reads.
    """
    with apply_knobs(cfg.knobs):
        return _partition_phase(profile, cfg)


def _partition_phase(profile: "ProfileResult", cfg: ToolchainConfig) -> PartitionResult:
    cfg = cfg.resolve(profile.graph.hyper)
    part_seed = phase_seeds(cfg.seed)[0]
    if cfg.method == "sneap":
        pres = sneap_partition(profile.graph, capacity=cfg.capacity,
                               seed=part_seed, max_k=cfg.num_cores,
                               impl=cfg.partition_impl, objective=cfg.objective,
                               device=cfg.device, **cfg.partition_kwargs)
    elif cfg.method == "spinemap":
        pres = greedy_kl_partition(profile.graph, capacity=cfg.capacity,
                                   seed=part_seed, max_k=cfg.num_cores,
                                   objective=cfg.objective)
    else:
        pres = sco_partition(profile.graph, capacity=cfg.capacity,
                             objective=cfg.objective)
    if pres.k > cfg.num_cores:
        raise ValueError(
            f"{pres.k} partitions exceed {cfg.num_cores} cores; "
            f"enlarge mesh or capacity"
        )
    return pres


def build_traffic(profile: "ProfileResult", pres: PartitionResult,
                  cfg: ToolchainConfig) -> np.ndarray:
    """The (k, k) partition traffic matrix of a run (deterministic)."""
    with spans.span("sneap.mapping.traffic", k=pres.k):
        return traffic_matrix(pres.part, profile.trace_src, profile.trace_dst,
                              pres.k, trace_t=profile.trace_t, cast=cfg.cast)


def mapping_phase(
    profile: "ProfileResult",
    pres: PartitionResult,
    cfg: ToolchainConfig,
    traffic: np.ndarray | None = None,
    objective=None,
) -> tuple[MappingResult, str, np.ndarray, int]:
    """Run the placement search + the shared evaluator.

    ``traffic``/``objective`` let the sweep driver hand in artifacts
    shared across configs (both are deterministic functions of the
    partition and config, so sharing cannot change any stat; a shared
    objective instance is safe because every search re-``attach``es it).
    Returns ``(mres, place_objective, traffic, trace_len)`` — the final
    place_objective may differ from the configured one where a search
    cannot honor it (sco, the device mappers).
    """
    cfg = cfg.resolve(profile.graph.hyper)
    hyper = profile.graph.hyper
    num_cores = cfg.num_cores
    place_objective = cfg.place_objective
    map_seed = phase_seeds(cfg.seed)[1]
    # SpiNeMap always places with PSO; SCO runs no search at all.
    mapper_name = "pso" if cfg.method == "spinemap" else cfg.mapper
    if cfg.method != "sco" and mapper_name not in MAPPERS:
        raise ValueError(f"unknown mapper {mapper_name!r}; "
                         f"pick one of {sorted(MAPPERS)}")
    if traffic is None:
        traffic = build_traffic(profile, pres, cfg)
    # Normalize average hop by the packet count of the chosen traffic model
    # (== num_spikes for unicast; deduplicated multicast packets otherwise).
    trace_len = int(traffic.sum())
    mapper_kwargs = dict(cfg.mapper_kwargs)
    if cfg.method == "sco":
        if cfg.requested_place == "tree":
            raise ValueError(
                "method 'sco' places sequentially (no search), so an "
                "explicit place_objective='tree' cannot be honored"
            )
        mres = sco_place(pres.k, num_cores)
        place_objective = mres.objective  # no search ran; reported units
    else:
        if mapper_name in DEVICE_MAPPERS:
            mapper_kwargs.setdefault("device", cfg.device)
        if mapper_name in OBJECTIVE_AWARE_MAPPERS:
            if "objective" in mapper_kwargs:
                # A caller-supplied objective is stateful (attached
                # placement, aggregate tables) and construction-bound to
                # one (traffic, partition, mesh); reusing it across runs
                # whose partition differs would silently score the wrong
                # trees — reject loudly instead.
                validate_objective(mapper_kwargs["objective"], traffic,
                                   num_cores, mesh_w=cfg.mesh_w,
                                   mesh_h=cfg.mesh_h, part=pres.part,
                                   hyper=hyper,
                                   torus=mapper_kwargs.get("torus", False))
            else:
                mapper_kwargs["objective"] = objective if objective is not None \
                    else make_objective(
                        place_objective, traffic, num_cores, cfg.mesh_w,
                        mesh_h=cfg.mesh_h, hyper=hyper, part=pres.part,
                    )
            place_objective = mapper_kwargs["objective"].name
        elif place_objective == "tree":
            # Device mappers run the pairwise Eq. 2 reformulation only.
            if cfg.requested_place == "tree":
                raise ValueError(
                    f"mapper {mapper_name!r} cannot run the tree objective; "
                    f"pick one of {sorted(OBJECTIVE_AWARE_MAPPERS)}"
                )
            place_objective = "pairwise"
        mres = MAPPERS[mapper_name](traffic, num_cores, cfg.mesh_w, trace_len,
                                    seed=map_seed, **mapper_kwargs)
    # One reporting path for every method: avg_hop (pairwise Eq. 2) and
    # tree_hop both come from the shared evaluator, never from the search.
    # The objective that drove the search (if any) is reused so its
    # construction cost is not paid twice; `evaluate_placement` validates
    # it against this run's traffic/partition before trusting it.
    with spans.span("sneap.mapping.score"):
        mres.avg_hop, mres.tree_hop = evaluate_placement(
            mres.placement, traffic, num_cores, cfg.mesh_w, trace_len,
            mesh_h=cfg.mesh_h, hyper=hyper, part=pres.part,
            reuse=mapper_kwargs.get("objective"),
        )
    return mres, place_objective, traffic, trace_len


def evaluate_phase(
    profile: "ProfileResult",
    pres: PartitionResult,
    mres: MappingResult,
    cfg: ToolchainConfig,
) -> NoCStats:
    """Fault-free NoC replay of the profiled trace under a finished mapping."""
    cfg = cfg.resolve(profile.graph.hyper)
    noc_args = dict(link_capacity=cfg.link_capacity, mode=cfg.noc_mode,
                    cast=cfg.cast)
    noc_args.update(cfg.noc_kwargs)
    return simulate_noc(
        profile.trace_t, profile.trace_src, profile.trace_dst,
        pres.part, mres.placement, cfg.mesh_w, cfg.mesh_h,
        device=cfg.device, **noc_args,
    )


def run_toolchain(
    profile: "ProfileResult",
    method: str = "sneap",
    mesh_w: int = 5,
    mesh_h: int = 5,
    capacity: int = 256,
    mapper: str = "sa",
    seed: int = 0,
    noc_mode: str = "queued",
    link_capacity: int = 4,
    mapper_kwargs: dict | None = None,
    partition_impl: str = "scalar",
    objective: str = "cut",
    cast: str | None = None,
    place_objective: str | None = None,
    partition_kwargs: dict | None = None,
    noc_kwargs: dict | None = None,
    fault_schedule: FaultSchedule | None = None,
    remap_strategy: str = "incremental",
    remap_kwargs: dict | None = None,
    detect_windows: int = 2,
    config: ToolchainConfig | None = None,
    device: str = "cuda",
) -> ToolchainResult:
    """Run one toolchain (sneap | spinemap | sco) over a profiled SNN.

    * sneap:    multilevel partitioning + placement search (paper default).
    * spinemap: greedy-KL partitioning + PSO placement.
    * sco:      sequential packing + sequential placement.

    ``device`` (default ``"cuda"``) is where the device hot spots run —
    the vec refiner's degree kernel, the SA's ``score_backend="auto"``
    swap deltas, the device mappers ``"sa_jax"``, ``"polish"`` and
    ``"island"``, the replay's ``screen="linkload"`` window loads and ``stepper="jax"``
    cycle loop; it raises where CUDA is absent unless ``device="cpu"``.
    Everything else is host numpy copied from the reference (the
    baselines are host algorithms throughout), so every deterministic
    phase matches it bitwise.

    ``partition_impl`` selects the sneap partitioning engine ("scalar" or
    "vec" — see `repro_torch.core.partition`); ignored by the baselines.
    ``objective`` selects the partitioning metric ("cut" or "volume");
    ``cast`` the NoC traffic model ("unicast" or "multicast"), defaulting
    to the model that matches the objective.  ``place_objective`` selects
    the quantity the placement search minimizes ("pairwise" or "tree") the
    same way: by default it follows ``cast`` for sneap, while the
    baselines keep the pairwise Eq. 2 (see `repro_torch.core.placecost`).
    ``partition_kwargs`` are forwarded to ``sneap_partition`` (e.g.
    ``{"shards": 4, "stream_levels": True}``: the sharded engine, whose
    levels refine on the host);
    ``mapper_kwargs`` to the search (e.g. ``{"impl": "vec",
    "score_backend": "auto"}``; SpiNeMap's PSO takes its own, e.g.
    ``{"iters": 40}``); ``noc_kwargs`` to ``simulate_noc`` (e.g.
    ``inject_capacity``, ``energy``, ``engine``, ``screen``,
    ``stepper``), overriding ``link_capacity``/``noc_mode``/``cast`` on
    conflict.  ``config`` replaces all of the above with one
    `ToolchainConfig` (mutually exclusive with passing individual knobs).

    Seeding: the one ``seed`` is split into independent per-phase child
    seeds via ``np.random.SeedSequence(seed).spawn()`` (`phase_seeds`), as
    in the reference: the partition, mapping and re-map streams are
    decorrelated.  Results are fully deterministic per seed.

    Sweeps: to run a whole grid of configurations, use
    `repro_torch.launch.sweep.run_sweep` instead of looping over this
    function — it runs the same phase functions, shares partitions and
    traffic across configs, and stacks same-shape ``mapper="sa_jax"``
    searches into one device program.

    Graceful degradation: ``fault_schedule`` (a `repro_torch.runtime.
    faults.FaultSchedule`) injects core/link failures at trace-window
    boundaries.  The evaluation phase then replays the trace in segments:
    each segment runs under the cumulative fault state (XY routes crossing
    a dead link or core detour via the YX order or drop), and after each
    core-failure event the failed cores are detected through the
    `repro_torch.runtime.health.HeartbeatMonitor` straggler test, the next
    ``detect_windows`` windows replay on the stale mapping (spikes to the
    dead cores drop there), and the mapping is repaired by
    `repro_torch.core.remap` (``remap_strategy``: ``"incremental"``
    warm-starts the batched SA from the live placement under a
    migration-priced objective, ``"scratch"`` re-partitions onto the
    surviving cores; ``remap_kwargs`` forwards to it, and the re-map runs
    on ``device``).  Segment stats merge exactly
    (`repro_torch.nocsim.combine_stats`); ``summary()`` adds
    ``remap_s``/``neurons_migrated``/``remap_events``/``remap_strategy``
    and ``phase_seconds`` gains ``remap`` and ``scenario``.  A schedule of
    zero events is bit-identical to ``fault_schedule=None``.  Link-only
    failures re-route but never re-map.  A replay under a live fault
    state is host-only, as in the reference: it needs
    ``noc_kwargs={"screen": "numpy", "stepper": "numpy"}`` (the defaults).
    """
    if config is not None:
        cfg = config
    else:
        cfg = ToolchainConfig(
            method=method, mesh_w=mesh_w, mesh_h=mesh_h, capacity=capacity,
            mapper=mapper, seed=seed, noc_mode=noc_mode,
            link_capacity=link_capacity, mapper_kwargs=dict(mapper_kwargs or {}),
            partition_impl=partition_impl, objective=objective, cast=cast,
            place_objective=place_objective,
            partition_kwargs=dict(partition_kwargs or {}),
            noc_kwargs=dict(noc_kwargs or {}), device=device,
        )
    # Fails here, before any work, where CUDA is absent; also turns TF32
    # off so the f32 kernels' integer sums stay exact.
    resolve_device(cfg.device)
    cfg = cfg.resolve(profile.graph.hyper)
    phase: dict[str, float] = {}

    # The root span of the run's steps; each phase's seconds are its
    # phase span's own two clock reads.
    with spans.span("sneap.toolchain", method=cfg.method, mapper=cfg.mapper,
                    noc_mode=cfg.noc_mode):
        with spans.phase("sneap.partition") as s:
            pres = partition_phase(profile, cfg)
        phase["partition"] = s.seconds

        with spans.phase("sneap.mapping") as s:
            mres, place_objective, traffic, trace_len = mapping_phase(
                profile, pres, cfg)
        phase["mapping"] = s.seconds

        if fault_schedule is None:
            with spans.phase("sneap.evaluate") as s:
                noc = evaluate_phase(profile, pres, mres, cfg)
            phase["evaluate"] = s.seconds
            degradation = None
        else:
            noc_args = dict(link_capacity=cfg.link_capacity,
                            mode=cfg.noc_mode, cast=cfg.cast)
            noc_args.update(cfg.noc_kwargs)
            noc, degradation = _faulty_replay(
                profile, pres, mres, cfg.mesh_w, cfg.mesh_h, cfg.capacity,
                noc_args, phase, fault_schedule, remap_strategy, remap_kwargs,
                detect_windows, cfg.objective, cfg.cast, place_objective,
                phase_seeds(cfg.seed)[2], cfg.device,
            )
    return ToolchainResult(
        method=cfg.method, snn=profile.name, partition=pres, mapping=mres,
        noc=noc, phase_seconds=phase, objective=cfg.objective, cast=cfg.cast,
        place_objective=place_objective, degradation=degradation,
    )


def _faulty_replay(
    profile: "ProfileResult",
    pres: PartitionResult,
    mres: MappingResult,
    mesh_w: int,
    mesh_h: int,
    capacity: int,
    noc_args: dict,
    phase: dict,
    schedule: FaultSchedule,
    remap_strategy: str,
    remap_kwargs: dict | None,
    detect_windows: int,
    objective: str,
    cast: str,
    place_objective: str,
    seed: int,
    device: str,
) -> tuple[NoCStats, dict]:
    """Segmented trace replay across failure events, re-mapping between.

    Timeline per core-failure event at window ``te``: the trace up to
    ``te`` replays on the current mapping/fault state; the failure is
    detected via the HeartbeatMonitor straggler test; the next
    ``detect_windows`` windows replay on the *stale* mapping under the new
    fault state (this is where spikes to dead cores drop); the mapping is
    repaired; replay resumes on the new mapping.  Link-only events update
    the fault state at ``te`` with no detection lag and no re-map.
    ``seed`` is the run's remap child seed (see `phase_seeds`); ``device``
    is where each segment's replay and the re-map run.
    """
    if remap_strategy not in ("incremental", "scratch"):
        raise ValueError(f"unknown remap_strategy {remap_strategy!r}")
    t0 = time.perf_counter()
    trace_t = np.asarray(profile.trace_t, dtype=np.int64)
    trace_src = np.asarray(profile.trace_src, dtype=np.int64)
    trace_dst = np.asarray(profile.trace_dst, dtype=np.int64)
    if trace_t.shape[0] and (np.diff(trace_t) < 0).any():
        order = np.argsort(trace_t, kind="stable")
        trace_t, trace_src, trace_dst = (
            trace_t[order], trace_src[order], trace_dst[order])
    t_end = int(trace_t[-1]) + 1 if trace_t.shape[0] else 0

    state = FaultState.none(mesh_w, mesh_h)
    cur_part, cur_place, cur_k = pres.part, np.asarray(mres.placement), pres.k
    segments: list[NoCStats] = []
    replay_s = 0.0
    remap_s = 0.0
    migrated = evicted = remaps = 0
    remap_args = dict(device=device)
    remap_args.update(remap_kwargs or {})

    def replay(lo: int, hi: int) -> None:
        nonlocal replay_s
        i0 = int(np.searchsorted(trace_t, lo))
        i1 = int(np.searchsorted(trace_t, hi))
        if i0 == i1:
            return
        with spans.phase("sneap.evaluate") as s:
            segments.append(simulate_noc(
                trace_t[i0:i1], trace_src[i0:i1], trace_dst[i0:i1],
                cur_part, cur_place, mesh_w, mesh_h, faults=state,
                device=device, **noc_args,
            ))
        replay_s += s.seconds

    cursor = 0
    for te in schedule.event_times():
        te = int(te)
        if te >= t_end:
            break  # nothing left to replay past this point
        replay(cursor, te)
        cursor = max(cursor, te)
        had_core_fault = False
        for ev in schedule.events_at(te):
            state = state.apply(ev)
            had_core_fault |= ev.kind == "core"
        if not had_core_fault:
            continue  # link re-routing needs no detection lag or re-map
        # Failure detection: the monitor sees synthetic per-core step
        # times (dead cores straggle) and flags them; the re-map trusts
        # the *detected* set, not the schedule's ground truth.
        monitor = HeartbeatMonitor(mesh_w * mesh_h)
        detected = heartbeat_detect(monitor, state.dead_cores)
        dead_mask = np.zeros(mesh_w * mesh_h, dtype=bool)
        dead_mask[detected] = True
        # Detection lag: stale mapping under the new fault state — spikes
        # bound for the dead cores drop here.
        detect_end = min(cursor + max(detect_windows, 0), t_end)
        later = [t for t in schedule.event_times() if t > te]
        if later:
            detect_end = min(detect_end, int(later[0]))
        replay(cursor, detect_end)
        cursor = detect_end
        with spans.phase("sneap.remap", strategy=remap_strategy) as s:
            if remap_strategy == "incremental":
                res = incremental_remap(
                    profile.graph, cur_part, cur_place, dead_mask,
                    trace_t, trace_src, trace_dst, mesh_w, mesh_h,
                    capacity=capacity, cast=cast,
                    place_objective=place_objective,
                    partition_objective=objective, seed=seed, k=cur_k,
                    **remap_args,
                )
            else:
                res = scratch_remap(
                    profile.graph, cur_part, cur_place, dead_mask,
                    trace_t, trace_src, trace_dst, mesh_w, mesh_h,
                    capacity=capacity, cast=cast,
                    place_objective=place_objective,
                    partition_objective=objective, seed=seed,
                    **remap_args,
                )
        remap_s += s.seconds
        cur_part, cur_place, cur_k = res.part, res.placement, res.k
        migrated += res.neurons_migrated
        evicted += res.neurons_evicted
        remaps += 1
    replay(cursor, t_end)

    if segments:
        noc = combine_stats(segments)
    else:  # empty trace: one degenerate replay for well-formed stats
        with spans.phase("sneap.evaluate") as s:
            noc = simulate_noc(
                trace_t, trace_src, trace_dst, cur_part, cur_place,
                mesh_w, mesh_h, faults=state, device=device, **noc_args,
            )
        replay_s += s.seconds
    phase["evaluate"] = replay_s
    phase["remap"] = remap_s
    # Driver overhead (slicing, detection) outside replay and re-map.
    phase["scenario"] = max(
        time.perf_counter() - t0 - replay_s - remap_s, 0.0)
    degradation = {
        "events": len(schedule),
        "remap_events": remaps,
        "remap_strategy": remap_strategy,
        "remap_s": remap_s,
        "neurons_migrated": migrated,
        "neurons_evicted": evicted,
        "detect_windows": detect_windows,
        "dead_cores": int(state.dead_cores.sum()),
        "dead_links": int(state.dead_links.sum()),
        "final_k": cur_k,
    }
    return noc, degradation
