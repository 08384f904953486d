"""End-to-end SNEAP toolchain: profile -> partition -> map -> evaluate.

The reference also drives the two baseline toolchains (SpiNeMap, SCO);
they are not ported yet (ROADMAP queue 1, item 4: ``baselines.py``), so
``method="spinemap"`` and ``method="sco"`` raise NotImplementedError.

The ``objective`` knob threads the partitioning metric through the whole
stack: ``"cut"`` (spikes on cut synapses, the paper's metric) or
``"volume"`` (multicast communication volume).  ``cast`` independently
selects the NoC traffic model used for placement scoring and replay —
by default it follows the objective ("volume" → "multicast"), so the
partitioner, the placement search, and the simulator all measure the same
quantity.  ``ToolchainResult.summary()`` reports both metrics for every
run, which is what lets Figures 4-8 be regenerated under either model.

`run_toolchain` executes one `ToolchainConfig` end to end through the
phase functions (`partition_phase` / `mapping_phase` / `evaluate_phase`).
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

from repro_torch.device import resolve_device
from repro_torch.nocsim import NoCStats, simulate_noc

if TYPE_CHECKING:  # avoid core <-> snn circular import; only a type hint
    from repro_torch.snn.simulate import ProfileResult

from .hopcost import traffic_matrix
from .mapping import MAPPERS, UNPORTED_MAPPERS, MappingResult
from .partition import PartitionResult, sneap_partition
from .placecost import evaluate_placement, make_objective, validate_objective

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

    Mirrors `run_toolchain`'s keyword surface one-for-one.  ``resolve()``
    fills the ``cast``/``place_objective`` defaults and validates the
    enums.
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
    # device-kernel crossover (see `repro_torch.core.refine_vec`).
    knobs: dict = field(default_factory=dict)
    # Where the device hot spots run: "cuda" (default) or "cpu".
    device: str = "cuda"
    # Set by resolve(); callers normally never set it directly.
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
        if self.method in ("spinemap", "sco"):
            raise NotImplementedError(
                f"method {self.method!r} is not ported yet (ROADMAP queue 1, "
                "item 4: baselines.py)")
        if self.method != "sneap":
            raise ValueError(f"unknown method {self.method!r}")
        return dataclasses.replace(
            self, cast=cast, place_objective=place,
            mapper_kwargs=dict(self.mapper_kwargs),
            partition_kwargs=dict(self.partition_kwargs),
            noc_kwargs=dict(self.noc_kwargs),
            knobs=dict(self.knobs),
            resolved=True,
        )


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
    pres = sneap_partition(profile.graph, capacity=cfg.capacity,
                           seed=part_seed, max_k=cfg.num_cores,
                           impl=cfg.partition_impl, objective=cfg.objective,
                           device=cfg.device, **cfg.partition_kwargs)
    if pres.k > cfg.num_cores:
        raise ValueError(
            f"{pres.k} partitions exceed {cfg.num_cores} cores; "
            f"enlarge mesh or capacity"
        )
    return pres


def build_traffic(profile: "ProfileResult", pres: PartitionResult,
                  cfg: ToolchainConfig) -> np.ndarray:
    """The (k, k) partition traffic matrix of a run (deterministic)."""
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

    ``traffic``/``objective`` let a caller hand in artifacts it already
    built (both are deterministic functions of the partition and config,
    so sharing cannot change any stat; a shared objective instance is safe
    because every search re-``attach``es it).  Returns
    ``(mres, place_objective, traffic, trace_len)``.
    """
    cfg = cfg.resolve(profile.graph.hyper)
    hyper = profile.graph.hyper
    num_cores = cfg.num_cores
    map_seed = phase_seeds(cfg.seed)[1]
    if cfg.mapper in UNPORTED_MAPPERS:
        raise NotImplementedError(
            f"mapper {cfg.mapper!r} is not ported yet (ROADMAP queue 1, "
            f"{UNPORTED_MAPPERS[cfg.mapper]})")
    if cfg.mapper not in MAPPERS:
        raise ValueError(f"unknown mapper {cfg.mapper!r}; "
                         f"pick one of {sorted(MAPPERS)}")
    if traffic is None:
        traffic = build_traffic(profile, pres, cfg)
    # Normalize average hop by the packet count of the chosen traffic model
    # (== num_spikes for unicast; deduplicated multicast packets otherwise).
    trace_len = int(traffic.sum())
    mapper_kwargs = dict(cfg.mapper_kwargs)
    if cfg.mapper == "sa":
        mapper_kwargs.setdefault("device", cfg.device)
    if "objective" in mapper_kwargs:
        # A caller-supplied objective is stateful (attached placement,
        # aggregate tables) and construction-bound to one (traffic,
        # partition, mesh); reusing it across runs whose partition differs
        # would silently score the wrong trees — reject loudly instead.
        validate_objective(mapper_kwargs["objective"], traffic,
                           num_cores, mesh_w=cfg.mesh_w,
                           mesh_h=cfg.mesh_h, part=pres.part,
                           hyper=hyper,
                           torus=mapper_kwargs.get("torus", False))
    else:
        mapper_kwargs["objective"] = objective if objective is not None \
            else make_objective(
                cfg.place_objective, traffic, num_cores, cfg.mesh_w,
                mesh_h=cfg.mesh_h, hyper=hyper, part=pres.part,
            )
    place_objective = mapper_kwargs["objective"].name
    mres = MAPPERS[cfg.mapper](traffic, num_cores, cfg.mesh_w, trace_len,
                               seed=map_seed, **mapper_kwargs)
    # One reporting path: avg_hop (pairwise Eq. 2) and tree_hop both come
    # from the shared evaluator, never from the search.  The objective
    # that drove the search is reused so its construction cost is not
    # paid twice; `evaluate_placement` validates it against this run's
    # traffic/partition before trusting it.
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
    fault_schedule=None,
    config: ToolchainConfig | None = None,
    device: str = "cuda",
) -> ToolchainResult:
    """Run the SNEAP toolchain over a profiled SNN: multilevel partitioning
    + placement search + NoC replay.

    ``device`` (default ``"cuda"``) is where the device hot spots run —
    the vec refiner's degree kernel, the SA's ``score_backend="auto"``
    swap deltas, the replay's ``screen="linkload"`` window loads; it
    raises where CUDA is absent unless ``device="cpu"``.  Everything else
    is host numpy copied from the reference, so every deterministic phase
    matches it bitwise.

    ``partition_impl`` selects the sneap partitioning engine ("scalar" or
    "vec" — see `repro_torch.core.partition`).  ``objective`` selects the
    partitioning metric ("cut" or "volume"); ``cast`` the NoC traffic model
    ("unicast" or "multicast"), defaulting to the model that matches the
    objective.  ``place_objective`` selects the quantity the placement
    search minimizes ("pairwise" or "tree") the same way: by default it
    follows ``cast`` (see `repro_torch.core.placecost`).
    ``partition_kwargs`` are forwarded to ``sneap_partition``;
    ``mapper_kwargs`` to the search (e.g. ``{"impl": "vec",
    "score_backend": "auto"}``); ``noc_kwargs`` to ``simulate_noc`` (e.g.
    ``inject_capacity``, ``energy``, ``engine``, ``screen``), overriding
    ``link_capacity``/``noc_mode``/``cast`` on conflict.  ``config``
    replaces all of the above with one `ToolchainConfig` (mutually
    exclusive with passing individual knobs).

    Seeding: the one ``seed`` is split into independent per-phase child
    seeds via ``np.random.SeedSequence(seed).spawn()`` (`phase_seeds`), as
    in the reference.  Results are fully deterministic per seed.

    Not ported yet, and refused with NotImplementedError rather than run
    some other way: ``method="spinemap"``/``"sco"`` (ROADMAP queue 1,
    item 4), the device mappers ``"sa_jax"``/``"polish"`` (item 6) and
    ``"island"`` (item 10), ``fault_schedule`` (item 7) and ``shards=``
    (item 9).
    """
    if fault_schedule is not None:
        raise NotImplementedError(
            "fault_schedule= is not ported yet (ROADMAP queue 1, item 7: "
            "faults and re-mapping)")
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

    t0 = time.perf_counter()
    pres = partition_phase(profile, cfg)
    phase["partition"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mres, place_objective, traffic, trace_len = mapping_phase(profile, pres, cfg)
    phase["mapping"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    noc = evaluate_phase(profile, pres, mres, cfg)
    phase["evaluate"] = time.perf_counter() - t0
    return ToolchainResult(
        method=cfg.method, snn=profile.name, partition=pres, mapping=mres,
        noc=noc, phase_seconds=phase, objective=cfg.objective, cast=cfg.cast,
        place_objective=place_objective,
    )
