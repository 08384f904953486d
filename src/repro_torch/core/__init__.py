"""SNEAP core: the paper's contribution.

Partitioning (multilevel graph/hypergraph partitioning minimizing either
inter-partition spikes or multicast communication volume), mapping
(SA/PSO/Tabu placement minimizing average hop under XY routing), analytic
hop evaluation (Algorithm 1), baselines (SpiNeMap, SCO), re-mapping
around failed cores, and the end-to-end toolchain pipeline.
"""
from .baselines import greedy_kl_partition, sco_partition, sco_place
from .graph import (
    Graph,
    Hypergraph,
    build_graph,
    build_hypergraph,
    comm_volume,
    dedup_hyperedges,
    edge_cut,
    partition_weights,
    validate_partition,
    volume_degrees,
)
from .hopcost import (
    average_hop,
    core_coords,
    hop_distance_matrix,
    swap_delta,
    swap_delta_batch,
    traffic_matrix,
)
from .mapping import (
    MAPPERS,
    OBJECTIVE_AWARE_MAPPERS,
    MappingResult,
    pso_search,
    sa_search,
    tabu_search,
)
from .partition import PartitionResult, sneap_partition
from .pipeline import (
    ToolchainConfig,
    ToolchainResult,
    evaluate_phase,
    mapping_phase,
    partition_phase,
    phase_seeds,
    run_toolchain,
)
from .placecost import (
    PLACE_OBJECTIVES,
    MigrationAwareObjective,
    PairwiseObjective,
    TreeHopObjective,
    evaluate_placement,
    make_objective,
    validate_objective,
)
from .remap import (
    RemapResult,
    check_degraded_capacity,
    evict_dead_partitions,
    incremental_remap,
    scratch_remap,
)

__all__ = [
    "Graph", "Hypergraph", "build_graph", "build_hypergraph",
    "dedup_hyperedges", "edge_cut", "comm_volume", "volume_degrees",
    "partition_weights", "validate_partition",
    "average_hop", "core_coords", "hop_distance_matrix", "swap_delta",
    "swap_delta_batch", "traffic_matrix",
    "MAPPERS", "OBJECTIVE_AWARE_MAPPERS", "MappingResult",
    "pso_search", "sa_search", "tabu_search",
    "PLACE_OBJECTIVES", "PairwiseObjective", "TreeHopObjective",
    "MigrationAwareObjective", "evaluate_placement", "make_objective",
    "validate_objective",
    "RemapResult", "check_degraded_capacity", "evict_dead_partitions",
    "incremental_remap", "scratch_remap",
    "PartitionResult", "sneap_partition",
    "greedy_kl_partition", "sco_partition", "sco_place",
    "ToolchainConfig", "ToolchainResult", "run_toolchain",
    "phase_seeds", "partition_phase", "mapping_phase", "evaluate_phase",
]
