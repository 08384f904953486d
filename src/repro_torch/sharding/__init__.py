"""Sharding: the LLM scaffolding's parameter, cache, batch and
optimizer-state rules (`ShardingPlan`, `plan_params`, ...), the
partitioning engine's vertex-block plan (`plan_vertex_shards`) and the
SNEAP device-layout search (`sneap_device_layout`).
"""
from .layout import logical_traffic_matrix, sneap_device_layout
from .planner import (ParamShard, ShardingPlan, VertexShardPlan, plan_batch,
                      plan_caches, plan_opt_state, plan_params,
                      plan_vertex_shards, shard_slices, spec_for_param)

__all__ = ["ShardingPlan", "plan_params", "plan_caches", "plan_batch",
           "plan_opt_state", "spec_for_param", "shard_slices", "ParamShard",
           "VertexShardPlan", "plan_vertex_shards", "logical_traffic_matrix",
           "sneap_device_layout"]
