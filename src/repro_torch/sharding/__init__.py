"""Sharding: the partitioning engine's vertex-block plan
(`plan_vertex_shards`) and the SNEAP device-layout search
(`sneap_device_layout`).

The reference's parameter sharding rules belong to its LLM scaffolding
and are not ported yet (ROADMAP queue 1, item 12a).
"""
from .layout import logical_traffic_matrix, sneap_device_layout
from .planner import VertexShardPlan, plan_vertex_shards

__all__ = ["VertexShardPlan", "plan_vertex_shards", "logical_traffic_matrix",
           "sneap_device_layout"]
