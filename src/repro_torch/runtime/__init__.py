"""Runtime health: the fault model and the straggler monitor that the
toolchain's graceful-degradation scenarios drive (host numpy).

The reference's checkpointing and elastic re-meshing belong to its LLM
scaffolding and are not ported yet (ROADMAP queue 1, item 12).
"""
from .faults import FaultEvent, FaultSchedule, FaultState, heartbeat_detect
from .health import HeartbeatMonitor

__all__ = [
    "HeartbeatMonitor",
    "FaultEvent", "FaultSchedule", "FaultState", "heartbeat_detect",
]
