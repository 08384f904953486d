"""Runtime: the fault model and the straggler monitor that the
toolchain's graceful-degradation scenarios drive (host numpy), and the
trainer's atomic checkpoints (`CheckpointManager`) and elastic
re-placement (`remesh_params`).
"""
from .checkpoint import CheckpointManager
from .elastic import Sharded, remesh_params
from .faults import FaultEvent, FaultSchedule, FaultState, heartbeat_detect
from .health import HeartbeatMonitor

__all__ = [
    "CheckpointManager", "remesh_params", "Sharded", "HeartbeatMonitor",
    "FaultEvent", "FaultSchedule", "FaultState", "heartbeat_detect",
]
