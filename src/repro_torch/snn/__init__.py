"""SNN software-simulator substrate (the toolchain's profiling phase).

A CARLsim substitute: vectorized leaky-integrate-and-fire dynamics stepped
on the device, network topology builders for the paper's five evaluated
SNNs, and a profiler that emits the spike-weighted synapse graph plus the
per-spike trace that the partitioning/mapping phases consume.
"""
from .lif import LIFParams, lif_run
from .simulate import ProfileResult, profile_snn
from .topology import SNNTopology, make_snn, PAPER_SNNS

__all__ = [
    "LIFParams", "lif_run", "ProfileResult", "profile_snn",
    "SNNTopology", "make_snn", "PAPER_SNNS",
]
