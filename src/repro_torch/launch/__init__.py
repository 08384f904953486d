"""Launchers: the batched toolchain sweep driver (`repro_torch.launch.sweep`).

The reference's other launchers (mesh construction, train/serve steps,
dry-run, roofline) belong to its LLM scaffolding and XLA tooling and are
not ported yet (ROADMAP queue 1, items 12 and 13).
"""
from .sweep import SweepResult, config_grid, pareto_flags, run_sweep

__all__ = ["SweepResult", "config_grid", "pareto_flags", "run_sweep"]
