"""Launchers: the batched toolchain sweep driver (`repro_torch.launch.sweep`)
and the LLM scaffolding's serving path — meshes (`mesh`), the prefill and
serve steps (`steps`) and the batched serving driver (`serve`,
``python -m repro_torch.launch.serve``).

The reference's train step and driver (ROADMAP queue 1, item 12b) and its
XLA tooling (dry-run, roofline; item 13) are not ported yet.
"""
from .mesh import (Mesh, batch_axes_of, make_local_mesh, make_mesh_with_layout,
                   make_production_mesh)
from .serve import serve_batch
from .steps import StepBundle, make_plan, make_prefill_step, make_serve_step
from .sweep import SweepResult, config_grid, pareto_flags, run_sweep

__all__ = ["SweepResult", "config_grid", "pareto_flags", "run_sweep",
           "Mesh", "batch_axes_of", "make_local_mesh", "make_mesh_with_layout",
           "make_production_mesh", "StepBundle", "make_plan",
           "make_prefill_step", "make_serve_step", "serve_batch"]
