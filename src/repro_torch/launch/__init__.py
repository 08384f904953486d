"""Launchers: the batched toolchain sweep driver (`repro_torch.launch.sweep`)
and the LLM scaffolding's serving and training paths — meshes of cards
and of ``torch.distributed`` ranks, with the ranks' launcher (`mesh`:
`make_rank_mesh`, `run_ranks`), the train, prefill and serve steps
(`steps`), batched serving (`serve`,
``python -m repro_torch.launch.serve``) and the fault-tolerant training
loop (`train`, ``python -m repro_torch.launch.train``); and the dry run
and roofline from op counts of those steps on the meta device
(`op_analysis`, `dryrun`, `roofline`, `hillclimb`, `report`; each with
``python -m``), where the reference reads XLA's compiled HLO.
"""
from .mesh import (Mesh, batch_axes_of, make_local_mesh, make_mesh_with_layout,
                   make_production_mesh, make_rank_mesh, run_ranks)
from .serve import serve_batch
from .steps import (StepBundle, make_plan, make_prefill_step, make_serve_step,
                    make_train_step)
from .sweep import SweepResult, config_grid, pareto_flags, run_sweep
from .train import train_loop

__all__ = ["SweepResult", "config_grid", "pareto_flags", "run_sweep",
           "Mesh", "batch_axes_of", "make_local_mesh", "make_mesh_with_layout",
           "make_production_mesh", "make_rank_mesh", "run_ranks",
           "StepBundle", "make_plan",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "serve_batch", "train_loop"]
