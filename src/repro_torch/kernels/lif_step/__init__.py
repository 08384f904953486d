from .ops import Synapses, lif_step, lif_steps, synapses_from_dense
from .ref import lif_step_ref, lif_steps_ref

__all__ = ["Synapses", "lif_step", "lif_step_ref", "lif_steps", "lif_steps_ref",
           "synapses_from_dense"]
