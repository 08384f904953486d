from .ops import lif_step
from .ref import lif_step_ref

__all__ = ["lif_step", "lif_step_ref"]
