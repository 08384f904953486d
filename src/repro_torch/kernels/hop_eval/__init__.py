from .ops import hop_cost
from .ref import hop_cost_ref

__all__ = ["hop_cost", "hop_cost_ref"]
