from .ops import swap_deltas, swap_deltas_pairs
from .ref import swap_deltas_ref

__all__ = ["swap_deltas", "swap_deltas_pairs", "swap_deltas_ref"]
