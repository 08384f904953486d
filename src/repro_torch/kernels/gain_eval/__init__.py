from .ops import connectivity_degrees, gain_matrix, part_degrees
from .ref import (
    connectivity_degrees_ref,
    gain_matrix_ref,
    part_degrees_ref,
    part_onehot,
)

__all__ = [
    "part_degrees", "gain_matrix", "connectivity_degrees",
    "part_degrees_ref", "gain_matrix_ref", "connectivity_degrees_ref",
    "part_onehot",
]
