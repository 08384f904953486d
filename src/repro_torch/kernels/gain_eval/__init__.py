from .ops import gain_matrix, part_degrees, volume_degree_rows
from .ref import (
    connectivity_degrees_ref,
    gain_matrix_ref,
    part_degrees_ref,
    part_onehot,
    volume_degree_rows_ref,
)

__all__ = [
    "part_degrees", "gain_matrix", "volume_degree_rows",
    "part_degrees_ref", "gain_matrix_ref", "connectivity_degrees_ref",
    "volume_degree_rows_ref", "part_onehot",
]
