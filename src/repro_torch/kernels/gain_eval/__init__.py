from .kernel import SelectSlots
from .ops import (
    gain_matrix,
    part_degrees,
    read_select,
    volume_degree_rows,
    volume_select,
)
from .ref import (
    connectivity_degrees_ref,
    gain_matrix_ref,
    part_degrees_ref,
    part_onehot,
    volume_degree_rows_ref,
    volume_select_ref,
)

__all__ = [
    "part_degrees", "gain_matrix", "volume_degree_rows", "volume_select",
    "read_select", "SelectSlots",
    "part_degrees_ref", "gain_matrix_ref", "connectivity_degrees_ref",
    "volume_degree_rows_ref", "volume_select_ref", "part_onehot",
]
