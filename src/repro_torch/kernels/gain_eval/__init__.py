from .ops import part_degrees
from .ref import part_degrees_ref, part_onehot

__all__ = ["part_degrees", "part_degrees_ref", "part_onehot"]
