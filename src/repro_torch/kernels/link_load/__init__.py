from .ops import link_loads, window_link_loads
from .ref import link_loads_ref

__all__ = ["link_loads", "link_loads_ref", "window_link_loads"]
