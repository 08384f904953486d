from .ops import (edge_variance, flatten_link_maps, link_loads, link_loads_records,
                  record_link_loads, window_link_loads)
from .ref import link_loads_records_ref, link_loads_ref

__all__ = ["edge_variance", "flatten_link_maps", "link_loads", "link_loads_records",
           "link_loads_records_ref", "link_loads_ref", "record_link_loads",
           "window_link_loads"]
