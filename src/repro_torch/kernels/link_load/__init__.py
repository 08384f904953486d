from .ops import (edge_variance, flatten_link_maps, link_loads, link_loads_records,
                  record_link_loads, record_replay_screen, replay_screen,
                  window_link_loads)
from .ref import PAST, STEPPED, link_loads_records_ref, link_loads_ref, replay_screen_ref

__all__ = ["PAST", "STEPPED", "edge_variance", "flatten_link_maps", "link_loads",
           "link_loads_records", "link_loads_records_ref", "link_loads_ref",
           "record_link_loads", "record_replay_screen", "replay_screen",
           "replay_screen_ref", "window_link_loads"]
