"""The deterministic synthetic-token pipeline (host numpy, a copy of the
reference's): batch ``step`` of shard ``shard`` is a pure function of
(seed, step, shard)."""
from .pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
