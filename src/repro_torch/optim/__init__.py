"""AdamW (warmup + cosine schedule, global-norm clipping) and the int8
gradient compression, in torch ops in the reference's order."""
from .adamw import AdamWConfig, adamw_update, compress_grads, init_opt_state

__all__ = ["AdamWConfig", "adamw_update", "compress_grads", "init_opt_state"]
