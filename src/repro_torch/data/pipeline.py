"""Deterministic sharded synthetic-token pipeline.

Every batch is a pure function of (seed, step, shard) so training is
reproducible across restarts and elastic rescaling: after a checkpoint
resume, batch `step` is bit-identical regardless of how many steps were
lost, and after a re-shard each host regenerates exactly its slice.

The "repeat" task (a random pattern of length `pattern_len` tiled across
the sequence) is learnable by every assigned family, so example training
runs show a real loss decrease rather than noise-fitting.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["DataConfig", "SyntheticLMData"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    task: str = "repeat"  # "repeat" | "uniform"
    pattern_len: int = 8
    num_shards: int = 1
    shard: int = 0


class SyntheticLMData:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global batch must divide by shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_shards

    def batch(self, step: int) -> dict:
        """Local shard of batch `step`: {"tokens": (B_local, S) int32}."""
        cfg = self.cfg
        rows = []
        for i in range(self.local_batch):
            global_row = cfg.shard * self.local_batch + i
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 65_536 + global_row)
            if cfg.task == "uniform":
                rows.append(rng.integers(0, cfg.vocab_size, cfg.seq_len))
            else:
                pat = rng.integers(0, cfg.vocab_size, cfg.pattern_len)
                reps = -(-cfg.seq_len // cfg.pattern_len)
                rows.append(np.tile(pat, reps)[: cfg.seq_len])
        tokens = np.stack(rows).astype(np.int32)
        return {"tokens": tokens}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
