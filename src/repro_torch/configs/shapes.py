"""Input-shape registry: the 4 assigned shapes and per-(arch, shape)
input specs for the dry run (no allocation).

  train_4k    seq=4096   global_batch=256  -> train_step
  prefill_32k seq=32768  global_batch=32   -> prefill_step
  decode_32k  seq=32768  global_batch=128  -> serve_step (1 token, KV=seq)
  long_500k   seq=524288 global_batch=1    -> serve_step; sub-quadratic only

`applicable()` encodes the skip rules (long_500k only for SSM/hybrid).
Where the reference returns ``jax.ShapeDtypeStruct``s, the specs here are
tensors on the ``meta`` device: shapes and dtypes, no storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import DTYPES

__all__ = ["SHAPES", "ShapeSpec", "applicable", "input_specs", "cache_specs"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _spec(shape: "str | ShapeSpec") -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and not cfg.long_context_ok:
        return False, ("full quadratic attention: 512k decode KV cache is "
                       "intentionally out of scope (sub-quadratic archs only)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: "str | ShapeSpec") -> dict:
    """Meta-tensor stand-ins for every model input of this cell (a name of
    `SHAPES` or a `ShapeSpec`)."""
    sp = _spec(shape)
    b, s = sp.global_batch, sp.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    specs: dict = {}
    if sp.kind == "train":
        specs["tokens"] = meta((b, s), torch.int32)
        specs["labels"] = meta((b, s), torch.int32)
    elif sp.kind == "prefill":
        specs["tokens"] = meta((b, s), torch.int32)
    else:  # decode: one new token against a cache of length s
        specs["tokens"] = meta((b, 1), torch.int32)
        specs["positions"] = meta((b, 1), torch.int32)
    if cfg.family in ("vlm", "audio") and sp.kind != "decode":
        specs["frontend"] = meta((b, cfg.frontend_seq, cfg.frontend_dim),
                                 DTYPES[cfg.activation_dtype])
    return specs


def cache_specs(cfg: ArchConfig, shape: "str | ShapeSpec") -> dict:
    """Meta tensors of the decode-cache tree (serve_step input)."""
    from repro_torch.models.model import Model

    sp = _spec(shape)
    return Model(cfg, "meta").init_caches(sp.global_batch, sp.seq_len)
