"""Assigned-architecture registry: `get_config(name)` / `ARCHS`."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCHS = [
    "hymba-1.5b",
    "llama-3.2-vision-11b",
    "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b",
    "llama3-8b",
    "deepseek-67b",
    "qwen3-14b",
    "deepseek-coder-33b",
    "mamba2-780m",
    "whisper-medium",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCHS", "get_config"]
