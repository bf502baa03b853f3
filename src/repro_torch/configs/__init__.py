"""Assigned-architecture registry: one module per architecture, each exporting
``CONFIG`` (the exact published configuration) and ``SMOKE`` (a reduced
same-family configuration for CPU smoke tests).

``ARCH_NAMES`` are the architectures the JAX package has too; ``get_config``
also knows the port's own (``PORT_ARCH_NAMES``: granite-4.0-h-small, whose
held expert share, shared expert, NoPE attention, muP multipliers and tied
head the JAX package has not)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "llama_3_2_vision_11b",
    "olmoe_1b_7b",
    "llama4_scout_17b_a16e",
    "phi4_mini_3_8b",
    "granite_20b",
    "deepseek_67b",
    "qwen3_0_6b",
    "mamba2_370m",
    "jamba_1_5_large_398b",
    "seamless_m4t_large_v2",
    "granite_4_0_h_small",
]

# public ids use dashes/dots like the assignment sheet
_ALIASES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "granite-20b": "granite_20b",
    "deepseek-67b": "deepseek_67b",
    "qwen3-0.6b": "qwen3_0_6b",
    "mamba2-370m": "mamba2_370m",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = list(_ALIASES)

# the port's own configurations
_ALIASES["granite-4.0-h-small"] = "granite_4_0_h_small"
PORT_ARCH_NAMES = ["granite-4.0-h-small"]


def _module(name: str):
    key = _ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
