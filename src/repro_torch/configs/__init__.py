"""Config registry: ``get_config(name)`` / ``list_archs()``.

The port's own copy of the JAX package's configs (plain dataclasses, one
module per assigned architecture), so that ``repro_torch`` imports nothing
of ``repro``.  ``tests/test_torch_imports.py`` holds every copy equal to its
original.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (
    ArchConfig,
    HybridSpec,
    MLASpec,
    MoESpec,
    SHAPES,
    ShapeSpec,
    SSMSpec,
    runnable_cells,
    skip_reason,
)

_ARCH_MODULES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2.5-32b": "qwen2_5_32b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "arctic-480b": "arctic_480b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-370m": "mamba2_370m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    mod_name = _ARCH_MODULES.get(name)
    if mod_name is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """All 40 (arch, shape) cells; use skip_reason() to filter runnable."""
    out = []
    for a in list_archs():
        for s in SHAPES:
            out.append((a, s))
    return tuple(out)


__all__ = [
    "ArchConfig",
    "HybridSpec",
    "MLASpec",
    "MoESpec",
    "SSMSpec",
    "SHAPES",
    "ShapeSpec",
    "get_config",
    "list_archs",
    "all_cells",
    "runnable_cells",
    "skip_reason",
]
