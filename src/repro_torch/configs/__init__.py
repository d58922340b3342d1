"""Assigned-architecture registry: ``get_config(name)`` / ``ARCHS``."""

from importlib import import_module
from typing import Dict, List

from ..models.config import ArchConfig

_MODULES = {
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "arctic-480b": "arctic_480b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-76b": "internvl2_76b",
    "qwen1.5-32b": "qwen1_5_32b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-3-8b": "granite_3_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCHS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCHS}
