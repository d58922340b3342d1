"""Sharding rules: parameter/activation PartitionSpecs per mesh."""

from .rules import (
    activation_specs,
    cache_pspec,
    cache_specs_tree,
    param_pspecs,
    shard_params,
)

__all__ = [
    "param_pspecs",
    "activation_specs",
    "cache_pspec",
    "cache_specs_tree",
    "shard_params",
]
