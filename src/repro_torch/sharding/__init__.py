"""Partitioning: logical-axis rules, batch and cache activation specs, and
their placement as DTensors."""

from ..act_sharding import (DEFAULT_ACT_RULES, activation_rules, mesh_shape, placements,
                            shard_act)
from .partition import (
    SERVE_RULES,
    TRAIN_RULES,
    batch_axes,
    batch_dim_spec,
    distribute_tree,
    empty_placed,
    local_shape,
    param_pspecs,
    spec_for_axes,
)
from .specs import batch_pspecs, cache_pspecs

__all__ = [
    "SERVE_RULES",
    "TRAIN_RULES",
    "batch_axes",
    "batch_dim_spec",
    "distribute_tree",
    "empty_placed",
    "local_shape",
    "param_pspecs",
    "spec_for_axes",
    "batch_pspecs",
    "cache_pspecs",
    "DEFAULT_ACT_RULES",
    "activation_rules",
    "mesh_shape",
    "placements",
    "shard_act",
]
