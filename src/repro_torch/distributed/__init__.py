"""Sharding rules: logical param/batch/cache axes -> partition specs and
DTensor placements; activation constraints (``act_shard``)."""

from .sharding import (
    AbstractMesh,
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    place,
    shard_batch,
    shard_cache,
    shard_model,
    shard_opt_state,
    to_placements,
    zero1_opt_pspecs,
)

__all__ = ["AbstractMesh", "batch_pspecs", "cache_pspecs", "param_pspecs", "place",
           "shard_batch", "shard_cache", "shard_model", "shard_opt_state", "to_placements",
           "zero1_opt_pspecs"]
