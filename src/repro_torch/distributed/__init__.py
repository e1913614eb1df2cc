"""Process groups, collectives and worlds of ranks for the instance-sharded
engines (``core.sharded``), the expert-parallel MoE layers
(``models.moe_ep``) and data- and tensor-parallel training (``training``): :mod:`.context`
holds the mesh axes and the rule that lays ranks out on a grid of them
(:func:`~.context.grid_axes`), the collectives with their payload counter
and the ambient model mesh, :mod:`.sharding` the layouts of parameters,
optimizer state, batches and caches on a model mesh, :mod:`.pipeline` the
GPipe schedule over a stage axis, :mod:`.world` starts a world of ranks in
child processes."""
from .context import (PAYLOAD, SOLO, Axis, PayloadCounter, all_gather, all_to_all, copy_to,
                      get_cache_specs, get_mesh, grid_axes, pmax, pmin, psum, psum_scatter,
                      rank_device, reduce_from, set_cache_specs, set_mesh)
from .world import call_each, spawn_world

__all__ = ["Axis", "SOLO", "PAYLOAD", "PayloadCounter", "all_gather", "all_to_all", "psum",
           "pmin", "pmax", "psum_scatter", "copy_to", "reduce_from", "grid_axes", "rank_device",
           "set_mesh", "get_mesh", "set_cache_specs", "get_cache_specs", "spawn_world",
           "call_each"]
