"""Process groups, collectives and worlds of ranks for the instance-sharded
engines (``core.sharded``) and the expert-parallel MoE layers
(``models.moe_ep``): :mod:`.context` holds the mesh axes and the rule that lays
ranks out on a grid of them (:func:`~.context.grid_axes`), the four
collectives with their payload counter and the ambient model mesh,
:mod:`.world` starts a world of ranks in child processes."""
from .context import (PAYLOAD, SOLO, Axis, PayloadCounter, all_gather, all_to_all, get_mesh,
                      grid_axes, pmin, psum, rank_device, set_mesh)
from .world import call_each, spawn_world

__all__ = ["Axis", "SOLO", "PAYLOAD", "PayloadCounter", "all_gather", "all_to_all", "psum",
           "pmin", "grid_axes", "rank_device", "set_mesh", "get_mesh", "spawn_world", "call_each"]
