"""Process groups, collectives and worlds of ranks for the instance-sharded
engines (``core.sharded``): :mod:`.context` holds the mesh axes and the
three collectives with their payload counter, :mod:`.world` starts a world
of ranks in child processes."""
from .context import PAYLOAD, SOLO, Axis, PayloadCounter, all_gather, pmin, psum, rank_device
from .world import call_each, spawn_world

__all__ = ["Axis", "SOLO", "PAYLOAD", "PayloadCounter", "all_gather", "psum", "pmin",
           "rank_device", "spawn_world", "call_each"]
