"""Model meshes — the port's counterpart of ``repro.launch.mesh``.

The reference lays its devices out as a ``jax.sharding.Mesh`` with axes
``("data", "model")`` (``("pod", "data", "model")`` across pods); the port
is SPMD, one process per rank, and a :class:`ModelMesh` is that mesh as one
rank sees it: an :class:`~repro_torch.distributed.context.Axis` per name.
Rank ``r`` of an ``n_data x n_model`` mesh sits at ``(r // n_model,
r % n_model)``, where ``jax.devices()[:n].reshape(n_data, n_model)`` puts
device ``r``; the subgroups come from ``distributed.grid_axes``, whose
outer axis plays ``"data"`` and inner axis ``"model"``.
:func:`make_axis_mesh` builds a mesh of one named axis (the pipeline's
``"stage"``). Building a mesh makes process subgroups, so every rank of the
default group builds it, in the same order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

from ..distributed.context import SOLO, Axis, grid_axes

__all__ = ["ModelMesh", "make_production_mesh", "make_mesh_shape", "make_host_mesh",
           "make_axis_mesh"]


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """Named axes in the reference's order, each this rank's
    :class:`Axis`, and whether this rank is on the mesh (``member``: a
    mesh takes a prefix of the world's ranks)."""

    axes: tuple[tuple[str, Axis], ...] = (("data", SOLO), ("model", SOLO))
    member: bool = True

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        """``{name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {name: ax.size for name, ax in self.axes}

    def axis(self, name: str) -> Axis:
        return dict(self.axes)[name]

    @property
    def idle(self) -> bool:
        """Whether some ranks of the world are off the mesh."""
        return _world_size() > int(np.prod(list(self.shape.values())))

    def share(self, obj):
        """``obj`` of the mesh's first rank (rank 0 of the world) on every
        rank: one broadcast when some ranks are off the mesh, else ``obj``
        itself. Every rank of the world calls it."""
        if not self.idle:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh_shape(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """The reference's production mesh over the first 256 ranks (512 across
    two pods); ``ValueError`` naming the count when the world is smaller."""
    shape, _ = make_mesh_shape(multi_pod=multi_pod)
    n = int(np.prod(shape))
    if _world_size() < n:
        raise ValueError(f"need {n} ranks for mesh {shape}, found {_world_size()}")
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh is not ported yet (ROADMAP.md, section 1, module item 5b: "
            "launch/dryrun.py)")
    return make_host_mesh(*shape)


def make_host_mesh(n_data: int = 1, n_model: int = 1) -> ModelMesh:
    """An ``n_data x n_model`` mesh over the first ``n_data * n_model``
    ranks (tests, examples); a 1 x 1 mesh without a process group."""
    n = n_data * n_model
    if n < 1 or n > _world_size():
        raise ValueError(f"need {n} ranks for mesh ({n_data}, {n_model}), "
                         f"found {_world_size()}")
    if not dist.is_initialized():
        return ModelMesh()
    data, model, member = grid_axes(n_data, n_model)
    return ModelMesh((("data", data), ("model", model)), member=member)


def make_axis_mesh(n: int, name: str = "stage") -> ModelMesh:
    """A mesh of one axis named ``name`` over the first ``n`` ranks (a
    pipeline's stages); without a process group a mesh of one."""
    if n < 1 or n > _world_size():
        raise ValueError(f"need {n} ranks for a {name!r} axis of {n}, found {_world_size()}")
    if not dist.is_initialized():
        return ModelMesh(((name, SOLO),))
    axis, _, member = grid_axes(n, 1)
    return ModelMesh(((name, axis),), member=member)
