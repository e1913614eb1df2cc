"""The collectives of the instance-sharded engines on ``torch.distributed``
(DESIGN.md §7, §13), the port's counterpart of the collectives that
``repro.distributed.context.shard_map_compat`` lets the reference write
inside ``shard_map``.

The reference is one controller over many devices; the port is SPMD, one
process per rank, every rank calling the same entry point. An :class:`Axis`
is one axis of a mesh: the process group whose ranks fold together, their
count and this rank's position. ``Axis()`` (:data:`SOLO`) is a world of one:
every collective is the identity and launches nothing. The four
collectives map as:

* a tiled ``all_gather`` (:func:`all_gather`) →
  ``dist.all_gather_single`` (``all_gather_into_tensor`` where the
  installed torch lacks it);
* ``psum`` (:func:`psum`) → ``all_reduce(SUM)``, differentiable: its
  backward is the ``psum`` of the cotangent, the transpose of a sum, which
  gives each rank its gradient of the global loss where every rank's loss
  is its term of that loss (``training.train_loop``'s rule);
* ``pmin`` (:func:`pmin`) → ``all_reduce(MIN)``, which selects an element, so
  a (value, global instance id) pair folded with two of them keeps the
  dense engine's lowest-index tie-break bitwise (DESIGN.md §13.2);
* an untiled ``all_to_all`` over dim 0 (:func:`all_to_all`) →
  ``dist.all_to_all_single`` with equal blocks (the expert-parallel MoE
  dispatch, ``models.moe_ep``), differentiable: its backward is the same
  exchange of the cotangent;
* a tiled ``psum_scatter`` (:func:`psum_scatter`) →
  ``dist.reduce_scatter_single`` (``reduce_scatter_tensor`` where the
  installed torch lacks it) over the dim moved to the front, through the
  host under gloo (the data-parallel gradients' reduce-scatter onto the
  ZeRO-1 blocks);
* ``pmax`` (:func:`pmax`) → ``all_reduce(MAX)``;
* the two conjugate operators of tensor-parallel training, each an
  ``all_reduce(SUM)`` on one side of autograd and the identity on the
  other: :func:`copy_to` (identity forward, the ``psum`` of the cotangent
  backward) enters a block whose weights are cut over ``"model"`` from an
  activation every rank holds whole, and :func:`reduce_from` (the ``psum``
  forward, the identity backward) leaves a block whose ranks each hold a
  partial sum. Every model rank computes the same loss, so the cotangent of
  a replicated activation is the same on every rank; :func:`psum`'s own
  backward would scale each upstream gradient by the axis's size there.

Each call adds the elements it moves to :data:`PAYLOAD` under a tag:
``"step"`` for the slot dynamics (the ``payload`` metric stream reads it),
``"obs"`` for what only the metric streams need, ``"out"`` for replicating a
result at the end of a run, ``"ep"`` for the expert-parallel MoE layers
(their backward's exchanges too), ``"moe"`` for the global-batch router of
``models.moe.moe_ffn`` under data-parallel training (the POTUS price's
scale, each rank's expert counts and importance sums), ``"dp"`` for
data-parallel training (the gradients' reductions, the token count and the
norm, the parameters' all-gathers, checkpoints' gathers), ``"tp"`` for
tensor-parallel training (:func:`copy_to` and :func:`reduce_from`, the
vocab-cut loss's reductions, the norm's sum over "model") and ``"pp"`` for
the pipeline's hand-offs. An all-reduce of n elements moves n;
a tiled all-gather and an all-to-all move the n of their output, a
reduce-scatter the n of its input. On one rank nothing is counted.

Gloo stages CUDA tensors through the host (ranks sharing a card), so the
host waits for the producing kernels in any case; :func:`_collective`
synchronises the card first, so that under gloo the seconds it counts are
the collective's own. NCCL returns to the host once the exchange is queued
on the card, so under NCCL they are the host's time to enqueue it, and the
exchange itself is waited for by the next synchronise, outside the count.

:func:`set_mesh` and :func:`get_mesh` hold the ambient model mesh
(``launch.mesh.ModelMesh``) that the MoE blocks read to choose the
expert-parallel dispatch and ``training.make_train_step`` reads for its
data-parallel layout, the counterparts of the reference's;
:func:`set_cache_specs` and :func:`get_cache_specs` hold the decode cache's
specs (``distributed.sharding.decode_shardings``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["Axis", "SOLO", "PAYLOAD", "PayloadCounter", "all_gather", "all_to_all", "psum",
           "pmin", "pmax", "psum_scatter", "copy_to", "reduce_from", "grid_axes", "rank_device",
           "set_mesh", "get_mesh", "set_cache_specs", "get_cache_specs"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis: ``group`` (None: a world of one), its ``size`` and
    this rank's ``index`` along it."""

    group: Any = None
    size: int = 1
    index: int = 0


#: the axis of a world of one: every collective is the identity
SOLO = Axis()


def grid_axes(n_outer: int, n_inner: int) -> tuple[Axis, Axis, bool]:
    """The two axes of an ``n_outer x n_inner`` grid over the first
    ``n_outer * n_inner`` ranks of the default group, rank ``r`` at
    ``(r // n_inner, r % n_inner)``: (``outer``, the ranks that share this
    rank's inner index; ``inner``, those that share its outer index;
    whether this rank is on the grid). A rank off the grid gets
    :data:`SOLO` for both. Every rank of the group calls this, in the same
    order, since each subgroup is made by all of them."""
    world = dist.get_world_size()
    me = dist.get_rank()
    used = list(range(n_outer * n_inner))

    def axis(members: list[int]) -> Axis | None:
        if len(members) == world:
            group = dist.group.WORLD
        else:
            group = dist.new_group(members) if len(members) > 1 else None
        return Axis(group, len(members), members.index(me)) if me in members else None

    inner = outer = None
    for r in range(n_outer):
        inner = axis(used[r * n_inner:(r + 1) * n_inner]) or inner
    for c in range(n_inner):
        outer = axis(used[c::n_inner]) or outer
    return outer or SOLO, inner or SOLO, me < n_outer * n_inner


class PayloadCounter:
    """Elements the collectives moved, by tag, since the last reset; the
    calls that moved them and the host seconds they took, in all and by tag
    (under NCCL, the seconds to enqueue them: see :func:`_collective`)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.elements: dict[str, int] = {}
        self.tag_seconds: dict[str, float] = {}
        self.calls = 0
        self.seconds = 0.0

    def add(self, tag: str, n: int, seconds: float) -> None:
        self.elements[tag] = self.elements.get(tag, 0) + int(n)
        self.tag_seconds[tag] = self.tag_seconds.get(tag, 0.0) + seconds
        self.calls += 1
        self.seconds += seconds

    def n(self, tag: str = "step") -> int:
        return self.elements.get(tag, 0)


#: what every collective of this process moved (one process is one rank)
PAYLOAD = PayloadCounter()


def _collective(run, x: torch.Tensor, tag: str, count: int | None = None) -> torch.Tensor:
    """``run`` on ``x`` made contiguous, counted under ``tag`` (the output's
    elements unless ``count`` says otherwise). The card is synchronised
    first, so that under gloo (which stages a CUDA tensor through the host
    and waits for the kernels that produce it in any case) the seconds
    counted are the exchange's own; under NCCL they are the time to
    enqueue it."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = run(x.contiguous())
    PAYLOAD.add(tag, out.numel() if count is None else count, time.perf_counter() - t0)
    return out


def _all_reduce(x: torch.Tensor, axis: Axis, op, tag: str) -> torch.Tensor:
    if axis.size == 1:
        return x

    def run(buf):
        buf = buf.clone()  # all_reduce works in place
        dist.all_reduce(buf, op, group=axis.group)
        return buf
    return _collective(run, x, tag)


class _PSum(torch.autograd.Function):
    """The sum over the ranks; backward, the sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, axis, tag):
        ctx.axis, ctx.tag = axis, tag
        return _all_reduce(x, axis, dist.ReduceOp.SUM, tag)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, dist.ReduceOp.SUM, ctx.tag), None, None


def psum(x: torch.Tensor, axis: Axis, tag: str = "step") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, on every rank; its gradient
    is the sum of the ranks' cotangents."""
    if axis.size == 1:
        return x
    return _PSum.apply(x, axis, tag)


class _CopyTo(torch.autograd.Function):
    """The identity; backward, the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, axis, tag):
        ctx.axis, ctx.tag = axis, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, dist.ReduceOp.SUM, ctx.tag), None, None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the ranks; backward, the identity."""

    @staticmethod
    def forward(ctx, x, axis, tag):
        return _all_reduce(x, axis, dist.ReduceOp.SUM, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axis: Axis, tag: str = "tp") -> torch.Tensor:
    """``x`` itself, whose gradient is the sum of the ranks' cotangents: the
    entry of a block whose weights ``axis`` cuts (each rank's cotangent is
    its part of the whole one)."""
    if axis.size == 1:
        return x
    return _CopyTo.apply(x, axis, tag)


def reduce_from(x: torch.Tensor, axis: Axis, tag: str = "tp") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, whose gradient is the
    cotangent itself: the exit of a block whose ranks each hold a partial
    sum, or a term of the loss that every rank computes whole."""
    if axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis, tag)


def pmin(x: torch.Tensor, axis: Axis, tag: str = "step") -> torch.Tensor:
    """Elementwise minimum of ``x`` over the ranks of ``axis``, on every rank."""
    return _all_reduce(x, axis, dist.ReduceOp.MIN, tag)


def pmax(x: torch.Tensor, axis: Axis, tag: str = "step") -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``axis``, on every rank."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX, tag)


def _staged(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``buf`` where the backend of ``axis`` takes it: gloo's collectives
    other than all-reduce and all-gather move host memory, so a CUDA
    tensor goes through the host under gloo."""
    return buf.cpu() if buf.is_cuda and dist.get_backend(axis.group) == "gloo" else buf


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int = 0, tag: str = "dp") -> torch.Tensor:
    """``jax.lax.psum_scatter(x, scatter_dimension=dim, tiled=True)``: the
    sum of ``x`` over the ranks of ``axis``, cut into ``axis.size`` equal
    blocks along ``dim``, rank i keeping block i."""
    if axis.size == 1:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} is not {axis.size} "
                         "equal blocks")

    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

    def run(buf):
        staged = _staged(buf, axis)
        out = staged.new_empty((staged.shape[0] // axis.size, *staged.shape[1:]))
        scatter(out, staged, dist.ReduceOp.SUM, group=axis.group)
        return out.to(buf.device)

    out = _collective(run, x.movedim(dim, 0), tag, count=x.numel())
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, axis: Axis, tag: str = "step") -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (tiled)."""
    if axis.size == 1:
        return x
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

    def run(buf):
        out = buf.new_empty((axis.size * buf.shape[0], *buf.shape[1:]))
        gather(out, buf, group=axis.group)
        return out
    return _collective(run, x, tag)


def _all_to_all(x: torch.Tensor, axis: Axis, tag: str) -> torch.Tensor:
    def run(buf):
        staged = _staged(buf, axis)
        out = torch.empty_like(staged)
        dist.all_to_all_single(out, staged, group=axis.group)
        return out.to(buf.device)
    return _collective(run, x, tag)


class _AllToAll(torch.autograd.Function):
    """The exchange of equal blocks; backward, the same exchange of the
    cotangent (block j of the gradient goes back to rank j)."""

    @staticmethod
    def forward(ctx, x, axis, tag):
        ctx.axis, ctx.tag = axis, tag
        return _all_to_all(x, axis, tag)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis, ctx.tag), None, None


def all_to_all(x: torch.Tensor, axis: Axis, tag: str = "ep") -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` on
    ``x`` cut into ``axis.size`` equal blocks along dim 0: block j goes to
    rank j of ``axis``, and block j of the result came from rank j.
    Differentiable (the backward is the same exchange). Gloo moves host
    memory, so under gloo a CUDA block is copied to the host and the result
    back to the card; NCCL exchanges the card's memory directly."""
    if axis.size == 1:
        return x
    if x.shape[0] % axis.size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is not {axis.size} equal blocks")
    return _AllToAll.apply(x, axis, tag)


def rank_device(device: torch.device) -> torch.device:
    """The device of this rank for a run on ``device``: ``cuda:<local rank>``
    when the machine has that many cards; several ranks share a card only
    under gloo (NCCL refuses two ranks on one device, so that raises)."""
    if device.type != "cuda" or not dist.is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    n = torch.cuda.device_count()
    if local < n:
        return torch.device("cuda", local)
    if dist.get_backend() == "nccl":
        raise RuntimeError(
            f"rank {dist.get_rank()} (local rank {local}) has no card of its own ({n} on this "
            "machine) and NCCL refuses two ranks on one device; start one rank per card, or "
            "use the gloo backend to share a card")
    return torch.device("cuda", local % n)


_MESH = None


def set_mesh(mesh) -> None:
    """Make ``mesh`` (a ``launch.mesh.ModelMesh``, or None) the ambient model
    mesh of this process; place the model's experts on it first
    (``models.moe_ep.place_``)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    """The ambient model mesh, None unless :func:`set_mesh` set one."""
    return _MESH


_CACHE_SPECS = None


def set_cache_specs(specs) -> None:
    """The decode cache's specs (``{name: PartitionSpec}``, from
    ``distributed.sharding.decode_shardings``), or None."""
    global _CACHE_SPECS
    _CACHE_SPECS = specs


def get_cache_specs():
    """The decode cache's specs, None unless :func:`set_cache_specs` set them."""
    return _CACHE_SPECS
