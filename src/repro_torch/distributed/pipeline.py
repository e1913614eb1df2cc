"""GPipe-style pipeline parallelism over a stage axis of ranks — the port's
counterpart of ``repro.distributed.pipeline``.

Stages live on one mesh axis (``launch.mesh.make_axis_mesh(n, "stage")``);
the stage parameters are stacked ``(n_stages, ...)`` and rank s of the axis
runs stage s with its row. Microbatches stream through the classic GPipe
schedule: at tick t, stage s processes microbatch t - s; the hand-off to the
next stage is a point-to-point ring exchange (``dist.batch_isend_irecv`` on
the axis's group, through the host under gloo), counted under the
``"pp"`` tag. After the last tick the last stage's outputs reach every rank
of the axis by a ``psum`` in which the other stages add zeros, as in the
reference. SPMD: every rank of the axis calls :func:`pipeline_apply` with
the same arguments.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .context import Axis, _collective, _staged, psum

__all__ = ["pipeline_apply"]


def _ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.ppermute(x, perm=[(i, (i + 1) % n)])``: this rank's ``x`` to
    the next rank of ``axis``, the previous rank's back."""
    if axis.size == 1:
        return x
    ranks = dist.get_process_group_ranks(axis.group)
    nxt, prev = ranks[(axis.index + 1) % axis.size], ranks[(axis.index - 1) % axis.size]

    def run(buf):
        send = _staged(buf, axis)
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, axis.group),
                                           dist.P2POp(dist.irecv, recv, prev, axis.group)]):
            req.wait()
        return recv.to(buf.device)

    return _collective(run, x, "pp")


def _row(tree, s: int):
    """Row ``s`` of every leaf of ``tree`` (nested dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _row(v, s) for k, v in tree.items()}
    return tree[s]


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x: (mb, ...)) -> (mb, ...)
    stage_params,  # nested dicts of tensors, leaves (n_stages, ...)
    x: torch.Tensor,  # (n_micro, mb, ...) microbatched input, the same on every rank
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages with the GPipe
    schedule. Returns the (n_micro, mb, ...) outputs of the last stage, on
    every rank of the axis."""
    ax = mesh.axis(axis)
    n_stages, sid = ax.size, ax.index
    n_micro = x.shape[0]
    p_stage = _row(stage_params, sid)
    last = n_stages - 1
    act = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (clamped); the others take the hand-off
        if sid == 0:
            act = x[min(t, n_micro - 1)]
        out = stage_fn(p_stage, act) if 0 <= t - sid < n_micro else act
        if sid == last and t - last >= 0:  # the last stage banks its finished microbatch
            outs[t - last] = out
        act = _ring_shift(out, ax)  # the last stage's hand-off to stage 0 is ignored
    return psum(outs if sid == last else torch.zeros_like(outs), ax, "pp")
