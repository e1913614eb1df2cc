"""Gradient compression with error feedback — the port's counterpart of
``repro.training.compression``: symmetric int8 row-wise quantisation of
each gradient, the quantisation error carried to the next step (the
EF-SGD lineage), so the compressed stream is unbiased over time.

A row is the reference leaf's last axis. The port's ``nn.Linear`` weights
are the reference's (in, out) matrices transposed to (out, in), so their
rows run along dim 0 here (one scale per input feature); every other
tensor keeps the reference's layout and quantises along its last axis. A
1-D tensor is one row, whether the reference's leaf is a vector or a row
of a stacked (layers, width) leaf.

Across ranks the gradients and the error state are this rank's blocks
(the moments' layout, ``distributed.sharding``): where a block cuts a row,
the row's largest magnitude is a ``pmax`` over the axes that cut it
(``"data"``, and ``"model"`` under tensor-parallel training), so each
block is quantised with its global row's scale, as the reference's
compression of a sharded leaf is.
"""
from __future__ import annotations

import torch

from ..distributed.context import pmax

__all__ = ["init_error_state", "compress_grads", "decompress"]


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _row_dim(name: str, t: torch.Tensor) -> int | None:
    """The axis a row of ``name`` runs along: 0 for an ``nn.Linear`` weight
    (a 2-D ``*.weight``), -1 otherwise; None for a 1-D tensor (one row)."""
    if t.dim() < 2:
        return None
    return 0 if t.dim() == 2 and name.endswith(".weight") else -1


def _quantize(g32, dim, sh=None):
    """Symmetric int8 quantisation with one scale per row. Returns (q, scale).
    ``sh``: the block's sharding (None: a whole tensor); a row it cuts takes
    its largest magnitude over the ranks."""
    amax = g32.abs().max() if dim is None else g32.abs().amax(dim=dim, keepdim=True)
    if sh is not None:
        for d, names in sh.cuts():
            if dim is None or dim % g32.dim() == d:
                for a in names:
                    amax = pmax(amax, sh.mesh.axis(a), "tp" if a == "model" else "dp")
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q, scale):
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: dict, error_state: dict, shardings: dict | None = None):
    """Apply error feedback and quantise. Returns (the dequantised
    gradients in their own types, the new error state). ``shardings``:
    ``{name: Sharding}`` of the blocks that ``grads`` and ``error_state``
    hold (None: whole tensors)."""
    new_grads, new_err = {}, {}
    for name, g in grads.items():
        target = g.float() + error_state[name]
        sh = None if shardings is None else shardings.get(name)
        deq = decompress(*_quantize(target, _row_dim(name, g), sh))
        new_grads[name] = deq.to(g.dtype)
        new_err[name] = target - deq
    return new_grads, new_err
