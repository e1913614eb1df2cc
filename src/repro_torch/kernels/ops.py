"""Public wrappers around the port's kernels.

Each is the port's counterpart of the same name in ``repro.kernels.ops``.
The device of the tensors decides the route: CUDA tensors launch the
hand-written kernel (or raise), CPU tensors take the plain PyTorch version.
:data:`plain` binds the same names to the plain versions on any device, so
that a run on the card can take the plain route to compare against.

Gradients: on the card ``flash_attention`` is a ``torch.autograd.Function``
whose forward is the flash attention kernel and whose backward is the
flash attention backward kernel, so training never differentiates the plain
version there; on the CPU autograd differentiates the plain version. The
SSD kernel has no backward yet: ``ssd_intra_chunk`` raises on CUDA inputs
that require grad (the plain route on the CPU stays differentiable).
"""
from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import torch

from .cohort_drain import cohort_drain_call, cohort_drain_split_plain
from .decode_attention import decode_attention_call, decode_attention_plain
from .flash_attention import (flash_attention_bwd_call, flash_attention_call,
                              flash_attention_plain)
from .potus_price import potus_price_call, potus_price_plain
from .potus_schedule import potus_schedule_alloc_plain, potus_schedule_call
from .potus_slot import potus_slot_call, potus_slot_step_plain
from .ssd_scan import ssd_intra_chunk_call, ssd_intra_chunk_plain

__all__ = ["flash_attention", "decode_attention", "ssd_intra_chunk", "potus_slot_step",
           "potus_price", "potus_schedule_alloc", "cohort_drain_split", "plain"]


def _flash_attention_with(fn, q, k, v, causal):
    """Model-native (B, S, H, D) in and out around the kernel-native
    (B, H, S, D) ``fn`` (axes swapped as views, no copy)."""
    return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Kernel-native (B, H, S, D) flash attention on the card: the forward
    kernel, and the backward kernel for dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = flash_attention_call(q, k, v, causal)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd_call(q, k, v, dout, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D); differentiable
    on either route."""
    fn = flash_attention_plain if q.device.type == "cpu" else _FlashAttention.apply
    return _flash_attention_with(fn, q, k, v, causal)


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B, Hq, D); caches: (B, S, Hkv, D); pos: (B,) -> (B, Hq, D)."""
    fn = decode_attention_plain if q.device.type == "cpu" else decode_attention_call
    return fn(q, k_cache, v_cache, pos.to(torch.int32))


def ssd_intra_chunk(xc, dtc, dA_cum, Bc, Cc):
    """xc (b, nc, Q, H, P); dtc, dA_cum (b, nc, Q, H); Bc, Cc (b, nc, Q, S) ->
    (y_diag (b, nc, Q, H, P), states (b, nc, H, P, S) float32)."""
    if xc.device.type == "cpu":
        return ssd_intra_chunk_plain(xc, dtc, dA_cum, Bc, Cc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xc, dtc, dA_cum, Bc, Cc)):
        raise NotImplementedError(
            "ssd_intra_chunk: the SSD kernel has no backward yet, so SSM and hybrid models "
            "do not train on the card (ROADMAP.md, section 1, module item 7: the SSD backward "
            "kernel); train them on the CPU, or run the forward under torch.no_grad()")
    return ssd_intra_chunk_call(xc, dtc, dA_cum, Bc, Cc)


def potus_slot_step(consts, state, act, pred, nxt, t0, *, scheduler="potus", age_cap=64,
                    n_slots=1):
    """Fused slot step (DESIGN.md §12): ``n_slots`` consecutive slots of
    schedule, drain, land, serve and queue/age update. Returns ``(state,
    metrics)`` with per-slot ``metrics = (backlog, cost, capped, served)``."""
    step = potus_slot_step_plain if act.device.type == "cpu" else potus_slot_call
    return step(consts, state, act, pred, nxt, t0, scheduler=scheduler, age_cap=age_cap,
                n_slots=n_slots)


def potus_price(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta):
    """(I, I) price matrix of eq. 16, +inf off the DAG edges."""
    fn = potus_price_plain if q_in.device.type == "cpu" else potus_price_call
    return fn(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta)


def potus_schedule_alloc(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma, V, beta):
    """Fused price + water-fill allocation (DESIGN.md §7); returns X (I, I)
    before the mandatory dispatch of actual arrivals."""
    fn = potus_schedule_alloc_plain if q_in.device.type == "cpu" else potus_schedule_call
    return fn(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma, V, beta)


def cohort_drain_split(src_ext, shipped, ratio, inst_comp, age_bucket):
    """Fused segmented drain + proportional target split of the cohort engine
    (DESIGN.md §8); returns the landing buckets ``land`` (I, Atot)."""
    fn = cohort_drain_split_plain if src_ext.device.type == "cpu" else cohort_drain_call
    return fn(src_ext, shipped, ratio, inst_comp, age_bucket)


#: the plain versions under the wrappers' names, on any device
plain = SimpleNamespace(flash_attention=partial(_flash_attention_with, flash_attention_plain),
                        decode_attention=decode_attention_plain,
                        ssd_intra_chunk=ssd_intra_chunk_plain,
                        potus_slot_step=potus_slot_step_plain,
                        potus_price=potus_price_plain,
                        potus_schedule_alloc=potus_schedule_alloc_plain,
                        cohort_drain_split=cohort_drain_split_plain)
