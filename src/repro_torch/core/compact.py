"""One-dispatch slot math for the fused cohort engine, in PyTorch
(DESIGN.md §12).

The port's counterpart of ``repro.core.compact``. Each scheduler's
per-slot decision is kept in the
successor-component-compact form

    CompactDecision(shipped, point, j_point, even_per, cost)

(see the reference module for the derivation): per (source instance,
successor component) the mass shipped, the part aimed at one instance
``j_point`` (``I`` = none), the part landing on each alive instance of the
component, and the slot's communication cost. POTUS's cheapest candidate per
(container, component) is an O(K·I) reduction shared by all rows, so no
(I, I) tensor is ever formed.

:func:`compact_slot_step` is the plain version of the hand-written slot
kernel (``kernels/csrc/potus_slot.cu``). It is dtype-generic, so the CPU
tests hold it against the reference in f32 and f64. ``kernel_safe`` keeps
the reference's name and selects what the kernel computes: the O(C²)
precedence-rank water-fill (:func:`_fill_rows_rank`) and ``_BIG`` in place of
+inf for a component without instances. ``kernel_safe=False`` takes the sort
water-fill (:func:`_fill_rows_sort`). The two agree bitwise whenever their
prefix sums round alike, which they always do on the dyadic tier. The
reference's other kernel-safe substitutions (one-hot contractions for
gathers and scatters) exist only because Pallas on the TPU cannot lower a
gather; PyTorch can, and the results are equal.

With ``metrics_spec`` (DESIGN.md §14) the step also returns the selected
metric streams' rows (:func:`slot_streams`); the slot kernel has no streams,
so a run with metrics takes this step, as the reference's does.

With ``axis`` (DESIGN.md §13) the decision and the step run on one rank's
block of instance rows and fold with the collectives of
``distributed.context``: the sharded cohort-fused scan.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..distributed.context import Axis, all_gather, pmin, psum
from ..obs.metrics import compute_scan_streams, scan_stream_names
from .potus import _fill_components

__all__ = [
    "COMPACT_SCHEDULERS", "CompactProblem", "CompactDecision", "StepConsts",
    "compact_decide", "compact_slot_step", "drain_ages", "kernel_layout", "slot_streams",
]

_EPS = 1e-12  # same negligible-mass threshold as the engines' FIFOs
_INF = float("inf")
_BIG = 1e30  # finite stand-in for +inf, as in the kernel

#: schedulers with a compact one-dispatch decision
COMPACT_SCHEDULERS = ("potus", "shuffle", "jsq")


class CompactProblem(NamedTuple):
    """Per-slot scheduling inputs (alive counts, effective gamma)."""

    inst_comp: torch.Tensor  # (I,) int32 — component of each instance
    inst_cont: torch.Tensor  # (I,) int32 — container of each instance
    gamma: torch.Tensor  # (I,) effective transmission budget
    comp_count: torch.Tensor  # (C,) alive instances per component
    adj_rows: torch.Tensor  # (I, C) 1.0 where comp(i) -> c is a DAG edge
    alive: torch.Tensor  # (I,) 1.0 on alive instances


class CompactDecision(NamedTuple):
    shipped: torch.Tensor  # (I, C)
    point: torch.Tensor  # (I, C) mass aimed at j_point
    j_point: torch.Tensor  # (I, C) int64 target instance; I = none
    even_per: torch.Tensor  # (I, C) mass landing on each alive instance of c
    cost: torch.Tensor  # () communication cost of the slot


def _colmin_per_comp(t1: torch.Tensor, inst_comp: torch.Tensor, C: int, kernel_safe: bool):
    """Per-component column reduction of ``t1`` (K, I): value min ``M`` (K, C)
    and lowest-index argmin ``J`` (K, C); ``I`` where a component is empty."""
    K, I = t1.shape
    idx = inst_comp.long().unsqueeze(0).expand(K, I)
    empty = _BIG if kernel_safe else _INF
    M = torch.full((K, C), empty, dtype=t1.dtype, device=t1.device).scatter_reduce(
        1, idx, t1, "amin", include_self=True)
    iota = torch.arange(I, device=t1.device).expand(K, I)
    hit = torch.where(t1 == torch.gather(M, 1, idx), iota, I)
    J = torch.full((K, C), I, dtype=torch.long, device=t1.device).scatter_reduce(
        1, idx, hit, "amin", include_self=True)
    return M, J


def _rows_add(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[idx[k]] += src[k]`` for every k, in place. On CUDA through the
    sort-based ``index_put_(accumulate=True)``, which sums each target's
    terms in one fixed order (``index_add_`` there sums with atomics, in an
    order that changes from run to run); on the CPU ``index_add_``, which
    sums them in ascending ``k``."""
    if out.is_cuda:
        return out.index_put_((idx,), src, accumulate=True)
    return out.index_add_(0, idx, src)


def _u_col_sums(U: torch.Tensor, cp: CompactProblem, axis: Axis | None = None) -> torch.Tensor:
    """(K, C) per-component sums of alive columns of ``U[:, k_j]``. Under
    sharding (``axis``) the columns are this rank's instances and the (K, C)
    partials fold with one ``psum`` (it re-associates the dense column
    order: invisible on the dyadic tier, the identity on one rank)."""
    C = cp.comp_count.shape[0]
    u_cols = U[:, cp.inst_cont.long()] * cp.alive[None, :]  # (K, I)
    out = torch.zeros((C, U.shape[0]), dtype=U.dtype, device=U.device)
    out = _rows_add(out, cp.inst_comp.long(), u_cols.T).T
    return out if axis is None else psum(out, axis)


def _fold_min_with_payload(m_loc: torch.Tensor, p_loc: torch.Tensor, sentinel: int,
                           axis: Axis) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a (value, payload) argmin pair across ``axis``: the global min of
    ``m_loc`` and the smallest payload among the ranks attaining it. With
    payloads lifted to global instance ids this is the dense engine's
    lowest-global-index tie-break, bitwise (``pmin`` selects elements)."""
    m = pmin(m_loc, axis)
    p = pmin(torch.where(m_loc == m, p_loc, sentinel), axis)
    return m, p


def _owner_gather(idx_g: torch.Tensor, values: torch.Tensor, off: int, n_local: int,
                  sentinel_fill: int, axis: Axis) -> torch.Tensor:
    """``values[idx_g]`` for global instance ids ``idx_g`` when only the
    owning rank holds ``values`` (its (n_local,) row block): the owner gives
    the element, every other rank a large int that ``pmin`` folds away.
    Out-of-range ids (the ``I_all`` "no target" sentinel) give
    ``sentinel_fill``; callers read those only where the mass is zero."""
    own = (idx_g >= off) & (idx_g < off + n_local)
    local = torch.clamp(idx_g - off, 0, n_local - 1)
    contrib = torch.where(own, values.long()[local], 2**30)
    return torch.clamp_max(pmin(contrib, axis), sentinel_fill)


def _fill_rows_sort(m, j_c, budget, gamma):
    """(I, C) sort-based water-fill, back in component order."""
    fill, _, perm = _fill_components(m, j_c, budget, gamma)
    return torch.zeros_like(fill).scatter_(1, perm, fill)


def _fill_rows_rank(m, j_c, budget, gamma):
    """(I, C) precedence-rank water-fill — the sort-free form the kernel
    computes: entry d precedes entry e iff ``(m_d, j_d) < (m_e, j_e)``
    lexicographically, so the budget mass ahead of each entry is one masked
    sum instead of a cumsum over a sorted axis."""
    prec = (m[:, :, None] < m[:, None, :]) | (
        (m[:, :, None] == m[:, None, :]) & (j_c[:, :, None] < j_c[:, None, :])
    )  # (I, C, C): [i, d, e] = entry d precedes entry e
    before = (budget[:, :, None] * prec.to(budget.dtype)).sum(1)
    after = before + budget
    g = gamma[:, None]
    return torch.minimum(after, g) - torch.minimum(before, g)


def _potus_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe, axis=None):
    I = cp.inst_comp.shape[0]  # this rank's rows under sharding
    C = cp.comp_count.shape[0]
    I_all = I if axis is None else I * axis.size
    cont = cp.inst_cont.long()
    edge = cp.adj_rows > 0.0
    big = torch.full((), _BIG, dtype=U.dtype, device=U.device)
    # shared per-(container, component) cheapest candidate: O(K·I), no (I, I)
    t1 = torch.where((cp.alive > 0.0)[None, :], V * U[:, cont] + q_in[None, :], big)
    M, J = _colmin_per_comp(t1, cp.inst_comp, C, kernel_safe)
    if axis is not None:
        # fold the rank-local (M, J) into the global cheapest candidate: one
        # small pmin pair, J lifted to global instance ids first so that the
        # dense lowest-index tie-break holds bitwise
        off = axis.index * I
        J = torch.where(J < I, J + off, I_all)
        M, J = _fold_min_with_payload(M, J, I_all, axis)
    m_raw = M[cont] - beta * q_out  # row-constant shift
    cand = edge & (m_raw < 0.0)
    m = torch.where(cand, m_raw, _INF)
    j_c = torch.where(edge, J[cont], I_all)
    budget = torch.where(cand, torch.clamp_min(q_out, 0.0), 0.0)
    fill_rows = _fill_rows_rank if kernel_safe else _fill_rows_sort
    fill = fill_rows(m, j_c, budget, cp.gamma)
    # mandatory dispatch (eq. 4): even split over the alive instances
    can_even = edge & (cp.comp_count > 0.0)[None, :]
    shortfall = torch.where(can_even, torch.clamp_min(must_send - fill, 0.0), 0.0)
    even_per = shortfall / torch.clamp_min(cp.comp_count, 1.0)[None, :]
    u_sum = _u_col_sums(U, cp, axis)  # (K, C)
    if axis is None:
        u_point = U[cont[:, None], cont[torch.clamp_max(j_c, I - 1)]]  # fill is 0 where j_c == I
    else:
        # only the target's owning rank knows its container: one more (K, C)
        # integer pmin; the K - 1 clamp is reached only where fill == 0
        k_j = _owner_gather(J, cp.inst_cont, off, I, U.shape[0] - 1, axis)  # (K, C)
        u_point = U[cont[:, None], k_j[cont]]
    # under sharding this rank's partial; compact_slot_step folds it
    cost = (fill * u_point).sum() + (even_per * u_sum[cont]).sum()
    return CompactDecision(fill + shortfall, fill, j_c, even_per, cost)


def _ship_amounts_compact(cp, q_out, must_send):
    """Gamma-throttled proportional shipment (``baselines._ship_amounts``)."""
    total = q_out.sum(dim=1, keepdim=True)
    scale = torch.where(
        total > 0, torch.clamp_max(cp.gamma[:, None] / torch.clamp_min(total, 1e-9), 1.0), 0.0)
    return torch.maximum(q_out * scale, must_send)


def _shuffle_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe, axis=None):
    I = cp.inst_comp.shape[0]
    I_all = I if axis is None else I * axis.size
    ship = _ship_amounts_compact(cp, q_out, must_send)
    can = (cp.adj_rows > 0.0) & (cp.comp_count > 0.0)[None, :]
    per_target = torch.where(can, ship / torch.clamp_min(cp.comp_count, 1.0)[None, :], 0.0)
    shipped = per_target * cp.comp_count[None, :]
    u_sum = _u_col_sums(U, cp, axis)
    cost = (per_target * u_sum[cp.inst_cont.long()]).sum()
    return CompactDecision(shipped, torch.zeros_like(ship), torch.full_like(
        ship, I_all, dtype=torch.long), per_target, cost)


def _jsq_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe, axis=None):
    I = cp.inst_comp.shape[0]
    C = cp.comp_count.shape[0]
    I_all = I if axis is None else I * axis.size
    cont = cp.inst_cont.long()
    comps = torch.arange(C, device=U.device)
    ship = _ship_amounts_compact(cp, q_out, must_send)
    # winner[c] = argmin q_in over the alive instances of c (ties -> lowest)
    cand = (cp.inst_comp.long()[:, None] == comps[None, :]) & (cp.alive > 0.0)[:, None]
    masked_q = torch.where(cand, q_in[:, None], _INF)
    winner = torch.argmin(masked_q, dim=0)  # (C,)
    if axis is None:
        win_ok = (cp.inst_comp.long()[winner] == comps) & (cp.alive[winner] > 0.0)
        u_win = U[cont[:, None], cont[winner][None, :]]  # (I, C)
    else:
        # fold the per-component winner as the POTUS candidate is folded:
        # global-id lift, pmin on (value, id), an owner pmin for its container
        off = axis.index * I
        w_min, winner = _fold_min_with_payload(masked_q.amin(dim=0), winner + off, I_all, axis)
        win_ok = w_min < _INF  # some alive instance of c exists on some rank
        k_win = _owner_gather(winner, cp.inst_cont, off, I, U.shape[0] - 1, axis)
        u_win = U[cont[:, None], k_win[None, :]]  # (I, C)
    can = (cp.adj_rows > 0.0) & win_ok[None, :]
    shipped = torch.where(can, ship, 0.0)
    j_point = torch.where(can, winner[None, :], I_all)
    cost = (shipped * u_win).sum()
    return CompactDecision(shipped, shipped, j_point, torch.zeros_like(shipped), cost)


_DECIDERS = {"potus": _potus_decide, "shuffle": _shuffle_decide, "jsq": _jsq_decide}


def compact_decide(scheduler: str, cp: CompactProblem, U, q_in, q_out, must_send, V, beta,
                   kernel_safe: bool = False, axis: Axis | None = None) -> CompactDecision:
    """One slot's scheduling decision in compact form; ``scheduler`` must be
    in :data:`COMPACT_SCHEDULERS`.

    With ``axis`` (a mesh axis, ``distributed.context.Axis``) every (I, …)
    argument is this rank's row block of the global problem, ``q_in``
    included: the local column min covers exactly the local instances, so
    nothing is all-gathered. ``j_point`` then holds global instance ids with
    ``I · axis.size`` as "no target", and ``cost`` is this rank's partial
    (``compact_slot_step`` folds it). ``axis`` and ``kernel_safe`` exclude
    each other: the kernel's arithmetic holds no collective (DESIGN.md §13).
    """
    if axis is not None and kernel_safe:
        raise ValueError("compact_decide: axis (sharded) and kernel_safe are mutually "
                         "exclusive: a kernel body holds no collective (DESIGN.md §13)")
    return _DECIDERS[scheduler](cp, U, q_in, q_out, must_send, V, beta, kernel_safe, axis)


# ---------------------------------------------------------------------------
# the full one-dispatch slot step (stages 1-5 of DESIGN.md §8, compact form)
# ---------------------------------------------------------------------------

class StepConsts(NamedTuple):
    """Slot-invariant tensors consumed by :func:`compact_slot_step` and by
    the slot kernel. The first seventeen fields are the reference's; the
    last three are the instance layout only the kernel reads (see
    :func:`kernel_layout`)."""

    U: torch.Tensor  # (K, K)
    mu: torch.Tensor  # (I,) raw capacity units
    inv_service: torch.Tensor  # (I,)
    sel_cmp: torch.Tensor  # (I, S)
    stream_cmp: torch.Tensor  # (I, S)
    valid_cmp: torch.Tensor  # (I, S)
    succ_map: torch.Tensor  # (I, S) int32
    term_f: torch.Tensor  # (I,)
    comp_onehot: torch.Tensor  # (I, C)
    inst_comp: torch.Tensor  # (I,) int32
    inst_cont: torch.Tensor  # (I,) int32
    gamma: torch.Tensor  # (I,)
    comp_count: torch.Tensor  # (C,)
    spout_f: torch.Tensor  # (I,) 1.0 on spout instances
    adj_rows: torch.Tensor  # (I, C)
    V: torch.Tensor  # ()
    beta: torch.Tensor  # ()
    comp_start: torch.Tensor | None = None  # (C+1,) int32 instance range of each component
    cont_rows: torch.Tensor | None = None  # (I,) int32 instances ordered by container
    cont_start: torch.Tensor | None = None  # (K+1,) int32 each container's span of cont_rows


def kernel_layout(inst_comp, inst_cont, n_components: int, n_containers: int):
    """The instance layout the slot kernel's reductions walk, as numpy int32:
    ``comp_start`` (C+1,) — instances of component c are
    ``comp_start[c]:comp_start[c+1]`` (``build_topology`` appends them in
    component order; anything else raises) — and ``cont_rows`` (I,) /
    ``cont_start`` (K+1,), the instances grouped by container in ascending
    order. Fixed groupings give every float sum of the kernel one order."""
    comp = np.asarray(inst_comp, np.int64)
    cont = np.asarray(inst_cont, np.int64)
    if comp.size and (np.any(np.diff(comp) < 0) or comp.min() < 0
                      or comp.max() >= n_components):
        raise ValueError("instances must be grouped by component in ascending order")
    comp_start = np.searchsorted(comp, np.arange(n_components + 1),
                                 side="left").astype(np.int32)
    if cont.size and (cont.min() < 0 or cont.max() >= n_containers):
        raise ValueError(f"container ids must lie in [0, {n_containers})")
    cont_rows = np.argsort(cont, kind="stable").astype(np.int32)
    cont_start = np.searchsorted(cont[cont_rows], np.arange(n_containers + 1),
                                 side="left").astype(np.int32)
    return comp_start, cont_rows, cont_start


def drain_ages(buckets: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """Mass removed from each age bucket when ``amount`` is drained
    oldest-first: a masked prefix-sum water-fill along the last axis. The
    total removed is ``min(amount, buckets.sum(-1))`` and removal is always
    an age prefix."""
    cum = torch.cumsum(buckets, dim=-1)
    return torch.minimum(torch.clamp_min(amount[..., None] - (cum - buckets), 0.0), buckets)


def _to_cmp(c: StepConsts, x: torch.Tensor) -> torch.Tensor:
    """(I, C) -> (I, S)."""
    C = c.adj_rows.shape[1]
    return torch.gather(x, 1, torch.clamp_max(c.succ_map.long(), C - 1)) * c.valid_cmp


def _to_dense(c: StepConsts, x_cmp: torch.Tensor) -> torch.Tensor:
    """(I, S, ...) -> (I, C, ...), contiguous; the C sentinel column is
    dropped. Distinct successors have distinct columns, so no two terms meet
    in a kept one."""
    I, S = x_cmp.shape[:2]
    C = c.adj_rows.shape[1]
    idx = c.succ_map.long().reshape(I, S, *([1] * (x_cmp.dim() - 2))).expand(x_cmp.shape)
    out = torch.zeros((I, C + 1, *x_cmp.shape[2:]), dtype=x_cmp.dtype, device=x_cmp.device)
    return out.scatter_add_(1, idx, x_cmp)[:, :C].contiguous()


def _observe(c: StepConsts, state, act_t, pred_t):
    """Stage 1, the window's pos-0 reconciled with slot ``t``'s actual
    arrivals, and the queue observation of stage 2. Returns ``(q_rem, q_in
    (I,), q_out (I, C), must_send (I, C), recon)``; ``recon`` is the
    reconciliation's ``(r, pred_m, tp, tn)`` (I, S), which the metric streams
    read."""
    q_rem, admit, q_in_tag, q_out_tag = state[:4]
    spout_f = c.spout_f
    pred_m = _to_cmp(c, pred_t) * c.stream_cmp
    act_m = _to_cmp(c, act_t) * c.stream_cmp
    tp = torch.minimum(pred_m, act_m)
    tn = act_m - tp
    r = torch.where(pred_m > 0, q_rem[:, :, 0] / torch.where(pred_m > 0, pred_m, 1.0), 0.0)
    q_rem = torch.cat([(r * tp + tn)[:, :, None], q_rem[:, :, 1:]], dim=-1)
    q_in_arr = q_in_tag.sum(-1)
    q_out_cmp = torch.where(spout_f[:, None] > 0, q_rem.sum(-1), q_out_tag.sum(-1))
    must_send = _to_dense(c, (q_rem[:, :, 0] + admit) * spout_f[:, None])
    return q_rem, q_in_arr, _to_dense(c, q_out_cmp), must_send, (r, pred_m, tp, tn)


def _drain_sources(c: StepConsts, q_rem, admit, q_out_tag, shipped_cmp, age_cap: int):
    """Stage 3's oldest-first drain of every source buffer. The unified
    buffer ``src_ext`` (I, S, Atot+1): bolts ship from their ``q_out``
    buckets; spouts ship the window in ascending lookahead (buckets
    ``age_cap..age_cap+W``), then the admission backlog (a trailing slot,
    re-tagged to age 0 when it lands). Returns the drained queues,
    ``src_ext`` and ``drained``."""
    I, S = admit.shape
    Atot = q_out_tag.shape[-1]
    dt, dev = q_rem.dtype, q_rem.device
    spout_f = c.spout_f
    src_spout = torch.cat([torch.zeros((I, S, age_cap), dtype=dt, device=dev), q_rem,
                           admit[:, :, None]], dim=-1)
    src_bolt = torch.cat([q_out_tag, torch.zeros((I, S, 1), dtype=dt, device=dev)], dim=-1)
    src_ext = torch.where(spout_f[:, None, None] > 0, src_spout, src_bolt)
    drained = drain_ages(src_ext, shipped_cmp)
    q_rem = q_rem - drained[:, :, age_cap:Atot] * spout_f[:, None, None]
    admit = admit - drained[:, :, -1] * spout_f[:, None]
    q_out_tag = q_out_tag - drained[:, :, :Atot] * (1.0 - spout_f)[:, None, None]
    return q_rem, admit, q_out_tag, src_ext, drained


def _serve_and_shift(c: StepConsts, state, land, mu_eff, new_pred, t: int, age_cap: int,
                     axis: Axis | None = None):
    """Stages 4 and 5: last slot's transit lands, bolts serve up to
    ``mu_eff``, terminal completions enter the response accumulators at
    columns ``[t, t + Atot)``, emissions join the output queues, leftover
    actuals join the admission backlog, and windows and age axes shift.
    Under sharding (``axis``) the completed mass folds with a ``psum``, so
    every rank's replicated accumulators see the global completions.
    Returns ``(state, capped_served, term_served)``."""
    q_rem, admit, q_in_tag, q_out_tag, transit, resp_mass, resp_time = state
    Atot = q_in_tag.shape[-1]
    dt, dev = q_rem.dtype, q_rem.device
    spout_f = c.spout_f
    bolt_f = 1.0 - spout_f
    avail = q_in_tag + transit
    served_amt = torch.minimum(avail.sum(-1), mu_eff) * bolt_f
    served_b = drain_ages(avail, served_amt)
    q_in_tag = (avail - served_b) * bolt_f[:, None]
    cmass = c.comp_onehot.T @ (served_b * c.term_f[:, None])  # (C, Atot)
    if axis is not None:
        cmass = psum(cmass, axis)
    resp_per_b = torch.clamp_min(age_cap - torch.arange(Atot, dtype=dt, device=dev), 0.0)
    cols = torch.arange(t, t + Atot, device=dev)
    resp_mass = resp_mass.index_add(1, cols, cmass)
    resp_time = resp_time.index_add(1, cols, cmass * resp_per_b[None, :])
    q_out_tag = q_out_tag + served_b[:, None, :] * c.sel_cmp[:, :, None] * bolt_f[:, None, None]
    admit = admit + q_rem[:, :, 0] * spout_f[:, None]
    q_rem = torch.cat([q_rem[:, :, 1:], (_to_cmp(c, new_pred) * c.stream_cmp)[:, :, None]],
                      dim=-1)

    def shift(x):  # age b+1 -> b; the oldest bucket saturates (A-cap rule)
        head = x[..., 0:1] + x[..., 1:2]
        return torch.cat([head, x[..., 2:], torch.zeros_like(x[..., 0:1])], dim=-1)

    state = (q_rem, admit, shift(q_in_tag), shift(q_out_tag), shift(land), resp_mass, resp_time)
    return state, cmass[:, 0].sum(), cmass.sum()


def _check_columns(t: int, Atot: int, resp_mass) -> int:
    t = int(t)
    if t < 0 or t + Atot > resp_mass.shape[-1]:
        raise ValueError(f"accumulator columns [{t}, {t + Atot}) outside "
                         f"[0, {resp_mass.shape[-1]})")
    return t


def slot_streams(c: StepConsts, metrics_spec, backlog, q_in_arr, recon, admit, land,
                 capped_served, term_served, axis: Axis | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """The §14 metric streams of one cohort slot (DESIGN.md §14), shared by
    the compact step and the dense route's step, as the reference computes
    them: ``landed`` is this slot's landing (I,) before the age shift, the
    price ``V * u_mean[container] + q_in``, ``held`` the admission backlog
    carried after stage 5 (``admit``), ``dropped`` the mispredicted mass the
    reconciliation ``recon = (r, pred_m, tp, tn)`` retired. Under sharding
    (``axis``) the (I,) vectors are all-gathered and the sums psum'd (tag
    ``"obs"``), so every rank emits the same global rows."""
    r, pred_m, tp, tn = recon
    fp = pred_m - tp
    landed = land.sum(-1)
    vecs = (q_in_arr, c.V * c.U.mean(dim=0)[c.inst_cont.long()] + q_in_arr, landed)
    comp_backlog = q_in_arr @ c.comp_onehot
    sums = torch.stack([admit.sum(), (r * fp).sum(), tp.sum(), fp.sum(), tn.sum()])
    if axis is not None:  # one all-gather and one psum, each of the quantities stacked
        vecs = all_gather(torch.stack(vecs, dim=1), axis, tag="obs").unbind(1)
        folded = psum(torch.cat([comp_backlog, sums]), axis, tag="obs")
        comp_backlog, sums = folded[:-5], folded[-5:]
    q_in_g, price_g, landed_g = vecs
    held, dropped, tp_s, fp_s, tn_s = sums.unbind()
    ctx = {
        "h": backlog, "q_in": q_in_g, "price": price_g,
        "landed": landed_g, "transit_total": landed_g.sum(),
        "comp_backlog": comp_backlog, "held": held, "dropped": dropped,
        "tp": tp_s, "fp": fp_s, "tn": tn_s,
        "capped": capped_served, "served": term_served,
    }
    return compute_scan_streams(scan_stream_names(metrics_spec), ctx)


def compact_slot_step(c: StepConsts, state, xs, *, scheduler: str, age_cap: int,
                      kernel_safe: bool = False, metrics_spec=None, axis: Axis | None = None):
    """One slot of the cohort dynamics (stages 1-5 of DESIGN.md §8) with the
    compact one-dispatch decision — no (I, I) tensor anywhere.

    ``state`` is ``(q_rem, admit, q_in, q_out, transit, resp_mass,
    resp_time)`` and ``xs`` is ``(act_t, pred_t, new_pred, t)`` with ``t``
    the chunk-local slot, a Python int: the response accumulators take
    columns ``[t, t + Atot)``. ``xs`` may carry a fifth element, one slot of
    a disruption trace ``(mu_row, gamma_row, alive_row)`` (DESIGN.md §9):
    the caps fold then happens here in compact form — alive counts per
    component, the effective gamma, no mandatory dispatch from dead rows —
    as ``potus.apply_caps`` does on the dense problem. Returns ``(state,
    (backlog, cost, capped_served, term_served))``, followed by one row per
    selected stream of ``metrics_spec`` (a ``MetricsSpec``; DESIGN.md §14).

    With ``axis`` (a mesh axis, DESIGN.md §13) every (I, …) tensor of ``c``,
    ``state`` and ``xs`` — the disruption rows included — is this rank's row
    block; ``c.U``, ``c.comp_count`` and the response accumulators are whole
    on every rank. Per slot the ranks exchange the decision folds of
    :func:`compact_decide`, the (C,) alive counts under events, the
    (I_all, Atot) landing ``psum`` (the physical tuple transfer), the (C,
    Atot) even-spread and served-mass psums and the two scalar metrics
    (``core.sharded.cohort_slot_payload_floats``); nothing (I, I)-shaped.
    """
    act_t, pred_t, new_pred, t, *ev = xs
    q_rem, admit, q_in_tag, q_out_tag = state[:4]
    I = q_rem.shape[0]
    C = c.adj_rows.shape[1]
    Atot = q_in_tag.shape[-1]
    t = _check_columns(t, Atot, state[5])
    dt, dev = q_rem.dtype, q_rem.device
    comp = c.inst_comp.long()

    # -- 1. reconcile window pos-0 with actual arrivals, 2. observe, schedule --
    q_rem, q_in_arr, q_out_arr, must_send, recon = _observe(c, state, act_t, pred_t)
    if ev:
        mu_row, gamma_row, alive_row = ev[0]
        mu_eff = mu_row * c.inv_service
        if kernel_safe:
            comp_count = (alive_row[None, :] @ c.comp_onehot)[0]
        else:
            comp_count = torch.zeros((C,), dtype=dt, device=dev).index_add_(0, comp, alive_row)
        if axis is not None:
            comp_count = psum(comp_count, axis)
        cp = CompactProblem(c.inst_comp, c.inst_cont, gamma_row, comp_count, c.adj_rows,
                            alive_row)
        must_send = must_send * alive_row[:, None]
    else:
        mu_eff = c.mu * c.inv_service
        cp = CompactProblem(c.inst_comp, c.inst_cont, c.gamma, c.comp_count, c.adj_rows,
                            torch.ones((I,), dtype=dt, device=dev))
    dec = compact_decide(scheduler, cp, c.U, q_in_arr, q_out_arr, must_send, c.V, c.beta,
                         kernel_safe, axis)
    backlog = q_in_arr.sum() + c.beta * q_out_arr.sum()
    cost = dec.cost
    if axis is not None:  # the two slot scalars in one psum
        backlog, cost = psum(torch.stack([backlog, cost]), axis).unbind()

    # -- 3. drain sources oldest-first, split over targets -------------------
    q_rem, admit, q_out_tag, _, drained = _drain_sources(
        c, q_rem, admit, q_out_tag, _to_cmp(c, dec.shipped), age_cap)
    # landing: the admission slot re-tags to age 0 (bucket age_cap) on landing
    d_land = torch.cat([
        drained[:, :, :age_cap],
        drained[:, :, age_cap:age_cap + 1] + drained[:, :, -1:],
        drained[:, :, age_cap + 1:Atot]], dim=-1)  # (I, S, Atot)
    d_dense = _to_dense(c, d_land)  # (I, C, Atot)
    sh_safe = torch.where(dec.shipped > 0, dec.shipped, 1.0)
    live = dec.shipped > _EPS
    w_pt = torch.where(live, dec.point / sh_safe, 0.0)
    w_ev = torch.where(live, dec.even_per / sh_safe, 0.0)
    # point landing: only the (source, component) pairs that aim mass at an
    # instance take part (the others add +0, and on CUDA would all queue on
    # the sentinel row of the sort-based accumulation). Under sharding the
    # targets are global ids: the local sources' mass lands in the global
    # buffer, which folds with one psum (the tuple transfer); each rank keeps
    # its own row block
    I_all = I if axis is None else I * axis.size
    aimed = torch.nonzero((w_pt > 0).reshape(I * C))[:, 0]
    wd = (w_pt[:, :, None] * d_dense).reshape(I * C, Atot)[aimed]
    land = _rows_add(torch.zeros((I_all + 1, Atot), dtype=dt, device=dev),
                     dec.j_point.reshape(I * C)[aimed], wd)[:I_all]
    # even spread: per-component sum, then broadcast to alive instances
    ev_cb = torch.einsum("ic,icb->cb", w_ev, d_dense)  # (C, Atot)
    if axis is not None:  # the landing and the even spread in one psum
        folded = psum(torch.cat([land, ev_cb]), axis)
        land, ev_cb = folded[axis.index * I:(axis.index + 1) * I], folded[I_all:]
    land = land + cp.alive[:, None] * ev_cb[comp]

    # -- 4. serve, 5. admit and shift ------------------------------------------
    state, capped_served, term_served = _serve_and_shift(
        c, (q_rem, admit, q_in_tag, q_out_tag, *state[4:]), land, mu_eff, new_pred, t, age_cap,
        axis)
    out = (backlog, cost, capped_served, term_served)
    if metrics_spec is not None:
        out = out + slot_streams(c, metrics_spec, backlog, q_in_arr, recon, state[1], land,
                                 capped_served, term_served, axis)
    return state, out
