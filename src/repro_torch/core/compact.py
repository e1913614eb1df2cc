"""One-dispatch slot math for the fused cohort engine, in PyTorch
(DESIGN.md §12).

The port's counterpart of ``repro.core.compact`` with ``axis=None`` and no
metric streams. Each scheduler's per-slot decision is kept in the
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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .potus import _fill_components

__all__ = [
    "COMPACT_SCHEDULERS", "CompactProblem", "CompactDecision", "StepConsts",
    "compact_decide", "compact_slot_step", "drain_ages", "kernel_layout",
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


def _u_col_sums(U: torch.Tensor, cp: CompactProblem) -> torch.Tensor:
    """(K, C) per-component sums of alive columns of ``U[:, k_j]``."""
    C = cp.comp_count.shape[0]
    u_cols = U[:, cp.inst_cont.long()] * cp.alive[None, :]  # (K, I)
    out = torch.zeros((U.shape[0], C), dtype=U.dtype, device=U.device)
    return out.index_add_(1, cp.inst_comp.long(), u_cols)


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


def _potus_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe):
    I = cp.inst_comp.shape[0]
    C = cp.comp_count.shape[0]
    cont = cp.inst_cont.long()
    edge = cp.adj_rows > 0.0
    big = torch.full((), _BIG, dtype=U.dtype, device=U.device)
    # shared per-(container, component) cheapest candidate: O(K·I), no (I, I)
    t1 = torch.where((cp.alive > 0.0)[None, :], V * U[:, cont] + q_in[None, :], big)
    M, J = _colmin_per_comp(t1, cp.inst_comp, C, kernel_safe)
    m_raw = M[cont] - beta * q_out  # row-constant shift
    cand = edge & (m_raw < 0.0)
    m = torch.where(cand, m_raw, _INF)
    j_c = torch.where(edge, J[cont], I)
    budget = torch.where(cand, torch.clamp_min(q_out, 0.0), 0.0)
    fill_rows = _fill_rows_rank if kernel_safe else _fill_rows_sort
    fill = fill_rows(m, j_c, budget, cp.gamma)
    # mandatory dispatch (eq. 4): even split over the alive instances
    can_even = edge & (cp.comp_count > 0.0)[None, :]
    shortfall = torch.where(can_even, torch.clamp_min(must_send - fill, 0.0), 0.0)
    even_per = shortfall / torch.clamp_min(cp.comp_count, 1.0)[None, :]
    u_sum = _u_col_sums(U, cp)  # (K, C)
    u_point = U[cont[:, None], cont[torch.clamp_max(j_c, I - 1)]]  # fill is 0 where j_c == I
    cost = (fill * u_point).sum() + (even_per * u_sum[cont]).sum()
    return CompactDecision(fill + shortfall, fill, j_c, even_per, cost)


def _ship_amounts_compact(cp, q_out, must_send):
    """Gamma-throttled proportional shipment (``baselines._ship_amounts``)."""
    total = q_out.sum(dim=1, keepdim=True)
    scale = torch.where(
        total > 0, torch.clamp_max(cp.gamma[:, None] / torch.clamp_min(total, 1e-9), 1.0), 0.0)
    return torch.maximum(q_out * scale, must_send)


def _shuffle_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe):
    I = cp.inst_comp.shape[0]
    ship = _ship_amounts_compact(cp, q_out, must_send)
    can = (cp.adj_rows > 0.0) & (cp.comp_count > 0.0)[None, :]
    per_target = torch.where(can, ship / torch.clamp_min(cp.comp_count, 1.0)[None, :], 0.0)
    shipped = per_target * cp.comp_count[None, :]
    u_sum = _u_col_sums(U, cp)
    cost = (per_target * u_sum[cp.inst_cont.long()]).sum()
    return CompactDecision(shipped, torch.zeros_like(ship), torch.full_like(
        ship, I, dtype=torch.long), per_target, cost)


def _jsq_decide(cp, U, q_in, q_out, must_send, V, beta, kernel_safe):
    I = cp.inst_comp.shape[0]
    C = cp.comp_count.shape[0]
    cont = cp.inst_cont.long()
    comps = torch.arange(C, device=U.device)
    ship = _ship_amounts_compact(cp, q_out, must_send)
    # winner[c] = argmin q_in over the alive instances of c (ties -> lowest)
    cand = (cp.inst_comp.long()[:, None] == comps[None, :]) & (cp.alive > 0.0)[:, None]
    winner = torch.argmin(torch.where(cand, q_in[:, None], _INF), dim=0)  # (C,)
    win_ok = (cp.inst_comp.long()[winner] == comps) & (cp.alive[winner] > 0.0)
    u_win = U[cont[:, None], cont[winner][None, :]]  # (I, C)
    can = (cp.adj_rows > 0.0) & win_ok[None, :]
    shipped = torch.where(can, ship, 0.0)
    j_point = torch.where(can, winner[None, :], I)
    cost = (shipped * u_win).sum()
    return CompactDecision(shipped, shipped, j_point, torch.zeros_like(shipped), cost)


_DECIDERS = {"potus": _potus_decide, "shuffle": _shuffle_decide, "jsq": _jsq_decide}


def compact_decide(scheduler: str, cp: CompactProblem, U, q_in, q_out, must_send, V, beta,
                   kernel_safe: bool = False) -> CompactDecision:
    """One slot's scheduling decision in compact form; ``scheduler`` must be
    in :data:`COMPACT_SCHEDULERS`."""
    return _DECIDERS[scheduler](cp, U, q_in, q_out, must_send, V, beta, kernel_safe)


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


def compact_slot_step(c: StepConsts, state, xs, *, scheduler: str, age_cap: int,
                      kernel_safe: bool = False):
    """One slot of the cohort dynamics (stages 1-5 of DESIGN.md §8) with the
    compact one-dispatch decision — no (I, I) tensor anywhere.

    ``state`` is ``(q_rem, admit, q_in, q_out, transit, resp_mass,
    resp_time)`` and ``xs`` is ``(act_t, pred_t, new_pred, t)`` with ``t``
    the chunk-local slot, a Python int: the response accumulators take
    columns ``[t, t + Atot)``. Returns ``(state, (backlog, cost,
    capped_served, term_served))``. Disruption rows are not ported yet.
    """
    act_t, pred_t, new_pred, t = xs
    q_rem, admit, q_in_tag, q_out_tag, transit, resp_mass, resp_time = state
    I, S, W1 = q_rem.shape
    C = c.adj_rows.shape[1]
    Atot = q_in_tag.shape[-1]
    t = int(t)
    if t < 0 or t + Atot > resp_mass.shape[-1]:
        raise ValueError(f"accumulator columns [{t}, {t + Atot}) outside "
                         f"[0, {resp_mass.shape[-1]})")
    spout_f = c.spout_f
    bolt_f = 1.0 - spout_f
    dt, dev = q_rem.dtype, q_rem.device
    succ = c.succ_map.long()
    comp = c.inst_comp.long()

    def to_cmp(x):  # (I, C) -> (I, S)
        return torch.gather(x, 1, torch.clamp_max(succ, C - 1)) * c.valid_cmp

    def to_dense(x_cmp):  # (I, S) -> (I, C); the C sentinel column is dropped
        return torch.zeros((I, C + 1), dtype=dt, device=dev).scatter_add_(1, succ, x_cmp)[:, :C]

    # -- 1. reconcile window pos-0 with actual arrivals of slot t ------------
    pred_m = to_cmp(pred_t) * c.stream_cmp
    act_m = to_cmp(act_t) * c.stream_cmp
    tp = torch.minimum(pred_m, act_m)
    tn = act_m - tp
    r = torch.where(pred_m > 0, q_rem[:, :, 0] / torch.where(pred_m > 0, pred_m, 1.0), 0.0)
    q_rem = torch.cat([(r * tp + tn)[:, :, None], q_rem[:, :, 1:]], dim=-1)

    # -- 2. observe queue state, schedule (compact decision) -----------------
    q_in_arr = q_in_tag.sum(-1)
    q_out_cmp = torch.where(spout_f[:, None] > 0, q_rem.sum(-1), q_out_tag.sum(-1))
    q_out_arr = to_dense(q_out_cmp)
    must_send = to_dense((q_rem[:, :, 0] + admit) * spout_f[:, None])
    mu_eff = c.mu * c.inv_service
    cp = CompactProblem(c.inst_comp, c.inst_cont, c.gamma, c.comp_count, c.adj_rows,
                        torch.ones((I,), dtype=dt, device=dev))
    dec = compact_decide(scheduler, cp, c.U, q_in_arr, q_out_arr, must_send, c.V, c.beta,
                         kernel_safe)
    backlog = q_in_arr.sum() + c.beta * q_out_arr.sum()

    # -- 3. drain sources oldest-first, split over targets -------------------
    shipped_cmp = to_cmp(dec.shipped)
    src_spout = torch.cat([torch.zeros((I, S, age_cap), dtype=dt, device=dev), q_rem,
                           admit[:, :, None]], dim=-1)
    src_bolt = torch.cat([q_out_tag, torch.zeros((I, S, 1), dtype=dt, device=dev)], dim=-1)
    src_ext = torch.where(spout_f[:, None, None] > 0, src_spout, src_bolt)  # (I, S, Atot+1)
    drained = drain_ages(src_ext, shipped_cmp)
    q_rem = q_rem - drained[:, :, age_cap:Atot] * spout_f[:, None, None]
    admit = admit - drained[:, :, -1] * spout_f[:, None]
    q_out_tag = q_out_tag - drained[:, :, :Atot] * bolt_f[:, None, None]

    # landing: the admission slot re-tags to age 0 (bucket age_cap) on landing
    d_land = torch.cat([
        drained[:, :, :age_cap],
        drained[:, :, age_cap:age_cap + 1] + drained[:, :, -1:],
        drained[:, :, age_cap + 1:Atot]], dim=-1)  # (I, S, Atot)
    d_dense = torch.zeros((I, C + 1, Atot), dtype=dt, device=dev).scatter_add_(
        1, succ[:, :, None].expand(I, S, Atot), d_land)[:, :C]  # (I, C, Atot)
    sh_safe = torch.where(dec.shipped > 0, dec.shipped, 1.0)
    live = dec.shipped > _EPS
    w_pt = torch.where(live, dec.point / sh_safe, 0.0)
    w_ev = torch.where(live, dec.even_per / sh_safe, 0.0)
    wd = (w_pt[:, :, None] * d_dense).reshape(I * C, Atot)
    land = torch.zeros((I + 1, Atot), dtype=dt, device=dev).index_add_(
        0, dec.j_point.reshape(I * C), wd)[:I]
    # even spread: per-component sum, then broadcast to alive instances
    ev_cb = torch.einsum("ic,icb->cb", w_ev, d_dense)  # (C, Atot)
    land = land + cp.alive[:, None] * ev_cb[comp]

    # -- 4. land last slot's transit, serve bolts ----------------------------
    avail = q_in_tag + transit
    served_amt = torch.minimum(avail.sum(-1), mu_eff) * bolt_f
    served_b = drain_ages(avail, served_amt)
    q_in_tag = (avail - served_b) * bolt_f[:, None]
    cmass = torch.zeros((C, Atot), dtype=dt, device=dev).index_add_(
        0, comp, served_b * c.term_f[:, None])  # (C, Atot)
    resp_per_b = torch.clamp_min(age_cap - torch.arange(Atot, dtype=dt, device=dev), 0.0)
    cols = torch.arange(t, t + Atot, device=dev)
    resp_mass = resp_mass.index_add(1, cols, cmass)
    resp_time = resp_time.index_add(1, cols, cmass * resp_per_b[None, :])
    capped_served = cmass[:, 0].sum()
    term_served = cmass.sum()
    q_out_tag = q_out_tag + served_b[:, None, :] * c.sel_cmp[:, :, None] * bolt_f[:, None, None]

    # -- 5. admit leftover actuals, shift windows and age axes ---------------
    admit = admit + q_rem[:, :, 0] * spout_f[:, None]
    q_rem = torch.cat([q_rem[:, :, 1:], (to_cmp(new_pred) * c.stream_cmp)[:, :, None]], dim=-1)

    def shift(x):  # age b+1 -> b; the oldest bucket saturates (A-cap rule)
        head = x[..., 0:1] + x[..., 1:2]
        return torch.cat([head, x[..., 2:], torch.zeros_like(x[..., 0:1])], dim=-1)

    state = (q_rem, admit, shift(q_in_tag), shift(q_out_tag), shift(land), resp_mass, resp_time)
    return state, (backlog, dec.cost, capped_served, term_served)
