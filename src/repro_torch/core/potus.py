"""POTUS — Predictive Online Tuple Scheduling (paper Algorithm 1) in PyTorch.

The port's counterpart of ``repro.core.potus``. Per slot, each instance
``i`` ships tuples to successor instances ``i'`` in ascending order of the
price (eq. 16)

    l[i,i'](t) = V * U[k(i), k(i')] + Q_in[i'](t) - beta * Q_out[i, c(i')](t)

over the candidates with ``l < 0``, each shipment bounded by the remaining
transmission budget ``gamma_i`` and the output-queue budget of the target
component; actual same-slot arrivals at spouts are always dispatched (eq. 4),
evenly across the successor component's instances where the greedy shipped
too little.

Two interchangeable greedies (DESIGN.md §7), batched over all rows:

* ``method="sort"`` (default) — the water-fill: one cheapest candidate per
  successor component, sorted by ``(price, index)``, ``gamma_i`` filled
  against the prefix sums of the component budgets;
* ``method="loop"`` — the reference loop of ``max_succ`` argmin picks, ties
  to the lowest index.

Routing: the device of the tensors decides, as in ``kernels.ops``. On CUDA,
``method="sort"`` runs the hand-written fused schedule kernel
(``kernels/csrc/potus_schedule.cu``) and then the plain mandatory dispatch,
and ``method="loop"`` takes its prices from the price kernel
(``kernels/csrc/potus_price.cu``). CPU tensors take the plain versions.

Disruption traces (``core.events``, DESIGN.md §9) enter through ``caps``, a
:class:`SlotCaps`; :func:`apply_caps` folds it into the problem so every
route prices disruptions out with no special case. With an identity trace
the fold is numerically a no-op.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import resolve_device
from .network import NetworkCosts
from .topology import Topology

__all__ = ["SchedProblem", "SlotCaps", "caps_for_slot", "apply_caps", "hold_mask_for",
           "make_problem", "potus_prices", "potus_schedule", "_fill_components"]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SchedProblem:
    """Static description of the scheduling problem, tensors on one device."""

    edge_mask: torch.Tensor  # (I, I) bool — comp(i) -> comp(i') is a DAG edge
    inst_comp: torch.Tensor  # (I,) int32
    inst_container: torch.Tensor  # (I,) int32
    gamma: torch.Tensor  # (I,) f32
    comp_count: torch.Tensor  # (C,) f32 — parallelism per component
    is_spout: torch.Tensor  # (I,) bool
    max_succ: int
    n_components: int


@dataclasses.dataclass(frozen=True)
class SlotCaps:
    """One slot of a disruption trace (DESIGN.md §9): ``alive`` (I,) is the
    global 0/1 liveness of the decision columns; ``row_alive``, ``mu`` and
    ``gamma`` are shaped like the decision rows (the same I rows here) and
    carry the effective capacities, already zero where dead."""

    alive: torch.Tensor
    row_alive: torch.Tensor
    mu: torch.Tensor
    gamma: torch.Tensor


def caps_for_slot(mu_row: torch.Tensor, gamma_row: torch.Tensor,
                  alive_row: torch.Tensor) -> SlotCaps:
    """Dense-path caps: rows and columns are the same I instances."""
    return SlotCaps(alive=alive_row, row_alive=alive_row, mu=mu_row, gamma=gamma_row)


def _alive_per_comp(prob: SchedProblem, alive: torch.Tensor) -> torch.Tensor:
    """(C,) alive instances per component. The summands are 0/1, so the sum is
    exact in any order (atomics on CUDA included)."""
    return torch.zeros_like(prob.comp_count).index_add_(0, prob.inst_comp.long(), alive)


def apply_caps(prob: SchedProblem, must_send: torch.Tensor, caps: SlotCaps | None):
    """Fold a disruption slot into the problem (DESIGN.md §9): dead targets
    leave ``edge_mask``, dead sources get ``gamma = 0`` and no mandatory
    dispatch (the engines hold those arrivals), and ``comp_count`` becomes
    the alive count, so the even split lands on live instances only."""
    if caps is None:
        return prob, must_send
    prob = dataclasses.replace(
        prob,
        edge_mask=prob.edge_mask & (caps.alive > 0.0)[None, :],
        gamma=caps.gamma,
        comp_count=_alive_per_comp(prob, caps.alive),
    )
    return prob, must_send * caps.row_alive[:, None]


def hold_mask_for(prob: SchedProblem, caps: SlotCaps) -> torch.Tensor:
    """(R, C) — 1 on streams whose mandatory arrivals cannot ship this slot
    (dead source row, or successor component with no alive instance)."""
    dead_comp = (_alive_per_comp(prob, caps.alive) <= 0.0).to(caps.alive.dtype)
    return torch.clamp((1.0 - caps.row_alive)[:, None] + dead_comp[None, :], 0.0, 1.0)


def make_problem(topo: Topology, net: NetworkCosts, inst_container: np.ndarray,
                 device="cuda") -> SchedProblem:
    """The problem on ``device`` (the card unless the caller asks for the CPU;
    raises if CUDA is asked for and absent). The (I, I) ``edge_mask`` is
    gathered there from the (C, C) adjacency (``topo.edge_mask_instances()``
    on the device), so the largest tensor is never built on the host or
    copied."""
    device = resolve_device(device)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    comp = dev(topo.inst_comp, torch.int64)
    return SchedProblem(
        edge_mask=dev(topo.adj, torch.bool)[comp[:, None], comp[None, :]],
        inst_comp=dev(topo.inst_comp, torch.int32),
        inst_container=dev(inst_container, torch.int32),
        gamma=dev(topo.inst_gamma, torch.float32),
        comp_count=dev(topo.comp_parallelism, torch.float32),
        is_spout=dev(topo.comp_is_spout[topo.inst_comp], torch.bool),
        max_succ=int(topo.max_out_instances()),
        n_components=int(topo.n_components),
    )


def _price_rows(u_pair, q_in_cols, q_out_rows, inst_comp_cols, edge_mask_rows, V, beta):
    """Price block ``l`` (eq. 16) for a block of source rows; +inf off-edge.
    The operation order, ``(V*u + q_in) - beta*q_out``, is the one the price
    and schedule kernels repeat, so that they agree bitwise."""
    l = V * u_pair + q_in_cols[None, :] - beta * q_out_rows[:, inst_comp_cols.long()]
    return torch.where(edge_mask_rows, l, _INF)


def _u_pair(U: torch.Tensor, inst_container: torch.Tensor) -> torch.Tensor:
    """(I, I) = U[k(i), k(j)]."""
    kc = inst_container.long()
    return U[kc[:, None], kc[None, :]]


def potus_prices(prob: SchedProblem, U, q_in, q_out, V, beta) -> torch.Tensor:
    """(I, I) price matrix ``l`` (eq. 16); +inf on non-edges. The price
    kernel on CUDA tensors, its plain version on CPU tensors."""
    from ..kernels import ops

    return ops.potus_price(U, q_in, q_out, prob.inst_container, prob.inst_comp,
                           prob.edge_mask, V, beta)


def _greedy_rows(l: torch.Tensor, q_out: torch.Tensor, gamma: torch.Tensor,
                 inst_comp: torch.Tensor, max_succ: int):
    """Algorithm 1 lines 9-14 for every row at once (the reference loop
    path): ``max_succ`` argmin picks per row, ties to the lowest index
    (``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does)."""
    R, I = l.shape
    comp = inst_comp.long()
    x = torch.zeros_like(l)
    budget = q_out.clone()
    used = torch.zeros_like(gamma)
    active = torch.ones((R, I), dtype=torch.bool, device=l.device)
    cand0 = (l < 0.0) & torch.isfinite(l)
    for _ in range(max_succ):
        l_eff = torch.where(active & cand0, l, _INF)
        j = torch.argmin(l_eff, dim=1, keepdim=True)  # (R, 1)
        feasible = torch.gather(l_eff, 1, j) < _INF
        cj = comp[j]
        room = torch.minimum(gamma[:, None] - used[:, None], torch.gather(budget, 1, cj))
        alloc = torch.where(feasible, torch.clamp_min(room, 0.0), 0.0)
        # one index per row: the scatters never collide, so they are exact
        x.scatter_add_(1, j, alloc)
        budget.scatter_add_(1, cj, -alloc)
        used = used + alloc[:, 0]
        active.scatter_(1, j, False)
    return x, budget, used


def _fill_components(m: torch.Tensor, j_c: torch.Tensor, budget: torch.Tensor,
                     gamma: torch.Tensor):
    """Water-fill ``gamma`` against per-component budgets in ascending
    ``(price, index)`` order, over the last axis (leading axes are rows).

    ``m`` (..., C) is the cheapest candidate price per component (+inf =
    none), ``j_c`` that candidate's instance index (I = none), ``budget``
    the per-component ``q_out`` budget (0 where no candidate) and ``gamma``
    (...,) the row's budget. Returns ``(fill_sorted, j_sorted, perm)``;
    ``perm`` maps sorted positions back to component slots. The sort is
    lexicographic on ``(m, j_c)`` — two stable sorts, minor key first — so
    ties go to the lowest index as ``argmin`` does.
    """
    by_j = torch.sort(j_c, dim=-1, stable=True).indices
    by_m = torch.sort(torch.gather(m, -1, by_j), dim=-1, stable=True).indices
    perm = torch.gather(by_j, -1, by_m)
    j_sorted = torch.gather(j_c, -1, perm)
    b_sorted = torch.gather(budget, -1, perm)
    prefix = torch.cumsum(b_sorted, dim=-1)
    before = torch.cat([torch.zeros_like(prefix[..., :1]), prefix[..., :-1]], dim=-1)
    g = gamma.unsqueeze(-1)
    fill = torch.minimum(prefix, g) - torch.minimum(before, g)
    return fill, j_sorted, perm


def _waterfill_rows(l: torch.Tensor, q_out: torch.Tensor, gamma: torch.Tensor,
                    inst_comp: torch.Tensor, n_components: int) -> torch.Tensor:
    """Sort-based water-fill for every row (DESIGN.md §7): the same
    allocation as :func:`_greedy_rows` without the argmin loop. Only the
    cheapest candidate of each component can receive tuples, so each row
    collapses to one (price, target, budget) entry per component."""
    R, I = l.shape
    C = n_components
    comp = inst_comp.long()[None, :].expand(R, I)
    key = torch.where(l < 0.0, l, _INF)  # finite negatives; non-edges are +inf
    m = torch.full((R, C), _INF, dtype=l.dtype, device=l.device)
    m = m.scatter_reduce(1, comp, key, "amin")
    # cheapest candidate per component, ties to the lowest instance index
    cols = torch.arange(I, dtype=torch.int64, device=l.device)
    idx = torch.where(key == torch.gather(m, 1, comp), cols, I)
    j_c = torch.full((R, C), I, dtype=torch.int64, device=l.device)
    j_c = j_c.scatter_reduce(1, comp, idx, "amin")
    budget = torch.where(m < 0.0, torch.clamp_min(q_out, 0.0), 0.0)
    fill, j_sorted, _ = _fill_components(m, j_c, budget, gamma)
    # distinct components have distinct columns, and column I (none) is dropped
    x = torch.zeros((R, I + 1), dtype=l.dtype, device=l.device)
    return x.scatter_add_(1, j_sorted, fill)[:, :I]


def _allocate_rows(l, q_out, gamma, inst_comp, n_components: int, max_succ: int,
                   method: str) -> torch.Tensor:
    """Greedy allocation for a block of rows."""
    if method == "sort":
        return _waterfill_rows(l, q_out, gamma, inst_comp, n_components)
    if method == "loop":
        return _greedy_rows(l, q_out, gamma, inst_comp, max_succ)[0]
    raise ValueError(f"unknown method {method!r} (expected 'sort' or 'loop')")


def _mandatory_dispatch(x, must_send, edge_mask, inst_comp, comp_count,
                        n_components: int) -> torch.Tensor:
    """Mandatory dispatch of actual arrivals (eq. 4, Alg. 1 line 5-6): any
    shortfall against the greedy shipment is split evenly across the
    successor component's instances.

    ``x @ comp_onehot`` is a plain large product outside any kernel, as in
    the reference; it must run in full f32 (no TF32). It is not an
    ``index_add_``, which sums with atomics on CUDA, in an order that
    changes from run to run.
    """
    comp = inst_comp.long()
    comp_onehot = torch.nn.functional.one_hot(comp, n_components).to(x.dtype)  # (I, C)
    shipped = x @ comp_onehot  # (R, C)
    shortfall = torch.clamp_min(must_send - shipped, 0.0)
    extra = torch.where(edge_mask, shortfall[:, comp] / comp_count[comp][None, :], 0.0)
    return x + extra


def potus_schedule(prob: SchedProblem, U, q_in, q_out, must_send, V, beta,
                   method: str = "sort", caps: SlotCaps | None = None) -> torch.Tensor:
    """One slot of Algorithm 1 for every instance. Returns X (I, I).

    ``method="sort"`` is the water-fill, ``"loop"`` the reference argmin
    loop; ``caps`` applies one slot of a disruption trace (DESIGN.md §9).
    CUDA tensors run the fused schedule kernel (sort) or the price kernel
    (loop), CPU tensors their plain versions.
    """
    from ..kernels import ops

    return _schedule_with(ops, prob, U, q_in, q_out, must_send, V, beta, method, caps)


def _schedule_with(ops, prob: SchedProblem, U, q_in, q_out, must_send, V, beta,
                   method: str = "sort", caps: SlotCaps | None = None) -> torch.Tensor:
    """:func:`potus_schedule` through the kernel route ``ops``
    (``kernels.ops``, or ``kernels.ops.plain`` to compare routes on the card)."""
    prob, must_send = apply_caps(prob, must_send, caps)
    if method == "sort":
        x = ops.potus_schedule_alloc(U, q_in, q_out, prob.inst_container, prob.inst_comp,
                                     prob.edge_mask, prob.gamma, V, beta)
    else:
        l = ops.potus_price(U, q_in, q_out, prob.inst_container, prob.inst_comp,
                            prob.edge_mask, V, beta)
        x = _allocate_rows(l, q_out, prob.gamma, prob.inst_comp, prob.n_components,
                           prob.max_succ, method)
    return _mandatory_dispatch(x, must_send, prob.edge_mask, prob.inst_comp,
                               prob.comp_count, prob.n_components)
