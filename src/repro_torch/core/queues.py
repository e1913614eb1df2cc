"""Queueing model and per-slot dynamics (paper §3.4, eqs. (2)-(10)) in PyTorch.

The port's counterpart of ``repro.core.queues``. Fluid (float) tuple counts.
Per-slot order of events (paper Fig. 3):

1. observe Q(t), U(t); make decision X(t);
2. spouts drain their output windows ``Q_rem`` in ascending lookahead order
   (actual tuples first, then predicted; eq. (4) guarantees the w=0 slice is
   fully dispatched), and the window shifts (eqs. (5)-(7));
3. tuples shipped at t-1 land in bolt input queues, bolts serve up to ``mu``
   (eq. (8)) and emit ``nu = served * selectivity`` into their output queues
   (eq. (9)).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .potus import SchedProblem
from .topology import Topology

__all__ = ["SimState", "init_state", "init_state_batch", "effective_qout", "slot_update",
           "slot_update_rows"]


@dataclasses.dataclass
class SimState:
    q_in: torch.Tensor  # (I,)
    q_rem: torch.Tensor  # (I, C, W+1) — spouts only, zeros for bolts
    q_out_bolt: torch.Tensor  # (I, C) — bolts only
    transit: torch.Tensor  # (I,) — tuples landing in q_in next slot (X(t-1))


def init_state(topo: Topology, window: int, arrivals_prefix: np.ndarray,
               device="cuda") -> SimState:
    """``arrivals_prefix``: (window+1, I, C) — λ(0..W) pre-loaded into Q_rem.
    On ``device``: the card unless the caller asks for the CPU (raises if
    CUDA is asked for and absent)."""
    I, C = topo.n_instances, topo.n_components
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    q_rem = torch.as_tensor(np.ascontiguousarray(np.moveaxis(arrivals_prefix, 0, -1)), **f32)
    is_spout = torch.as_tensor(topo.comp_is_spout[topo.inst_comp], **f32)
    return SimState(
        q_in=torch.zeros((I,), **f32),
        q_rem=q_rem * is_spout[:, None, None],
        q_out_bolt=torch.zeros((I, C), **f32),
        transit=torch.zeros((I,), **f32),
    )


def init_state_batch(topo: Topology, window: int, arrivals_prefixes: np.ndarray,
                     device="cuda") -> SimState:
    """Stacked initial states for a scenario sweep: ``arrivals_prefixes``
    (N, window+1, I, C), one λ(0..W) prefix per scenario. Returns a
    :class:`SimState` whose tensors carry a leading scenario axis N, on
    ``device`` (the card unless the caller asks for the CPU)."""
    states = [init_state(topo, window, p, device) for p in arrivals_prefixes]
    return SimState(*(torch.stack([getattr(s, f.name) for s in states])
                      for f in dataclasses.fields(SimState)))


def effective_qout(prob: SchedProblem, state: SimState) -> torch.Tensor:
    """Q_out(t): spouts derive it from the lookahead window (eq. 3)."""
    return torch.where(prob.is_spout[:, None], state.q_rem.sum(dim=-1), state.q_out_bolt)


def slot_update_rows(state: SimState, X, landing, new_arrivals, mu, selectivity_rows, is_spout,
                     comp_onehot, hold_mask=None):
    """Per-slot dynamics for a block of R rows (paper eqs. (2)-(10)).

    ``X`` (R, I) decision rows, ``landing`` (R,) tuples landing at these
    rows' instances (full column sums), ``new_arrivals`` (R, C) λ(t+W+1)
    entering the window, ``mu`` (R,), ``selectivity_rows`` (R, C),
    ``is_spout`` (R,) bool, ``comp_onehot`` (I, C) of the columns.

    ``hold_mask`` (R, C) marks streams whose mandatory arrivals could not
    ship under a disruption trace (DESIGN.md §9): their pos-0 leftover is
    carried into the next slot's current position instead of dropped. An
    all-alive slot has ``hold_mask == 0``, numerically a no-op.

    ``X @ comp_onehot`` is a plain large product in full f32, as in the
    reference (see ``core.potus._mandatory_dispatch`` for why it is not an
    ``index_add_``).
    """
    shipped = X @ comp_onehot  # (R, C) tuples leaving i toward component c

    # --- spouts: drain Q_rem in ascending w (actual first), shift window ----
    cum_before = torch.cumsum(state.q_rem, dim=-1) - state.q_rem
    drained = torch.minimum(torch.clamp_min(shipped[:, :, None] - cum_before, 0.0), state.q_rem)
    q_rem = state.q_rem - drained
    leftover = q_rem[..., 0]  # (R, C) pos-0 remainder about to shift out
    q_rem = torch.cat([q_rem[..., 1:], new_arrivals[..., None]], dim=-1)
    if hold_mask is not None:
        q_rem[..., 0] += leftover * hold_mask
    q_rem = q_rem * is_spout[:, None, None]

    # --- bolts: arrivals from X(t-1), service, emission --------------------
    is_bolt = ~is_spout
    total_in = state.q_in + state.transit
    served = torch.minimum(total_in, mu) * is_bolt
    q_in = (total_in - served) * is_bolt  # eq. (8)
    nu = served[:, None] * selectivity_rows  # (R, C) eq. (9) input
    q_out_bolt = (torch.clamp_min(state.q_out_bolt - shipped, 0.0) + nu) * is_bolt[:, None]

    transit = landing * is_bolt  # everything ships into bolt inputs

    new_state = SimState(q_in=q_in, q_rem=q_rem, q_out_bolt=q_out_bolt, transit=transit)
    return new_state, dict(shipped=shipped, served=served, drained=drained)


def slot_update(prob: SchedProblem, state: SimState, X, new_arrivals, mu, selectivity_rows,
                hold_mask=None):
    """:func:`slot_update_rows` over all I rows; ``landing`` is ``X``'s column sums."""
    comp_onehot = torch.nn.functional.one_hot(prob.inst_comp.long(),
                                              prob.n_components).to(X.dtype)
    return slot_update_rows(state, X, X.sum(dim=0), new_arrivals, mu, selectivity_rows,
                            prob.is_spout, comp_onehot, hold_mask=hold_mask)
