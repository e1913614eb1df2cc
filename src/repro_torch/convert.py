"""Carry the reference's numbers across to the port.

The tests build a problem once with the JAX package, take its
``StepConsts`` fields and its 7-tuple cohort state, or its ``SchedProblem``
and its scan-engine ``SimState``, as numpy arrays, and hand them to both
sides with these helpers, so that the reference and the port compute from
the same numbers (a mid-run state included). Nothing here imports the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.compact import StepConsts, kernel_layout
from .core.potus import SchedProblem
from .core.queues import SimState

__all__ = ["step_consts_from_numpy", "state_from_numpy", "sched_problem_from_numpy",
           "sim_state_from_numpy"]

_INT_FIELDS = ("succ_map", "inst_comp", "inst_cont")


def step_consts_from_numpy(fields, *, device="cpu", dtype=torch.float32) -> StepConsts:
    """A port :class:`StepConsts` from the reference's seventeen fields (a
    mapping or a NamedTuple of array-likes), on ``device`` in ``dtype``; the
    index fields become int32, and the kernel's instance layout is derived
    from ``inst_comp``/``inst_cont``."""
    f = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    out = {}
    for name in StepConsts._fields[:17]:
        x = np.array(f[name])
        out[name] = torch.as_tensor(
            x, dtype=torch.int32 if name in _INT_FIELDS else dtype, device=device)
    C = np.asarray(f["adj_rows"]).shape[1]
    K = np.asarray(f["U"]).shape[0]
    layout = kernel_layout(np.asarray(f["inst_comp"]), np.asarray(f["inst_cont"]), C, K)
    for name, x in zip(StepConsts._fields[17:], layout):
        out[name] = torch.as_tensor(x, dtype=torch.int32, device=device)
    return StepConsts(**out)


def state_from_numpy(state, *, device="cpu", dtype=torch.float32) -> tuple:
    """The cohort state ``(q_rem, admit, q_in, q_out, transit, resp_mass,
    resp_time)`` as tensors on ``device`` in ``dtype``."""
    return tuple(torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()
                 for x in state)


_PROBLEM_DTYPES = {"edge_mask": torch.bool, "inst_comp": torch.int32,
                   "inst_container": torch.int32, "gamma": torch.float32,
                   "comp_count": torch.float32, "is_spout": torch.bool}


def sched_problem_from_numpy(prob, *, device="cpu") -> SchedProblem:
    """A port :class:`SchedProblem` from the reference's (any object with its
    fields as array-likes, plus ``max_succ`` and ``n_components``)."""
    return SchedProblem(
        **{name: torch.as_tensor(np.array(getattr(prob, name)), dtype=dtype, device=device)
           for name, dtype in _PROBLEM_DTYPES.items()},
        max_succ=int(prob.max_succ), n_components=int(prob.n_components))


def sim_state_from_numpy(state, *, device="cpu", dtype=torch.float32) -> SimState:
    """A port :class:`SimState` from the reference's (``q_in``, ``q_rem``,
    ``q_out_bolt``, ``transit`` as array-likes)."""
    return SimState(*(torch.as_tensor(np.array(getattr(state, name)), dtype=dtype,
                                      device=device).contiguous()
                      for name in ("q_in", "q_rem", "q_out_bolt", "transit")))
