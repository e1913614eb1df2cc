"""Result record of the cohort engines (paper §5.1 response-time metric).

The port's counterpart of ``repro.core.cohort``: only :class:`CohortResult`
so far. The Python event-loop engine (``engine="cohort"``) is not ported yet
(ROADMAP.md, section 1, module item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.metrics import MetricsFrame

__all__ = ["CohortResult"]


@dataclasses.dataclass
class CohortResult:
    avg_response: float  # slots, weighted by actual arrivals
    p95_response: float
    avg_backlog: float
    avg_cost: float
    backlog: np.ndarray  # (T,)
    comm_cost: np.ndarray  # (T,)
    n_cohorts: int
    completed_frac: float
    # fraction of terminal completions reporting the age-capped response
    # (DESIGN.md §8): nonzero means age_cap is too shallow
    saturated_frac: float = 0.0
    # total tuple mass served at terminal bolts over the whole run (warmup
    # and phantoms included) — the conservation ledger
    completed_mass: float = 0.0
    # selected per-slot metric streams (DESIGN.md §14); None without metrics=
    metrics: MetricsFrame | None = None
