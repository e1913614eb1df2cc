"""Core of the PyTorch port: problem builders, the compact slot step, the
fused cohort engine and the ``simulate(EngineSpec)`` facade."""
from .cohort import CohortResult
from .cohort_fused import AgeCapSaturationWarning, drain_ages
from .compact import COMPACT_SCHEDULERS, StepConsts, compact_decide, compact_slot_step
from .engine import (
    ENGINES,
    OPTION_SUPPORT,
    PORTED_ENGINES,
    EngineSpec,
    UnsupportedEngineOption,
    simulate,
)
from .network import NetworkCosts, container_costs, fat_tree, jellyfish
from .placement import random_placement, t_heron_placement
from .simulator import SimConfig, materialize_arrivals, pad_arrivals
from .topology import Component, Topology, build_topology, diamond_app, linear_app, random_apps
from .workload import (
    GENERATORS,
    ArrivalSpec,
    feasible_rates,
    poisson_arrivals,
    spout_rate_matrix,
    trace_synthetic,
)

__all__ = [
    "AgeCapSaturationWarning", "ArrivalSpec", "COMPACT_SCHEDULERS", "CohortResult",
    "Component", "ENGINES", "EngineSpec", "GENERATORS", "NetworkCosts", "OPTION_SUPPORT",
    "PORTED_ENGINES", "SimConfig", "StepConsts", "Topology", "UnsupportedEngineOption",
    "build_topology", "compact_decide", "compact_slot_step", "container_costs",
    "diamond_app", "drain_ages", "fat_tree", "feasible_rates", "jellyfish", "linear_app",
    "materialize_arrivals", "pad_arrivals", "poisson_arrivals", "random_apps",
    "random_placement", "simulate", "spout_rate_matrix", "t_heron_placement",
    "trace_synthetic",
]
