"""Core of the PyTorch port: problem builders, disruption traces, the
schedulers, the plain scan engine, the compact slot step, the fused cohort
engine, the host-loop oracles (the cohort event loop and
``run_event_sim``), the ``simulate(EngineSpec)`` facade and scenario sweeps
(``run_sweep``)."""
from .baselines import jsq_schedule, shuffle_schedule
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
from .eventsim import EventSimResult, run_event_sim
from .events import (
    EventTrace,
    FleetEvent,
    FleetScenario,
    diurnal_autoscale,
    flash_straggler,
    identity_trace,
    k_failures,
    random_chaos,
    rolling_restart,
)
from .network import NetworkCosts, container_costs, fat_tree, jellyfish
from .placement import random_placement, t_heron_placement
from .potus import SchedProblem, SlotCaps, apply_caps, make_problem, potus_prices, potus_schedule
from .queues import SimState, effective_qout, init_state, init_state_batch, slot_update
from .simulator import SimConfig, SimResult, materialize_arrivals, pad_arrivals, sim_step
from .sweep import Scenario, SweepResult, SweepSpec, run_sweep
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
    "Component", "ENGINES", "EngineSpec", "EventSimResult", "EventTrace", "FleetEvent",
    "FleetScenario",
    "GENERATORS", "NetworkCosts", "OPTION_SUPPORT", "PORTED_ENGINES", "Scenario",
    "SchedProblem", "SimConfig", "SimResult", "SimState", "SlotCaps", "StepConsts",
    "SweepResult", "SweepSpec", "Topology",
    "UnsupportedEngineOption", "apply_caps", "build_topology", "compact_decide",
    "compact_slot_step", "container_costs", "diamond_app", "diurnal_autoscale", "drain_ages",
    "effective_qout", "fat_tree", "feasible_rates", "flash_straggler", "identity_trace",
    "init_state", "init_state_batch", "jellyfish", "jsq_schedule", "k_failures", "linear_app", "make_problem",
    "materialize_arrivals", "pad_arrivals", "poisson_arrivals", "potus_prices",
    "potus_schedule", "random_apps", "random_chaos", "random_placement", "rolling_restart",
    "run_event_sim", "run_sweep",
    "shuffle_schedule", "sim_step", "simulate", "slot_update", "spout_rate_matrix",
    "t_heron_placement", "trace_synthetic",
]
