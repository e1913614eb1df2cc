"""Engine facade of the port: one frozen spec, one ``simulate()``
(DESIGN.md §12).

The port's counterpart of ``repro.core.engine``. :class:`EngineSpec` has the
reference's fields plus ``device``; :func:`simulate` validates the spec
against the same engine×option matrix (:data:`OPTION_SUPPORT`) and runs it.
All four engines are ported: ``engine="cohort-fused"`` (all four
schedulers, ``events=``, ``metrics=`` and ``sharded=True`` included),
``engine="jax"`` (the plain scan engine, ``metrics=`` included),
``engine="sharded"`` (the plain scan engine over an instance mesh of
ranks, ``core.sharded``) and ``engine="cohort"`` (the Python event loop,
the semantic oracle of the cohort engines, with ``events=``,
``predicted=`` and ``metrics=``). An option an engine lacks raises
:class:`UnsupportedEngineOption`, as in the reference; nothing runs
something else in its place.

``sharded`` appears twice, as in the reference: ``engine="sharded"`` is the
plain scan engine row-sharded over an instance mesh (DESIGN.md §7), and
``EngineSpec(engine="cohort-fused", sharded=True)`` shards the compact
cohort engine (DESIGN.md §13). Both are SPMD: every rank of a
``torch.distributed`` process group calls :func:`simulate` with the same
spec and gets the same result; without a process group the world is one
rank.

A run takes ``device="cuda"`` unless the caller asks for the CPU. Asking for
CUDA where there is none raises; the port never falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..device import resolve_device
from ..obs.metrics import MetricsSpec, stream_engines, unsupported_streams

__all__ = ["EngineSpec", "UnsupportedEngineOption", "simulate", "ENGINES",
           "PORTED_ENGINES", "OPTION_SUPPORT", "check_engine_option", "check_metrics_spec",
           "resolve_device"]

#: engines of the reference facade
ENGINES = ("jax", "sharded", "cohort", "cohort-fused")

#: engines the port runs: all of the reference's
PORTED_ENGINES = ENGINES

#: which engines support which :class:`EngineSpec` option (an option absent
#: here is universal) — the reference's matrix, so a spec written for the
#: reference validates the same way
OPTION_SUPPORT = {
    "use_pallas": ("jax", "cohort", "cohort-fused"),
    "chunk": ("jax", "cohort-fused"),
    "mu": ("jax", "sharded"),
    "predicted": ("cohort", "cohort-fused"),
    "warmup": ("cohort", "cohort-fused"),
    "drain_margin": ("cohort", "cohort-fused"),
    "service": ("cohort-fused",),
    "age_cap": ("cohort-fused",),
    "slots_per_launch": ("cohort-fused",),
    "sharded": ("sharded", "cohort-fused"),
    # which *streams* an engine serves is per-stream data
    # (obs.ENGINE_STREAMS), checked by check_metrics_spec (DESIGN.md §14)
    "metrics": ("jax", "sharded", "cohort", "cohort-fused"),
}

#: the reference's schedulers, all ported on every ported engine
SCHEDULERS = ("potus", "potus-loop", "shuffle", "jsq")

#: proximity order used to name the "nearest" supporting engine
_NEAREST = {
    "jax": ("sharded", "cohort-fused", "cohort"),
    "sharded": ("jax", "cohort-fused", "cohort"),
    "cohort": ("cohort-fused", "jax", "sharded"),
    "cohort-fused": ("cohort", "jax", "sharded"),
}


class UnsupportedEngineOption(ValueError):
    """An :class:`EngineSpec` option the selected engine does not implement,
    or one the port has not ported yet. The message names the option, the
    rejecting engine, the reason, and the nearest ported engine that
    supports the option, if any."""

    def __init__(self, engine: str, option: str, supported: tuple = (),
                 reason: str = ""):  # noqa: D107
        self.engine = engine
        self.option = option
        self.reason = reason
        supported = supported or OPTION_SUPPORT.get(option, ENGINES)
        self.nearest = next((e for e in _NEAREST.get(engine, ENGINES) if e in supported),
                            None)
        hint = (f"; the nearest engine that does is engine={self.nearest!r}"
                if self.nearest else "")
        why = f" ({reason})" if reason else ""
        super().__init__(
            f"engine={engine!r} does not support option {option!r}{why}{hint}"
        )


def check_engine_option(engine: str, option: str) -> None:
    """Raise :class:`UnsupportedEngineOption` unless ``engine`` supports
    ``option`` per :data:`OPTION_SUPPORT`."""
    supported = OPTION_SUPPORT.get(option, ENGINES)
    if engine not in supported:
        raise UnsupportedEngineOption(engine, option, supported)


def check_metrics_spec(engine: str, metrics):
    """Coerce ``EngineSpec(metrics=...)`` to a ``MetricsSpec`` (or None) and
    reject streams the engine cannot compute, with the same normalized error
    shape as a whole unsupported option (shared with ``run_sweep``)."""
    spec = MetricsSpec.coerce(metrics)
    if spec is None:
        return None
    bad = unsupported_streams(engine, spec)
    if bad:
        raise UnsupportedEngineOption(
            engine, f"metrics[{bad[0]}]", supported=stream_engines(bad[0]),
            reason=f"stream {bad[0]!r} needs engine state {engine!r} lacks")
    return spec


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One run, fully specified — the argument to :func:`simulate`.

    The reference's fields under the same names, plus ``device``. Options
    left at their defaults are "unset": setting a value on an engine that
    lacks the option raises :class:`UnsupportedEngineOption`. ``use_pallas``
    is kept so that a spec written for the reference validates the same way,
    but it selects nothing here: the device decides, and on CUDA a compact
    scheduler's slot runs the hand-written kernel, on the CPU its plain
    version — except under ``events=`` or ``metrics=``, where the slot runs
    ``compact_slot_step`` as in the reference (DESIGN.md §14).
    """

    topo: Any  # Topology
    net: Any  # NetworkCosts
    placement: Any  # (I,) instance -> container
    arrivals: Any  # (T', I, C) array | ArrivalSpec
    T: int
    engine: str = "cohort-fused"  # jax | sharded | cohort | cohort-fused
    scheduler: str = "potus"
    V: float = 3.0
    beta: float = 1.0
    window: int = 0
    use_pallas: bool = False
    predicted: Any = None  # distinct predicted arrivals (cohort engines)
    events: Any = None  # EventTrace — disruption trace (DESIGN.md §9)
    mu: Any = None  # capacity override (scan engines)
    chunk: int | None = None  # streaming scan (DESIGN.md §11)
    service: Any = None  # token-length service-time axis (DESIGN.md §10)
    warmup: int = 50
    drain_margin: int | None = None
    age_cap: int = 64
    slots_per_launch: int = 1  # slots per kernel launch (DESIGN.md §12)
    sharded: bool = False  # shard cohort-fused over the instance mesh (DESIGN.md §13)
    metrics: Any = None  # MetricsSpec | stream names | True (DESIGN.md §14)
    device: str = "cuda"  # "cuda" or "cpu"

    def config(self):
        """The :class:`~repro_torch.core.simulator.SimConfig` equivalent."""
        from .simulator import SimConfig

        return SimConfig(V=self.V, beta=self.beta, window=self.window,
                         scheduler=self.scheduler, use_pallas=self.use_pallas,
                         sharded=self.engine == "sharded" or self.sharded)

    def _set_options(self):
        """Option names carrying a non-default value."""
        defaults = {f.name: f.default for f in dataclasses.fields(EngineSpec)
                    if f.name in OPTION_SUPPORT or f.name == "events"}
        return [name for name, default in defaults.items()
                if (getattr(self, name) is not None if default is None
                    else getattr(self, name) != default)]

    def validate(self) -> None:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; expected one of {ENGINES}")
        for option in self._set_options():
            check_engine_option(self.engine, option)
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")


def simulate(spec: EngineSpec):
    """Run one fully specified simulation on ``spec.device`` and return the
    engine's result: :class:`~repro_torch.core.simulator.SimResult` for
    the scan engines (``jax``, ``sharded``),
    :class:`~repro_torch.core.cohort.CohortResult` for the cohort engines."""
    spec.validate()
    metrics = check_metrics_spec(spec.engine, spec.metrics)
    device = resolve_device(spec.device)
    if spec.engine in ("jax", "sharded"):
        from .simulator import _run_sim_impl

        return _run_sim_impl(spec.topo, spec.net, spec.placement, spec.arrivals, spec.T,
                             spec.config(), mu=spec.mu, events=spec.events, chunk=spec.chunk,
                             metrics=metrics, device=device)
    if spec.engine == "cohort":
        from .cohort import _run_cohort_sim_impl

        return _run_cohort_sim_impl(
            spec.topo, spec.net, spec.placement, spec.arrivals, spec.predicted,
            spec.T, spec.config(), warmup=spec.warmup, drain_margin=spec.drain_margin,
            events=spec.events, metrics=metrics, device=device,
        )
    from .cohort_fused import _run_cohort_fused_impl

    return _run_cohort_fused_impl(
        spec.topo, spec.net, spec.placement, spec.arrivals, spec.predicted,
        spec.T, spec.config(), warmup=spec.warmup, drain_margin=spec.drain_margin,
        age_cap=spec.age_cap, events=spec.events, service=spec.service, chunk=spec.chunk,
        slots_per_launch=spec.slots_per_launch, metrics=metrics, device=device,
        sharded=spec.sharded,
    )
