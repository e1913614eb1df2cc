"""Arrival-process generators (paper §5.1 "Traffic Workloads"; DESIGN.md §11).

The paper drives simulations with (a) Poisson arrivals and (b) traces from
Benson et al. [46], which are not available offline. ``trace_synthetic``
substitutes a bursty superposed on-off + diurnal-modulated process with the
same mean rate, and is labeled `trace-synthetic` everywhere it is reported.

Heavy-traffic generators (DESIGN.md §11.1) extend that to the regimes the
storm/stream-scheduling literature motivates: heavy-tailed (Pareto,
lognormal), Markov-modulated (MMPP), diurnal-with-flash-crowd, and exact
trace replay. All modulated generators are *mixed Poisson*: a nonnegative
modulation series ``g_t`` with mean exactly 1 scales the per-stream rate
matrix, and integer counts are drawn as ``Poisson(rates * g_t)``. That keeps
three invariants at once — the nominal mean rate is preserved exactly in
expectation, outputs stay integer-valued (the slot engines assume tuple
counts), and the modulation's tail/burstiness structure survives in the
counts (a Pareto-mixed Poisson has Pareto tail index, an MMPP has index of
dispersion strictly above Poisson's 1).

The modulation is *shared across streams* (one global ``g_t``), modeling the
correlated source bursts of real stream workloads: when a flash crowd hits,
every spout sees it.

``ArrivalSpec`` wraps a generator name + parameters into a declarative,
picklable description that ``run_sim`` / ``run_cohort_sim`` /
``run_cohort_fused`` / ``run_sweep`` all accept in place of a materialized
``(T, I, C)`` array; they call :meth:`ArrivalSpec.generate` with their
topology and horizon, so a sweep over horizons or topologies needs only one
spec object.

A numpy copy of ``repro.core.workload``, kept in the port so that it imports nothing of the
JAX package; it must stay ``np.array_equal`` to the reference from the same seed
(``tests/test_torch_numpy_copies.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .topology import Topology

__all__ = [
    "spout_rate_matrix",
    "poisson_arrivals",
    "trace_synthetic",
    "feasible_rates",
    "pareto_arrivals",
    "lognormal_arrivals",
    "mmpp_arrivals",
    "diurnal_flash_arrivals",
    "trace_replay",
    "ArrivalSpec",
    "GENERATORS",
]


def spout_rate_matrix(topo: Topology, rate_per_stream: float) -> np.ndarray:
    """(I, C) mean arrival rate per (spout instance, successor component)."""
    I, C = topo.n_instances, topo.n_components
    rates = np.zeros((I, C), dtype=np.float64)
    for i in range(I):
        c = int(topo.inst_comp[i])
        if not topo.comp_is_spout[c]:
            continue
        for c2 in topo.successors_of_comp(c):
            rates[i, c2] = rate_per_stream
    return rates


def feasible_rates(topo: Topology, utilization: float = 0.7) -> np.ndarray:
    """Pick per-stream spout rates so the busiest resource runs at
    ~``utilization`` — both processing (parallelism × mu per component) and
    transmission (gamma per instance) are respected."""
    C = topo.n_components
    unit = spout_rate_matrix(topo, 1.0)  # (I, C) unit per-stream rates
    through = topo.expected_rates(unit)  # (C,) processed rate per comp

    worst = 0.0
    for c in range(C):
        inst = topo.instances_of(c)
        if topo.comp_is_spout[c]:
            # transmission: per spout instance, total outgoing streams / gamma
            out = unit[inst].sum(axis=1)
            worst = max(worst, float(np.max(out / topo.inst_gamma[inst])))
        else:
            cap = topo.comp_parallelism[c] * float(topo.inst_mu[inst[0]])
            worst = max(worst, through[c] / max(cap, 1e-9))
            # bolt transmission: emitted tuples per instance / gamma
            emit = through[c] * topo.selectivity[c].sum() / topo.comp_parallelism[c]
            worst = max(worst, float(emit / topo.inst_gamma[inst[0]]))
    scale = utilization / max(worst, 1e-9)
    return unit * scale


def poisson_arrivals(
    rng: np.random.Generator, rates: np.ndarray, T: int, lam_max: float = 1e9
) -> np.ndarray:
    """(T, I, C) iid Poisson arrivals, clipped at λ_max (paper boundedness)."""
    arr = rng.poisson(np.broadcast_to(rates, (T,) + rates.shape)).astype(np.float32)
    return np.minimum(arr, lam_max)


def _modulated(
    rng: np.random.Generator, rates: np.ndarray, g: np.ndarray, lam_max: float
) -> np.ndarray:
    """Mixed-Poisson counts from a (T,) modulation series with mean ~1."""
    lam = np.broadcast_to(rates, g.shape + rates.shape) * g[:, None, None]
    arr = rng.poisson(lam).astype(np.float32)
    return np.minimum(arr, lam_max)


def trace_synthetic(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    burst_prob: float = 0.08,
    burst_scale: float = 4.0,
    diurnal_period: int = 200,
    lam_max: float = 1e9,
) -> np.ndarray:
    """Bursty trace stand-in: on-off bursts on top of a diurnal-modulated base.

    Mean rate matches ``rates`` (the modulation is normalized)."""
    t = np.arange(T)
    diurnal = 1.0 + 0.5 * np.sin(2 * np.pi * t / diurnal_period)
    diurnal = diurnal / diurnal.mean()
    bursting = np.zeros(T, dtype=bool)
    state = False
    for i in range(T):  # two-state Markov on/off burst process
        if state:
            state = rng.random() > 0.35
        else:
            state = rng.random() < burst_prob
        bursting[i] = state
    boost = np.where(bursting, burst_scale, 1.0)
    boost = boost / boost.mean()
    return _modulated(rng, rates, diurnal * boost, lam_max)


def pareto_arrivals(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    alpha: float = 1.6,
    lam_max: float = 1e9,
) -> np.ndarray:
    """(T, I, C) heavy-tailed arrivals: Pareto(α, x_m=1)-mixed Poisson.

    Each slot's intensity is ``rates * g_t`` with ``g_t`` an iid Pareto
    variate rescaled to mean 1, so the per-slot count totals inherit the
    power-law tail (index ≈ α) while the long-run mean rate matches
    ``rates`` exactly in expectation. Requires α > 1 (finite mean)."""
    if alpha <= 1.0:
        raise ValueError(f"pareto_arrivals needs alpha > 1 for a finite mean rate, got {alpha}")
    g = 1.0 + rng.pareto(alpha, size=T)  # Pareto(alpha, x_m=1); mean a/(a-1)
    g = g * ((alpha - 1.0) / alpha)
    return _modulated(rng, rates, g, lam_max)


def lognormal_arrivals(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    sigma: float = 1.0,
    lam_max: float = 1e9,
) -> np.ndarray:
    """(T, I, C) lognormal-mixed Poisson arrivals (mean preserved exactly).

    ``g_t = exp(N(-σ²/2, σ²))`` has mean 1 for any σ; larger σ gives a
    heavier (subexponential) tail and a larger index of dispersion."""
    g = rng.lognormal(mean=-0.5 * sigma * sigma, sigma=sigma, size=T)
    return _modulated(rng, rates, g, lam_max)


def mmpp_arrivals(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    rate_ratio: float = 8.0,
    dwell_low: float = 40.0,
    dwell_high: float = 10.0,
    lam_max: float = 1e9,
) -> np.ndarray:
    """(T, I, C) two-state Markov-modulated Poisson arrivals.

    A slot-granularity two-state Markov chain switches the intensity between
    a low level and ``rate_ratio`` × that level; geometric sojourns have
    means ``dwell_low`` / ``dwell_high`` slots. Levels are solved so the
    stationary mean intensity equals ``rates`` exactly, so MMPP runs are
    rate-comparable with Poisson runs while the index of dispersion
    (Var/Mean of slot counts) is strictly above Poisson's 1."""
    if rate_ratio <= 1.0:
        raise ValueError(f"mmpp_arrivals needs rate_ratio > 1, got {rate_ratio}")
    p_lh = 1.0 / max(dwell_low, 1.0)  # P(low -> high)
    p_hl = 1.0 / max(dwell_high, 1.0)  # P(high -> low)
    pi_high = p_lh / (p_lh + p_hl)  # stationary P(high)
    low = 1.0 / ((1.0 - pi_high) + rate_ratio * pi_high)
    levels = np.array([low, rate_ratio * low])
    state = int(rng.random() < pi_high)  # start at stationarity
    u = rng.random(T)
    states = np.empty(T, dtype=np.int64)
    for t in range(T):  # sequential chain — cheap even at T=1e6
        states[t] = state
        flip = u[t] < (p_hl if state else p_lh)
        state = state ^ flip
    return _modulated(rng, rates, levels[states], lam_max)


def diurnal_flash_arrivals(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    period: int = 200,
    depth: float = 0.6,
    flash_prob: float = 0.01,
    flash_scale: float = 6.0,
    flash_len: int = 12,
    lam_max: float = 1e9,
) -> np.ndarray:
    """(T, I, C) diurnal base load with superimposed flash crowds.

    The base is a sinusoid of relative ``depth``; flash crowds start with
    per-slot probability ``flash_prob`` and multiply the intensity by
    ``flash_scale`` decaying linearly to 1 over ``flash_len`` slots
    (overlapping flashes take the max). The combined modulation is
    renormalized to mean 1, so the *realized* mean rate matches ``rates``."""
    t = np.arange(T)
    diurnal = 1.0 + depth * np.sin(2 * np.pi * t / period)
    starts = np.flatnonzero(rng.random(T) < flash_prob)
    flash = np.ones(T)
    decay = flash_scale - (flash_scale - 1.0) * np.arange(flash_len) / max(flash_len, 1)
    for s in starts:
        end = min(s + flash_len, T)
        flash[s:end] = np.maximum(flash[s:end], decay[: end - s])
    g = diurnal * flash
    g = g / g.mean()
    return _modulated(rng, rates, g, lam_max)


def trace_replay(
    rng: np.random.Generator,
    rates: np.ndarray,
    T: int,
    trace: np.ndarray | None = None,
    match_rate: bool = False,
    lam_max: float = 1e9,
) -> np.ndarray:
    """Replay a recorded trace, tiling it along the time axis to length T.

    Two trace shapes are accepted:

    * ``(T0, I, C)`` — a full arrival tensor (e.g. a previous generator's
      output): replayed verbatim. With ``match_rate=False`` (default) and
      ``T <= T0`` this is an *exact* round-trip: ``trace[:T]`` bit-for-bit.
    * ``(T0,)`` — a per-slot intensity series: normalized to mean 1 and used
      as a mixed-Poisson modulation of ``rates`` (this path consumes ``rng``).

    ``match_rate=True`` rescales a full tensor so its empirical mean matches
    ``rates.sum()`` per slot (counts become fractional — only meaningful for
    the fluid engines)."""
    if trace is None:
        raise ValueError("trace_replay requires a `trace` array")
    trace = np.asarray(trace)
    if trace.ndim == 1:
        m = float(trace.mean())
        if m <= 0:
            raise ValueError("1-D trace must have positive mean")
        reps = -(-T // trace.shape[0])  # ceil div
        g = np.tile(trace / m, reps)[:T]
        return _modulated(rng, rates, g, lam_max)
    if trace.ndim != 3:
        raise ValueError(f"trace must be (T0,) or (T0, I, C), got shape {trace.shape}")
    reps = -(-T // trace.shape[0])
    arr = np.concatenate([trace] * reps, axis=0)[:T].astype(np.float32, copy=False)
    if match_rate:
        m = float(arr.sum()) / arr.shape[0]
        target = float(np.asarray(rates).sum())
        if m > 0:
            arr = arr * np.float32(target / m)
    return np.minimum(arr, lam_max)


#: Generator registry keyed by ``ArrivalSpec.kind``. Every generator has the
#: uniform signature ``fn(rng, rates, T, **params) -> (T, I, C) float32``.
GENERATORS: dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "trace-synthetic": trace_synthetic,
    "pareto": pareto_arrivals,
    "lognormal": lognormal_arrivals,
    "mmpp": mmpp_arrivals,
    "diurnal-flash": diurnal_flash_arrivals,
    "trace-replay": trace_replay,
}


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Declarative arrival process: generator kind + rates + parameters.

    The entry points (``run_sim``, ``run_cohort_sim``, ``run_cohort_fused``,
    ``run_sweep``) accept an ``ArrivalSpec`` anywhere a materialized
    ``(T, I, C)`` arrival tensor is accepted; they materialize it against
    their own topology and horizon via :meth:`generate`. Rates come from
    ``rate_per_stream`` (uniform per stream) when set, else from
    :func:`feasible_rates` at ``utilization``.

    ``params`` are forwarded to the generator (see :data:`GENERATORS`), e.g.
    ``ArrivalSpec(kind="mmpp", params={"rate_ratio": 12.0})``.
    """

    kind: str = "poisson"
    seed: int = 0
    utilization: float = 0.7
    rate_per_stream: float | None = None
    lam_max: float = 1e9
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in GENERATORS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; known: {sorted(GENERATORS)}"
            )

    def rates_for(self, topo: Topology) -> np.ndarray:
        """(I, C) mean-rate matrix for this spec on ``topo``."""
        if self.rate_per_stream is not None:
            return spout_rate_matrix(topo, self.rate_per_stream)
        return feasible_rates(topo, self.utilization)

    def generate(
        self, topo: Topology, n_slots: int, rates: np.ndarray | None = None
    ) -> np.ndarray:
        """Materialize ``(n_slots, I, C)`` float32 arrivals for ``topo``."""
        if rates is None:
            rates = self.rates_for(topo)
        rng = np.random.default_rng(self.seed)
        fn = GENERATORS[self.kind]
        return fn(rng, rates, n_slots, lam_max=self.lam_max, **self.params)
