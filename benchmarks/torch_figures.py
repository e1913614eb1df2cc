"""The paper's figure sweeps and the disruption benchmark on the PyTorch port.

The port's counterparts of ``benchmarks/paper_figures.py`` (Figs. 4, 5 with
its ``fig5/sweep_speedup`` row, 6ab and 6c) and of the transient grid and
disruption rows of ``benchmarks/disruption.py``, run through
``repro_torch.core.run_sweep`` on the card (or on the CPU with ``--device
cpu``). The grids, seeds and sizes are the reference's; the rows are the same
``name,us_per_call,derived`` CSV. Run from the repository root:

    PYTHONPATH=src python -m benchmarks.torch_figures [section ...] [--device cpu]
        [--json PATH]

Sections: fig4, fig5, fig6ab, fig6c, disruption, obs (all when none is named).
``obs`` is the counterpart of ``benchmarks/disruption.py``'s metrics dump: the
k-failure POTUS transient with every ``cohort-fused`` metric stream and span
tracing on, written to ``OBS_disruption_torch.json`` (``repro-obs/v1``; read
it with ``python tools/obs_report.py OBS_disruption_torch.json --recovery``)
and ``TRACE_disruption_torch.json`` (Chrome trace), paths overridable with
``REPRO_TORCH_OBS_DISRUPTION_JSON`` and ``REPRO_TORCH_OBS_TRACE_JSON``.
``REPRO_BENCH_FULL=1`` takes the full grids, ``REPRO_BENCH_SMOKE=1`` the
smoke size. ``--json PATH`` also writes ``repro-bench/v2`` rows with the
engine names ``torch-cohort-fused`` and ``torch-jax``, so their
``tools/bench_diff.py`` keys never meet the reference's rows. The module
imports only ``repro_torch``, numpy and the standard library: the system
builders and the CSV/JSON rows are its own copies (``benchmarks/common.py``
imports the JAX package).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from repro_torch.core import (EngineSpec, SimConfig, SweepSpec, build_topology,
                              container_costs, fat_tree, feasible_rates, jellyfish, k_failures,
                              poisson_arrivals, random_apps, run_sweep, simulate,
                              t_heron_placement, trace_synthetic)
from repro_torch.core.prediction import misprediction_scenarios, mse, predictor_scenarios
from repro_torch.obs import disable_tracing, enable_tracing, export_chrome_trace

QUICK = os.environ.get("REPRO_BENCH_FULL", "0") != "1"
SMOKE = os.environ.get("REPRO_BENCH_SMOKE", "0") == "1"
T_SIM = 40 if SMOKE else (300 if QUICK else 1500)
T_COHORT = 40 if SMOKE else (300 if QUICK else 800)
BENCH_JSON_SCHEMA = "repro-bench/v2"

#: the fused engine's age cap per figure (responses of high-V grids are ~O(V))
AGE_CAP = {"fig4": 64, "fig6ab": 288, "fig6c": 64}

#: repro-bench/v2 rows of the sections run in this process
BENCH_ROWS: list[dict] = []


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float
    derived: str

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.2f},{self.derived}"


def bench_row(section: str, engine: str, scheduler: str, I: int, T: int, wall_s: float,
              speedup: float = 1.0, scenario: str = "steady", **extra) -> dict:
    """One row of the shared ``repro-bench/v2`` schema."""
    row = dict(section=section, engine=engine, scheduler=scheduler, I=int(I), T=int(T),
               wall_s=round(float(wall_s), 4), speedup=round(float(speedup), 2),
               scenario=scenario)
    row.update(extra)
    return row


@dataclasses.dataclass
class System:
    name: str
    topo: object
    net: object
    rates: np.ndarray
    placement: np.ndarray


def paper_system(topology: str = "fat-tree", seed: int = 0) -> System:
    """5 apps, depth 3-5, 3-6 components, mu 3-5 (paper §5.1), on a 16-server
    fabric with 2 containers each."""
    rng = np.random.default_rng(seed)
    topo = build_topology(random_apps(rng, n_apps=5), gamma=24.0)
    if topology == "fat-tree":
        server_dist, _ = fat_tree(4)
    else:
        server_dist, _ = jellyfish(np.random.default_rng(seed + 1), 24, 16)
    net = container_costs(topology, server_dist)
    rates = feasible_rates(topo, utilization=0.7)
    placement = t_heron_placement(topo, net, rates, max_per_container=8)
    return System(topology, topo, net, rates, placement)


def arrivals_for(sys_: System, kind: str, T: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        return poisson_arrivals(rng, sys_.rates, T + 64)
    return trace_synthetic(rng, sys_.rates, T + 64)


def _sweep(sys_: System, arrivals, T: int, spec: SweepSpec, device, **kw):
    """``run_sweep`` on the system, timed by the host clock: (result, s)."""
    t0 = time.perf_counter()
    sw = run_sweep(sys_.topo, sys_.net, sys_.placement, arrivals, T, spec, device=device, **kw)
    return sw, time.perf_counter() - t0


def _engine_name(engine: str) -> str:
    return "torch-" + engine


def fig4_response_vs_w(device="cuda") -> list[Row]:
    """Fig. 4: average response time against the lookahead window W."""
    rows = []
    Ws = [0, 1, 2, 4, 6, 10] if QUICK else [0, 1, 2, 3, 4, 5, 6, 8, 10, 12]
    for topology in (["fat-tree"] if QUICK else ["fat-tree", "jellyfish"]):
        sys_ = paper_system(topology)
        for kind in ("poisson", "trace"):
            arr = arrivals_for(sys_, kind, T_COHORT)
            opts = {"age_cap": AGE_CAP["fig4"]}
            sw, t1 = _sweep(sys_, arr, T_COHORT, SweepSpec(V=1.0, window=tuple(Ws)), device,
                            engine="cohort-fused", engine_opts=opts)
            sh, t2 = _sweep(sys_, arr, T_COHORT, SweepSpec(V=1.0, scheduler="shuffle"), device,
                            engine="cohort-fused", engine_opts=opts)
            derived = ";".join(f"W{s.window}={r.avg_response:.2f}" for s, r in sw)
            derived += f";shuffle={sh.results[0].avg_response:.2f}"
            rows.append(Row(f"fig4/{topology}/{kind}",
                            (t1 + t2) / (len(Ws) * T_COHORT) * 1e6, derived))
            BENCH_ROWS.append(bench_row("fig4", _engine_name("cohort-fused"), "potus",
                                        sys_.topo.n_instances, T_COHORT, t1 / len(sw),
                                        scenario=f"{topology}/{kind}"))
    return rows


FIG5_VS = [1, 2, 5, 10, 16, 25, 50] if QUICK else [1, 2, 5, 10, 16, 25, 40, 50, 70, 100]


def fig5_sweep(topology: str = "fat-tree", device="cuda"):
    """Fig. 5's (V x W) grid on the scan engine: (system, arrivals, spec,
    sweep, wall s)."""
    sys_ = paper_system(topology)
    arr = arrivals_for(sys_, "trace", T_SIM)
    spec = SweepSpec(V=tuple(float(v) for v in FIG5_VS), window=(0, 5))
    sw, wall = _sweep(sys_, arr, T_SIM, spec, device)
    return sys_, arr, spec, sw, wall


def _run_jax(sys_: System, arr, T: int, cfg, device):
    return simulate(EngineSpec(topo=sys_.topo, net=sys_.net, placement=sys_.placement,
                               arrivals=arr, T=T, engine="jax", scheduler=cfg.scheduler,
                               V=cfg.V, beta=cfg.beta, window=cfg.window, device=device))


def fig5_rows(topology: str, sw, shuffle, wall: float) -> list[Row]:
    us = wall / (len(sw) * T_SIM) * 1e6
    rows = []
    for W in (0, 5):
        pts = sw.select(window=W)
        rows.append(Row(f"fig5ab/{topology}/W{W}", us,
                        ";".join(f"V{v}={r.avg_backlog:.0f}" for v, (_, r) in zip(FIG5_VS, pts))
                        + f";shuffle={shuffle.avg_backlog:.0f}"))
        rows.append(Row(f"fig5cd/{topology}/W{W}", us,
                        ";".join(f"V{v}={r.avg_cost:.1f}" for v, (_, r) in zip(FIG5_VS, pts))
                        + f";shuffle={shuffle.avg_cost:.1f}"))
    return rows


def fig5_backlog_and_cost_vs_v(device="cuda") -> list[Row]:
    """Fig. 5(a,b): backlog against V; Fig. 5(c,d): communication cost
    against V; and the ``fig5/sweep_speedup`` row."""
    rows, speedup_row = [], None
    for topology in (["fat-tree"] if QUICK else ["fat-tree", "jellyfish"]):
        sys_, arr, spec, sw, wall = fig5_sweep(topology, device)
        t0 = time.perf_counter()
        sh = _run_jax(sys_, arr, T_SIM, SimConfig(V=1.0, window=0, scheduler="shuffle"),
                      device)
        wall += time.perf_counter() - t0
        rows += fig5_rows(topology, sw, sh, wall)
        BENCH_ROWS.append(bench_row("fig5", _engine_name("jax"), "potus", sys_.topo.n_instances,
                                    T_SIM, wall / len(sw), scenario=topology))
        if speedup_row is None:
            speedup_row = _sweep_speedup_row(sys_, arr, spec, device)
    return rows + [speedup_row]


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _sweep_speedup_row(sys_: System, arr, spec: SweepSpec, device) -> Row:
    """The sweep against a loop of ``simulate`` calls on the figure's grid
    with POTUS and Shuffle, warm, best of 2."""
    spec = SweepSpec(V=spec.V, beta=spec.beta, window=spec.window,
                     scheduler=("potus", "shuffle"))
    scenarios = spec.scenarios()

    def batched():
        run_sweep(sys_.topo, sys_.net, sys_.placement, arr, T_SIM, spec, device=device)

    def sequential():
        for scn in scenarios:
            _run_jax(sys_, arr, T_SIM, scn.config(), device)

    batched()
    sequential()
    t_batch = min(_timed(batched) for _ in range(2))
    t_seq = min(_timed(sequential) for _ in range(2))
    return Row("fig5/sweep_speedup", t_batch / (len(scenarios) * T_SIM) * 1e6,
               f"grid={len(scenarios)};batched_s={t_batch:.3f};sequential_s={t_seq:.3f};"
               f"speedup={t_seq / t_batch:.2f}x")


FIG6AB_VS = [1, 5, 10, 20] if QUICK else [1, 2, 5, 10, 15, 20, 30]


def fig6ab_sweep(device="cuda"):
    """Fig. 6ab's (V x predictor) grid, W=1, on the fused engine: one
    partition with stacked streams. Returns (system, arrivals, predictions,
    sweep, wall s)."""
    sys_ = paper_system("fat-tree")
    arr = arrivals_for(sys_, "trace", T_COHORT)
    preds = predictor_scenarios(arr, seed=5)
    spec = SweepSpec(V=tuple(float(v) for v in FIG6AB_VS), window=1,
                     arrival=tuple(preds.keys()))
    sw, wall = _sweep(sys_, {name: (arr, pred) for name, pred in preds.items()}, T_COHORT,
                      spec, device, engine="cohort-fused",
                      engine_opts={"age_cap": AGE_CAP["fig6ab"]})
    return sys_, arr, preds, sw, wall


def fig6ab_rows(arr, preds, sw, wall: float) -> list[Row]:
    us = wall / (len(sw) * T_COHORT) * 1e6
    rows = []
    for name, pred in preds.items():
        err = 0.0 if pred is None else mse(pred[:T_COHORT], arr[:T_COHORT])
        d = ";".join(f"V{v}:cost={r.avg_cost:.1f}:resp={r.avg_response:.2f}"
                     for v, (_, r) in zip(FIG6AB_VS, sw.select(arrival=name)))
        rows.append(Row(f"fig6ab/{name}", us, f"mse={err:.2f};{d}"))
    return rows


def fig6ab_predictors(device="cuda") -> list[Row]:
    """Fig. 6(a,b): cost and response under the imperfect predictors, W=1."""
    sys_, arr, preds, sw, wall = fig6ab_sweep(device)
    BENCH_ROWS.append(bench_row("fig6ab", _engine_name("cohort-fused"), "potus",
                                sys_.topo.n_instances, T_COHORT, wall / len(sw),
                                scenario="predictors"))
    return fig6ab_rows(arr, preds, sw, wall)


def fig6c_misprediction_extremes(device="cuda") -> list[Row]:
    """Fig. 6(c): all-true-negative and false-positive(x) predictions,
    response against W."""
    sys_ = paper_system("fat-tree")
    arr = arrivals_for(sys_, "poisson", T_COHORT)
    Ws = [0, 2, 4, 6, 10] if QUICK else [0, 1, 2, 3, 4, 6, 8, 10]
    cases = misprediction_scenarios(arr, fp_levels=(10.0, 20.0, 30.0))
    spec = SweepSpec(V=1.0, window=tuple(Ws), arrival=tuple(cases.keys()))
    sw, wall = _sweep(sys_, {name: (arr, pred) for name, pred in cases.items()}, T_COHORT,
                      spec, device, engine="cohort-fused",
                      engine_opts={"age_cap": AGE_CAP["fig6c"]})
    us = wall / (len(sw) * T_COHORT) * 1e6
    BENCH_ROWS.append(bench_row("fig6c", _engine_name("cohort-fused"), "potus",
                                sys_.topo.n_instances, T_COHORT, wall / len(sw),
                                scenario="misprediction"))
    return [Row(f"fig6c/{name}", us,
                ";".join(f"W{s.window}={r.avg_response:.2f}" for s, r in sw.select(arrival=name)))
            for name in cases]


def _transient(T: int, windows=None):
    """The transient of ``benchmarks/disruption.py``: a k-instance failure one
    third into the run that recovers after a sixth of it. Returns (system,
    t0, dur, scenario, arrivals, Ws, engine_opts)."""
    sys_ = paper_system("fat-tree")
    t0, dur = T // 3, max(T // 6, 4)
    k = max(int(0.2 * len(sys_.topo.bolt_instances)), 2)
    scen = k_failures(sys_.topo, k=k, start=t0, duration=dur, rng=np.random.default_rng(11))
    arr = arrivals_for(sys_, "poisson", T)
    Ws = windows or ((0, 2, 6) if (QUICK or SMOKE) else (0, 1, 2, 4, 6, 10))
    # responses of cohorts arriving while instances are down (and the recovery
    # tail); age_cap covers the outage and the queueing
    opts = {"age_cap": max(4 * dur, 48), "warmup": max(t0 - 1, 1),
            "drain_margin": T - min(t0 + dur + 10, T - 1)}
    return sys_, t0, dur, scen, arr, Ws, opts


def transient_grid(device="cuda", T: int = T_COHORT, windows=None):
    """``benchmarks/disruption.py``'s grid: (potus, shuffle) x W x (none,
    kfail) through the failure transient (``windows`` replaces its W axis).
    Returns (system, T, t0, dur, scenario, Ws, sweep, wall s)."""
    sys_, t0, dur, scen, arr, Ws, opts = _transient(T, windows)
    spec = SweepSpec(V=1.0, window=Ws, scheduler=("potus", "shuffle"),
                     events=("none", "kfail"))
    sw, wall = _sweep(sys_, arr, T, spec, device, engine="cohort-fused",
                      events={"kfail": scen}, engine_opts=opts)
    return sys_, T, t0, dur, scen, Ws, sw, wall


def recovery_slots(backlog: np.ndarray, t0: int, t1: int) -> int:
    """Slots after recovery until backlog returns within 10% of the
    pre-failure mean (the horizon's end if it never does)."""
    pre = backlog[max(t0 - 20, 0):t0].mean()
    ok = np.nonzero(backlog[t1:] <= 1.1 * pre)[0]
    return int(ok[0]) if ok.size else int(len(backlog[t1:]))


def degradation(sw, sched: str, W: int) -> float:
    """Transient response under the failure minus the same scheduler and
    window's undisturbed transient response (the same arrival slots)."""
    hurt = sw.result(scheduler=sched, window=W, events="kfail").avg_response
    base = sw.result(scheduler=sched, window=W, events="none").avg_response
    return float(hurt - base)


def disruption_rows(grid) -> list[Row]:
    """The rows of ``benchmarks/disruption.py:disruption_bench`` from a
    :func:`transient_grid` (and their ``repro-bench/v2`` rows)."""
    sys_, T, t0, dur, scen, Ws, sw, wall = grid
    rows = []
    shuffle_deg = {W: degradation(sw, "shuffle", W) for W in Ws}
    for sched in ("potus", "shuffle"):
        for W in Ws:
            deg = degradation(sw, sched, W)
            tr = sw.result(scheduler=sched, window=W, events="kfail")
            tr0 = sw.result(scheduler=sched, window=W, events="none")
            rec = recovery_slots(tr.backlog, t0, t0 + dur)
            peak = float(tr.backlog[t0:t0 + dur + 10].max())
            peak0 = float(tr0.backlog[t0:t0 + dur + 10].max())
            speedup = shuffle_deg[W] / deg if sched == "potus" and deg > 1e-9 else 1.0
            rows.append(Row(
                f"disruption/{sched}/W{W}", wall / (len(sw) * T) * 1e6,
                f"resp_transient={tr.avg_response:.2f};resp_degradation={deg:.2f};"
                f"peak_backlog={peak:.0f};peak_backlog_undisturbed={peak0:.0f};"
                f"recovery_slots={rec};degradation_vs_shuffle={speedup:.2f}x"))
            BENCH_ROWS.append(bench_row(
                "disruption", _engine_name("cohort-fused"), sched, sys_.topo.n_instances, T,
                wall / len(sw), speedup=speedup, scenario=scen.name, W=W,
                resp_transient=round(float(tr.avg_response), 3),
                resp_degradation=round(deg, 3), peak_backlog=round(peak, 1),
                peak_backlog_undisturbed=round(peak0, 1), recovery_slots=rec,
                saturated_frac=round(float(tr.saturated_frac), 4)))
    return rows


def disruption_bench(device="cuda") -> list[Row]:
    """Bench rows through the failure transient."""
    return disruption_rows(transient_grid(device))


#: every stream of the fused engine, as ``benchmarks/disruption.py`` dumps them
OBS_STREAMS = ("backlog", "queue_depth", "price", "dispatch", "transit", "backlog_comp",
               "held", "window", "saturation", "payload")


def recovery_story(h, tol: float = 1.1) -> tuple[int, int]:
    """(peak-backlog slot, recovery slot) of a backlog series, as
    ``tools/obs_report.py --recovery`` derives them from a dump: the first
    slot after the peak within ``tol`` x the mean backlog before the peak;
    -1 when it never recovers."""
    h = [float(x) for x in h]
    peak = max(range(len(h)), key=h.__getitem__)
    pre = h[:peak] or [h[0]]
    baseline = sum(pre) / len(pre)
    recovery = next((t for t in range(peak + 1, len(h)) if h[t] <= tol * baseline), -1)
    return peak, recovery


def dump_obs(device="cuda", T: int = T_COHORT, obs_path: str | None = None,
             trace_path: str | None = None):
    """The metrics-on POTUS run through the failure transient at the grid's
    largest W, with every fused-engine stream and span tracing on, through
    ``run_sweep`` (the counterpart of ``benchmarks/disruption.py::_dump_obs``).
    Writes the ``repro-obs/v1`` dump and the Chrome trace. Returns (result,
    obs path, trace path, t0, dur, wall s)."""
    obs_path = obs_path or os.environ.get("REPRO_TORCH_OBS_DISRUPTION_JSON",
                                          "OBS_disruption_torch.json")
    trace_path = trace_path or os.environ.get("REPRO_TORCH_OBS_TRACE_JSON",
                                              "TRACE_disruption_torch.json")
    sys_, t0, dur, scen, arr, Ws, opts = _transient(T)
    W = max(Ws)
    spec = SweepSpec(V=1.0, window=(W,), scheduler=("potus",), events=("kfail",))
    tracer = enable_tracing()
    tracer.clear()
    try:
        sw, wall = _sweep(sys_, arr, T, spec, device, engine="cohort-fused",
                          events={"kfail": scen}, engine_opts=dict(opts, metrics=OBS_STREAMS))
    finally:
        disable_tracing()
    res = sw.result(scheduler="potus", window=W, events="kfail")
    res.metrics.save(obs_path)
    export_chrome_trace(trace_path)
    return res, obs_path, trace_path, t0, dur, wall


def obs_dump(device="cuda") -> list[Row]:
    """The ``obs`` section: :func:`dump_obs`, and one row with the recovery
    story the dump gives."""
    res, obs_path, trace_path, t0, dur, wall = dump_obs(device)
    T = res.metrics.n_slots
    peak, recovery = recovery_story(res.metrics.streams["backlog"][:, 0])
    print(f"# wrote {obs_path} and {trace_path}", file=sys.stderr)
    return [Row("disruption/obs/potus", wall / T * 1e6,
                f"streams={len(res.metrics.streams)};peak_backlog_slot={peak};"
                f"recovery_slot={recovery};recovery_slots={recovery_slots(res.backlog, t0, t0 + dur)}")]


SECTIONS = {
    "fig4": fig4_response_vs_w,
    "fig5": fig5_backlog_and_cost_vs_v,
    "fig6ab": fig6ab_predictors,
    "fig6c": fig6c_misprediction_extremes,
    "disruption": disruption_bench,
    "obs": obs_dump,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*", metavar="section",
                    help=f"sections to run, of {', '.join(SECTIONS)} (all when none is named)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help=f"also write the {BENCH_JSON_SCHEMA} rows to PATH")
    args = ap.parse_args(argv)
    unknown = [name for name in args.sections if name not in SECTIONS]
    if unknown:
        ap.error(f"unknown sections {unknown}; choose from {', '.join(SECTIONS)}")
    print("name,us_per_call,derived")
    for name in args.sections or list(SECTIONS):
        print(f"# --- {name} ---", file=sys.stderr)
        for row in SECTIONS[name](args.device):
            print(row.csv(), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema": BENCH_JSON_SCHEMA, "rows": BENCH_ROWS}, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.json} ({len(BENCH_ROWS)} rows)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
