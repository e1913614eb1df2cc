"""The host-loop oracles' and the MoE router's benchmarks on the PyTorch port.

The port's counterparts of ``benchmarks/systems_bench.py::cohort_scale``
(the fused cohort engine against the Python event loop on the serving fleet,
and its Fig. 6ab-shaped grid row), of its ``moe_router_bench`` and of the
slot-versus-event gap rows of ``benchmarks/workload.py``, run through
``repro_torch`` on the card (or on the CPU with ``--device cpu``). The
fleets, seeds and sizes are the reference's; the rows are the same
``name,us_per_call,derived`` CSV. Run from the repository root:

    PYTHONPATH=src python -m benchmarks.torch_systems [section ...] [--device cpu]
        [--json PATH]

Sections: cohort_scale, cohort_grid, eventgap, moe_router (all when none is
named).

* ``cohort_scale`` — I = 64, 1024 and 16384, T=128, ``shuffle`` and
  ``potus``: the event loop (``engine="cohort"``; its scheduler once a slot
  on the device, X copied back whole) and the fused engine
  (``engine="cohort-fused"``, warm, best of 2). Above I=1024 the loop runs a
  truncated horizon and is extrapolated linearly, as in the reference; the
  row says so (``python_T``, ``extrapolated``).
* ``cohort_grid`` — the V (1, 2, 5, 10) x (perfect, none) grid at I=64,
  ``run_sweep`` on ``cohort-fused`` against ``engine="cohort"``.
* ``eventgap`` — ``workload.py``'s compact dyadic system with Poisson, MMPP
  and Pareto traffic: the mean |backlog| gap between the scan engine and
  ``run_event_sim(integral=True, jitter=0.5, seed=7)``.
* ``moe_router`` — one MoE layer of ``granite_moe_1b.reduced()`` with 16
  experts, top-2, capacity factor 1.25, d_model 128, on 256 skewed tokens
  (192 near copies of one token, 64 random ones; numpy seed 0, the
  reference's draws), 10 steps with ``router="topk"`` and with
  ``router="potus"`` (the virtual queues threaded): the expert load's
  max/mean and the dropped fraction, averaged over steps 3-9. The weights
  come from a seeded ``torch.Generator`` (the reference draws them with
  ``jax.random``).

``REPRO_BENCH_SMOKE=1`` takes the smoke sizes. ``--json PATH`` also writes
``repro-bench/v2`` rows with the engine names ``torch-python``,
``torch-fused``, ``torch-eventsim`` and ``torch-moe``, so their
``tools/bench_diff.py`` keys never meet the reference's rows. The module
imports only ``repro_torch``, torch, numpy and the standard library (and
``benchmarks.torch_figures``, which imports the same).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from benchmarks.torch_figures import BENCH_JSON_SCHEMA, SMOKE, Row, bench_row
from repro_torch.configs import get_config
from repro_torch.core import (ArrivalSpec, Component, EngineSpec, SimConfig, SweepSpec,
                              build_topology, container_costs, diamond_app, fat_tree,
                              feasible_rates, linear_app, poisson_arrivals, run_event_sim,
                              run_sweep, simulate, spout_rate_matrix, t_heron_placement)
from repro_torch.core.prediction import all_true_negative
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.moe import MoE, init_router_state, moe_ffn

#: repro-bench/v2 rows of the sections run in this process
BENCH_ROWS: list[dict] = []

SCALE_SIZES = (64, 16384) if SMOKE else (64, 1024, 16384)
SCALE_T = 24 if SMOKE else 128
SCALE_AGE_CAP = 32
GAP_T = 200 if SMOKE else 1000


def cohort_fleet(I_target: int):
    """``systems_bench.py::_cohort_fleet``: 4 serving chains (src -> serve ->
    sink, C = 12) with ``n_instances == I_target``; returns the topology and
    the server distances of ``fat_tree(4)``."""
    chains, per = 4, I_target // 4
    src = sink = max(per // 8, 1)
    apps = [[Component("src", a, True, parallelism=src, successors=(1,)),
             Component("serve", a, False, parallelism=per - src - sink, proc_capacity=4.0,
                       successors=(2,)),
             Component("sink", a, False, parallelism=sink, proc_capacity=8.0)]
            for a in range(chains)]
    topo = build_topology(apps, gamma=32.0)
    server_dist, _ = fat_tree(4)
    return topo, server_dist


def python_horizon(I: int, T: int) -> int:
    """The event loop's horizon: the full T up to I=1024, else truncated (its
    per-slot cost is T-independent), as ``systems_bench.py`` sets it."""
    return T if I <= 1024 else (1 if SMOKE else max(T // 16, 8))


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def cohort_scale_rows(device="cuda", sizes=SCALE_SIZES, T: int = SCALE_T,
                      schedulers=("shuffle", "potus"), python_T=python_horizon,
                      observe=None) -> list[Row]:
    """The event loop against the fused engine at each fleet size, wall time
    per T-slot run (the loop's extrapolated from ``python_T(I, T)`` slots).
    ``observe(I, scheduler, T_py)``, if given, returns a context manager that
    the timed event-loop run executes in (a profiler, say)."""
    rows = []
    for I_target in sizes:
        topo, server_dist = cohort_fleet(I_target)
        I = topo.n_instances
        net = container_costs(f"cohort-fleet-{I}", server_dist, containers_per_server=8)
        rng = np.random.default_rng(0)
        placement = rng.integers(0, net.n_containers, I).astype(np.int32)
        arr = poisson_arrivals(rng, feasible_rates(topo, utilization=0.85), T + 8)
        T_py = python_T(I, T)
        for sched in schedulers:
            base = dict(topo=topo, net=net, placement=placement, arrivals=arr,
                        scheduler=sched, V=2.0, window=4, device=device)
            out = {}
            with observe(I, sched, T_py) if observe else contextlib.nullcontext():
                t_py = _timed(lambda: out.setdefault("py", simulate(EngineSpec(
                    T=T_py, engine="cohort", **base))))
            t_py_full = t_py * (T / T_py)
            fspec = EngineSpec(T=T, engine="cohort-fused", age_cap=SCALE_AGE_CAP, **base)
            t_first = _timed(lambda: simulate(fspec))

            def fused_once():
                out["fused"] = simulate(fspec)

            t_fused = min(_timed(fused_once) for _ in range(2))
            py, fused = out["py"], out["fused"]
            speedup = t_py_full / t_fused
            if T_py == T:
                db = abs(py.avg_backlog - fused.avg_backlog) / max(py.avg_backlog, 1e-9)
                agree = f"backlog_agree={1 - db:.4f}"
            else:
                agree = f"python_T={T_py};extrapolated=True"
            for engine, dt in (("python", t_py_full), ("fused", t_fused)):
                rows.append(Row(f"cohort_scale/{engine}/{sched}/I{I}", dt / T * 1e6,
                                f"instances={I};T={T};wall_s={dt:.3f}"))
                BENCH_ROWS.append(bench_row(
                    "cohort_scale", f"torch-{engine}", sched, I, T, dt,
                    speedup=speedup if engine == "fused" else 1.0, python_T=T_py,
                    extrapolated=T_py != T))
            rows.append(Row(f"cohort_scale/speedup/{sched}/I{I}", t_fused / T * 1e6,
                            f"python_s={t_py_full:.3f};fused_s={t_fused:.3f};"
                            f"first_s={t_first:.2f};speedup={speedup:.1f}x;{agree}"))
    return rows


def cohort_grid_rows(device="cuda") -> list[Row]:
    """``systems_bench.py::_cohort_grid_row``: the Fig. 6ab-shaped response
    grid at I=64, one fused sweep against the event loop's sweep."""
    topo, server_dist = cohort_fleet(64)
    I = topo.n_instances
    net = container_costs("cohort-grid", server_dist, containers_per_server=8)
    rng = np.random.default_rng(1)
    placement = rng.integers(0, net.n_containers, I).astype(np.int32)
    T = 24 if SMOKE else 48
    arr = poisson_arrivals(rng, feasible_rates(topo, utilization=0.7), T + 8)
    amap = {"perfect": arr, "none": (arr, all_true_negative(arr))}
    spec = SweepSpec(V=(1.0, 2.0, 5.0, 10.0), window=1, arrival=("perfect", "none"))

    def sweep(engine, **opts):
        return run_sweep(topo, net, placement, amap, T, spec, engine=engine, engine_opts=opts,
                         device=device)

    sweep("cohort-fused", age_cap=32)  # warm
    t_fused = _timed(lambda: sweep("cohort-fused", age_cap=32))
    t_py = _timed(lambda: sweep("cohort"))
    n = spec.n_scenarios
    BENCH_ROWS.append(bench_row("cohort_grid", "torch-fused", "potus", I, T, t_fused,
                                speedup=t_py / t_fused))
    BENCH_ROWS.append(bench_row("cohort_grid", "torch-python", "potus", I, T, t_py))
    return [Row("cohort_scale/grid", t_fused / (n * T) * 1e6,
                f"scenarios={n};batches=1;fused_s={t_fused:.3f};python_s={t_py:.3f};"
                f"speedup={t_py / t_fused:.1f}x")]


def compact_system():
    """``workload.py::_compact_system``: a 3-stage chain and a diamond,
    parallelism 2, mu 8, gamma 64 — every quantity dyadic."""
    topo = build_topology([linear_app(3, parallelism=2, mu=8.0),
                           diamond_app(parallelism=2, mu=8.0)], gamma=64.0)
    server_dist, _ = fat_tree(4)
    net = container_costs("fat-tree", server_dist)
    placement = t_heron_placement(topo, net, spout_rate_matrix(topo, 2.0), max_per_container=8)
    return topo, net, placement


GAP_TRAFFIC = (("poisson", {}), ("mmpp", {"rate_ratio": 10.0}), ("pareto", {"alpha": 1.3}))


def eventgap_rows(device="cuda", T: int = GAP_T) -> list[Row]:
    """The slot-versus-event gap per traffic shape: tuple service and landing
    jitter (``integral=True, jitter=0.5, seed=7``) against the scan engine,
    Shuffle at W=2, integer arrivals."""
    topo, net, placement = compact_system()
    cfg = SimConfig(window=2, scheduler="shuffle")
    rows = []
    for kind, params in GAP_TRAFFIC:
        spec = ArrivalSpec(kind=kind, seed=5, rate_per_stream=2.0, params=params)
        arr = np.round(spec.generate(topo, T + cfg.window + 1))
        ref = simulate(EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=T,
                                  engine="jax", scheduler=cfg.scheduler, window=cfg.window,
                                  device=device))
        out = {}
        t_ev = _timed(lambda: out.setdefault("ev", run_event_sim(
            topo, net, placement, arr, T, cfg, integral=True, jitter=0.5, seed=7,
            device=device)))
        ev = out["ev"]
        gap = float(np.abs(np.asarray(ref.backlog, np.float64) - ev.backlog).mean())
        rows.append(Row(f"workload/eventgap/{kind}", t_ev / T * 1e6,
                        f"T={T};mean_abs_backlog_gap={gap:.3f};events={ev.n_events}"))
        BENCH_ROWS.append(bench_row("workload_eventgap", "torch-eventsim", cfg.scheduler,
                                    topo.n_instances, T, t_ev, scenario=kind,
                                    backlog_gap=round(gap, 4), n_events=ev.n_events))
    return rows


MOE_STEPS = 10


def moe_router_inputs(device="cuda", seed: int = 0):
    """``systems_bench.py::moe_router_bench``'s layer and tokens: (cfg, an
    :class:`MoE` drawn from ``torch.Generator`` seed ``seed``, x (1, 256, D)
    float32 from numpy seed 0)."""
    device = resolve_device(device)
    cfg = get_config("granite_moe_1b").reduced().with_(
        n_experts=16, top_k=2, capacity_factor=1.25, d_model=128)
    with torch.device("meta"):
        moe = MoE(cfg, dtype=torch.float32)
    moe = model_zoo.fill_(moe.to_empty(device=device).requires_grad_(False),
                          torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(0)
    # skewed tokens -> hot experts
    base = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    x = np.concatenate([
        np.repeat(base, 192, axis=1) + 0.05 * rng.standard_normal((1, 192, cfg.d_model)),
        rng.standard_normal((1, 64, cfg.d_model)).astype(np.float32),
    ], axis=1).astype(np.float32)
    return cfg, moe, torch.as_tensor(x, device=device)


@torch.no_grad()
def moe_router_rows(device="cuda", inputs=None) -> list[Row]:
    """The POTUS router against plain top-k on the skewed tokens: per router,
    ``MOE_STEPS`` calls of ``moe_ffn`` (POTUS threading its state), the
    load's max/mean and the dropped fraction averaged over steps 3 on, and
    the wall us per call. ``inputs`` replaces :func:`moe_router_inputs`."""
    cfg, moe, x = inputs if inputs is not None else moe_router_inputs(device)
    rows = []
    for router in ("topk", "potus"):
        c = cfg.with_(router=router)
        rs = init_router_state(c, x.device)
        imb, drop = [], []
        t0 = time.perf_counter()
        for _ in range(MOE_STEPS):
            _, aux = moe_ffn(moe, x, c, rs)
            if router == "potus":
                rs = aux["router_state"]
            load = aux["load"].cpu().numpy()
            imb.append(load.max() / max(load.mean(), 1e-9))
            drop.append(float(aux["dropped_frac"]))
        dt = time.perf_counter() - t0
        rows.append(Row(f"moe_router/{router}", dt / MOE_STEPS * 1e6,
                        f"max_over_mean_load={np.mean(imb[3:]):.2f};"
                        f"dropped={np.mean(drop[3:]):.3f}"))
        BENCH_ROWS.append(bench_row("moe_router", "torch-moe", router, x.shape[1], MOE_STEPS,
                                    dt, scenario="skewed", n_experts=cfg.n_experts,
                                    max_over_mean_load=round(float(np.mean(imb[3:])), 4),
                                    dropped=round(float(np.mean(drop[3:])), 4)))
    return rows


SECTIONS = {
    "cohort_scale": cohort_scale_rows,
    "cohort_grid": cohort_grid_rows,
    "eventgap": eventgap_rows,
    "moe_router": moe_router_rows,
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
