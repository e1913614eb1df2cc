#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), holds every kernel against
its plain PyTorch version on the card, and drives the port's two ported
paths on the I=16384 serving fleet, counting the kernel launches of each:

* main path 1 — ``simulate(EngineSpec(engine="cohort-fused",
  scheduler="potus", device="cuda"))``: the slot kernel (``potus_slot``);
* main path 2 — ``simulate(EngineSpec(engine="jax", scheduler="potus",
  device="cuda"))``, the plain scan engine (the Fig. 5 path): the fused
  schedule kernel (``potus_schedule``); and its ``scheduler="potus-loop"``
  route, on an I=1024 fleet: the price kernel (``potus_price``).

It checks the results and prints:

* the card's name and power limit, the torch/CUDA versions and build
  seconds;
* per check, the largest difference kernel vs plain version;
* per kernel, one call's kernel, plain and bound ms at the main path's
  shapes (and, for the slot kernel, each phase's device time);
* per main path, its wall ms per slot, its metrics, the device busy share,
  the top device items and (path 2) the peak device memory;
* each comparison of the kernel route with the plain route;
* one JSON line ``{"kernels": [...]}``, then, last,
  ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full f32: TF32 is switched off for cuBLAS
and cuDNN before anything runs. Any failed check raises, so the exit code
is not 0 and the last line is not printed. Without a CUDA device it exits
with code 2 and prints no result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the I=16384 serving fleet of benchmarks/systems_bench.py:137 (_cohort_fleet)
FLEET_I, FLEET_T, FLEET_W, FLEET_V, FLEET_AGE_CAP = 16384, 128, 4, 2.0, 64
# the potus-loop route runs max_succ argmin passes per slot (3072 at I=16384,
# seconds per slot), so its fleet is cut to I=1024 until the loop gets a kernel
LOOP_I = 1024
KERNELS = ("potus_slot", "potus_schedule", "potus_price")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


# ---------------------------------------------------------------------------
# systems, rebuilt with the port's own modules
# ---------------------------------------------------------------------------

def dyadic_system(pt, T, W):
    """The dyadic-arithmetic system of tests/test_potus_slot.py:44."""
    C = pt.Component
    apps = [
        [C("src", 0, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
         C("left", 0, False, 2, 4.0, successors=(3,)),
         C("right", 0, False, 4, 4.0, successors=(3,)),
         C("sink", 0, False, 2, 8.0)],
        [C("src", 1, True, 2, successors=(1,)),
         C("mid", 1, False, 4, 4.0, successors=(2,)),
         C("sink", 1, False, 2, 4.0)],
    ]
    topo = pt.build_topology(apps, gamma=64.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs("fat-tree", sd)
    placement = pt.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                     max_per_container=4)
    rng = np.random.default_rng(3)
    unit = pt.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + W + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + W + 1, *unit.shape)) < 0.8
    return topo, net, placement, (arr * (unit > 0)).astype(np.float32)


def fleet_system(pt, I_target, T):
    """4 serving chains src -> serve -> sink (C=12, gamma=32) on fat_tree(4)
    with 8 containers per server; Poisson arrivals at utilization 0.85."""
    chains, per = 4, I_target // 4
    src = sink = max(per // 8, 1)
    C = pt.Component
    apps = [[C("src", a, True, parallelism=src, successors=(1,)),
             C("serve", a, False, parallelism=per - src - sink, proc_capacity=4.0,
               successors=(2,)),
             C("sink", a, False, parallelism=sink, proc_capacity=8.0)] for a in range(chains)]
    topo = pt.build_topology(apps, gamma=32.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs(f"cohort-fleet-{topo.n_instances}", sd, containers_per_server=8)
    rng = np.random.default_rng(0)
    placement = rng.integers(0, net.n_containers, topo.n_instances).astype(np.int32)
    rates = pt.feasible_rates(topo, utilization=0.85)
    return topo, net, placement, pt.poisson_arrivals(rng, rates, T + 8)


def paper_system(pt, T):
    """The paper's §5.1 profile of benchmarks/common.py:99 (fat-tree, seed 0)
    with Poisson arrivals of seed 7."""
    rng = np.random.default_rng(0)
    topo = pt.build_topology(pt.random_apps(rng, n_apps=5), gamma=24.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs("fat-tree", sd)
    rates = pt.feasible_rates(topo, utilization=0.7)
    placement = pt.t_heron_placement(topo, net, rates, max_per_container=8)
    arr = pt.poisson_arrivals(np.random.default_rng(7), rates, T + 64)
    return topo, net, placement, arr


def step_inputs(cf, topo, net, placement, arr, T, W, V, beta, age_cap, device):
    """StepConsts, initial state and (T, I, C) streams on ``device``."""
    import torch

    from repro_torch.core.compact import kernel_layout

    f32 = dict(dtype=torch.float32, device=device)
    prob = cf._compact_prob(topo, placement, device)
    cpt = cf._compact(topo)
    act, pred, nxt, q0 = cf._prep_streams(arr, None, T, W, cpt, cf._stream_mask(topo))
    dev = cf._device_inputs(topo, net, cpt, device)
    C = topo.n_components
    layout = tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                   for x in kernel_layout(topo.inst_comp, placement, C, net.U.shape[0]))
    onehot = torch.nn.functional.one_hot(prob.inst_comp.long(), C).to(torch.float32)
    consts = cf._step_consts(prob, onehot, dev["U"], dev["mu"], dev["inv_service"],
                             dev["sel_cmp"], dev["stream_cmp"], dev["valid_cmp"],
                             dev["succ_map"], dev["term_f"], dev["adj_rows"],
                             torch.tensor(V, **f32), torch.tensor(beta, **f32), layout)
    I, Sc, W1 = q0.shape
    A = age_cap + W1
    state = (torch.as_tensor(q0, **f32), torch.zeros((I, Sc), **f32),
             torch.zeros((I, A), **f32), torch.zeros((I, Sc, A), **f32),
             torch.zeros((I, A), **f32), torch.zeros((C, T + A), **f32),
             torch.zeros((C, T + A), **f32))
    streams = tuple(torch.as_tensor(np.ascontiguousarray(x), **f32) for x in (act, pred, nxt))
    return consts, state, streams


def run_slots(step, consts, state, streams, K, scheduler, age_cap, T=None):
    """T slots through ``step`` in launches of K; returns (state, (4, T) metrics)."""
    import torch

    act, pred, nxt = streams
    T = act.shape[0] if T is None else T
    mets = []
    for t0 in range(0, T, K):
        n = min(K, T - t0)
        state, m = step(consts, state, act[t0:t0 + n], pred[t0:t0 + n], nxt[t0:t0 + n], t0,
                        scheduler=scheduler, age_cap=age_cap, n_slots=n)
        mets.append(torch.stack(m))
    return state, torch.cat(mets, dim=1)


def max_abs(a_state, a_met, b_state, b_met) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(tuple(a_state) + (a_met,), tuple(b_state) + (b_met,)))


def bytes_and_ops(consts, state, n_slots):
    """What one call must move (each input read once, each output written
    once) and the arithmetic it does, counted from the shapes."""
    q_rem, admit, q_in, q_out, transit, rmass, rtime = state
    I, S, W1 = q_rem.shape
    A = q_in.shape[-1]
    C = consts.adj_rows.shape[1]
    NK = consts.U.shape[0]
    state_floats = sum(x.numel() for x in state)
    const_floats = (sum(x.numel() for x in consts[:17]) - consts.comp_onehot.numel()
                    + sum(x.numel() for x in consts[17:]))
    floats = 2 * state_floats + const_floats + 3 * n_slots * I * C + 4 * n_slots
    ops = n_slots * (3 * NK * I + I * (2 * C * C + 10 * S * (A + 1) + 12 * A + 20 * C))
    return 4 * floats, ops


def time_calls(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_times(prof):
    """(name, count, device ms) per device-side event name, longest first."""
    import torch

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, evt.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


# ---------------------------------------------------------------------------
# the plain scan engine (engine="jax") and its two kernels
# ---------------------------------------------------------------------------

def sched_args(prob, U, state, pq):
    """The kernels' inputs at one slot: (U, q_in, q_out, kc, comp, mask)."""
    return (U, state.q_in, pq.effective_qout(prob, state), prob.inst_container,
            prob.inst_comp, prob.edge_mask)


def kernel_bound(args, gamma=None):
    """Bytes (each input read once, X or l written once) and operations
    (five per DAG edge of this state, plus the water-fill per row) of one
    call of the schedule (``gamma`` given) or the price kernel."""
    U, q_in, q_out, kc, comp, mask = args
    I, C = q_out.shape
    nbytes = sum(x.numel() * x.element_size() for x in args) + 4 * I * I
    nops = 5 * int(mask.sum())
    if gamma is not None:
        nbytes += gamma.numel() * 4
        nops += I * C * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, nops


def max_err(a, b) -> float:
    """Largest |a - b| over the entries finite in both; +inf must sit in the
    same places (checked by the caller)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin].double() - b[fin].double()).abs().max()) if bool(fin.any()) else 0.0


def prices_close(lk, lp) -> bool:
    """+inf in the same places, finite entries within rtol/atol 1e-5."""
    import torch

    fin = torch.isfinite(lp)
    return (torch.equal(torch.isinf(lk), torch.isinf(lp))
            and torch.allclose(lk[fin], lp[fin], rtol=1e-5, atol=1e-5))


def check_price_and_schedule(kp, ks, args, gamma, V, beta, label, exact):
    """Kernel 3 and kernel 2 against their plain versions on one input;
    returns the two max_abs_err."""
    import torch

    lk, lp = kp.potus_price_call(*args, V, beta), kp.potus_price_plain(*args, V, beta)
    xk = ks.potus_schedule_call(*args, gamma, V, beta)
    xp = ks.potus_schedule_alloc_plain(*args, gamma, V, beta)
    torch.cuda.synchronize()
    check(torch.equal(torch.isinf(lk), torch.isinf(lp)), f"{label}: price +inf places differ")
    e_l, e_x = max_err(lk, lp), max_err(xk, xp)
    if exact:
        check(torch.equal(lk, lp), f"{label}: price kernel differs from the plain version")
        check(torch.equal(xk, xp), f"{label}: schedule kernel differs from the plain version")
    else:
        check(prices_close(lk, lp), f"{label}: price kernel beyond rtol/atol 1e-5")
        check(torch.allclose(xk, xp, rtol=1e-5, atol=1e-5),
              f"{label}: schedule kernel beyond rtol/atol 1e-5")
    return e_l, e_x


def random_problem(seed, I, K, C, cuda):
    """``tests/test_kernels.py:176-181`` inputs, from numpy: integer grids."""
    import torch

    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    mask = (rng.random((I, I)) < 0.25) & (comp[:, None] != comp[None, :])
    U = rng.integers(0, 5, (K, K)).astype(np.float32)
    q_in = rng.integers(0, 8, I).astype(np.float32)
    q_out = rng.integers(0, 8, (I, C)).astype(np.float32)
    gamma = rng.integers(1, 12, I).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    return (t(U), t(q_in), t(q_out), t(kc), t(comp), t(mask)), t(gamma)


def price_problem(seed, I, K, C, cuda):
    """``tests/test_kernels.py:127-131`` inputs, from numpy: uniform floats."""
    import torch

    rng = np.random.default_rng(seed)
    U = rng.uniform(0, 6, (K, K)).astype(np.float32)
    q_in = rng.uniform(0, 20, I).astype(np.float32)
    q_out = rng.uniform(0, 20, (I, C)).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    comp = rng.integers(0, C, I).astype(np.int32)
    mask = rng.random((I, I)) < 0.2
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    return (t(U), t(q_in), t(q_out), t(kc), t(comp), t(mask)), None


def dyadic_scan_checks(pt, kp, ks, cuda):
    """Kernels 2 and 3 against their plain versions on every slot's state of
    a reference-length run of the dyadic system: bitwise."""
    import torch

    from repro_torch.core import potus as pp
    from repro_torch.core import queues as pq
    from repro_torch.core import simulator as psim
    from repro_torch.kernels import ops as kops

    T, W, V, beta = 120, 2, 2.0, 0.5
    topo, net, placement, arr = dyadic_system(pt, T, W)
    prob = pp.make_problem(topo, net, placement, cuda)
    state = pq.init_state(topo, W, arr[:W + 1], cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    U = torch.as_tensor(net.U, **f32)
    kc = prob.inst_container.long()
    u_pair = U[kc[:, None], kc[None, :]]
    mu = torch.as_tensor(topo.inst_mu, **f32)
    sel = torch.as_tensor(topo.selectivity[topo.inst_comp], **f32)
    sched = partial(pp._schedule_with, kops.plain)  # the run itself takes the plain route
    shipped = 0
    for t in range(T):
        args = sched_args(prob, U, state, pq)
        check_price_and_schedule(kp, ks, args, prob.gamma, V, beta, f"dyadic t={t}", True)
        shipped += int((ks.potus_schedule_alloc_plain(*args, prob.gamma, V, beta) > 0).sum())
        state, _ = psim.sim_step(prob, sched, U, u_pair, mu, sel, V, beta, state,
                                 torch.as_tensor(arr[t + W + 1], **f32))
    check(shipped > 0, "dyadic: the greedy shipped nothing; the check would be vacuous")
    print(f"dyadic scan engine T={T}: price and schedule kernels vs plain bitwise on every "
          f"slot (max_abs_err 0.0; {shipped} greedy allocations)")


def one_call(kp, ks, pq, convert, prob, U, mid_state, cuda, card):
    """Kernels 2 and 3 once at I=16384 from a mid-run state: bitwise equal to
    their plain versions (+inf in the same places), ms per call (CUDA events,
    warmed up), plain ms, bound."""
    import torch

    state = convert.sim_state_from_numpy(mid_state, device=cuda)
    args = sched_args(prob, U, state, pq)
    out = {}
    for name, call, plain, gamma in (
            ("potus_schedule", ks.potus_schedule_call, ks.potus_schedule_alloc_plain,
             prob.gamma),
            ("potus_price", kp.potus_price_call, kp.potus_price_plain, None)):
        extra = () if gamma is None else (gamma,)
        k = call(*args, *extra, FLEET_V, 1.0)
        p = plain(*args, *extra, FLEET_V, 1.0)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(k), torch.isinf(p)),
              f"one {name} call at I={FLEET_I}: +inf places differ from the plain version")
        err = max_err(k, p)
        check(torch.equal(k, p), f"one {name} call at I={FLEET_I}: kernel differs from the "
              f"plain version (max_abs_err {err:.3e}); both repeat one operation order")
        del k, p
        ms = time_calls(lambda: call(*args, *extra, FLEET_V, 1.0), 20)
        plain_ms = time_calls(lambda: plain(*args, *extra, FLEET_V, 1.0), 3)
        bound_ms, bound_by, nbytes, nops = kernel_bound(args, gamma)
        print(f"one {name} call at I={FLEET_I} (mid-run state, t=64): max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes} bytes, {nops} ops) [{card}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def profile_run(fn, top=8):
    """Device busy share and the top device items of one profiled run."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_times(prof)
    busy_ms = sum(r[2] for r in rows)
    if busy_ms > 0:
        print(f"  device busy {busy_ms:.3f} ms of {prof_ms:.3f} ms wall: "
              f"share {busy_ms / prof_ms:.4f} (profiled run)")
        for name, count, ms in rows[:top]:
            print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    else:
        print("  device busy share: not measured (the profiler saw no device time)")


def timed_runs(fn, T, n):
    """Wall ms per slot of ``n`` synchronised runs."""
    import torch

    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / T)
    return np.array(walls)


SERIES = ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total")


def compare_scan_routes(label, psim, plain_ops, sys_, T, cfg, cuda, events=None,
                        kernel=None):
    """The kernel route (``kernel``: a result already run, else run here)
    against the plain route of ``_run_sim_impl``: per-slot backlog and cost
    within rtol 1e-4 over the first 16 slots, long-run means within 2%."""
    import torch

    topo, net, placement, arr = sys_
    t_a = time.perf_counter()
    a = kernel if kernel is not None else psim._run_sim_impl(topo, net, placement, arr, T,
                                                             cfg, events=events, device=cuda)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    b = psim._run_sim_impl(topo, net, placement, arr, T, cfg, events=events, device=cuda,
                           ops=plain_ops)
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]), rel_diff(a.comm_cost[:16],
                                                                  b.comm_cost[:16]))
    means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
    for name in SERIES:
        check(np.isfinite(getattr(a, name)).all() and getattr(a, name).shape == (T,),
              f"{label}: {name} not finite or of the wrong shape")
    kernel_ms = "ran above" if kernel is not None else f"{(t_b - t_a) * 1e3 / T:.3f} ms/slot"
    print(f"{label} {cfg.scheduler} T={T}: kernel route {kernel_ms}, plain route "
          f"{(t_c - t_b) * 1e3 / T:.3f} ms/slot; first 16 slots rel diff {r16:.3e}, means "
          f"{means:.3e}; avg_backlog {a.avg_backlog!r}/{b.avg_backlog!r} "
          f"avg_cost {a.avg_cost!r}/{b.avg_cost!r}")
    check(r16 <= 1e-4 and means <= 0.02, f"{label} {cfg.scheduler}: kernel route vs plain")


def scan_engine(pt, card, cuda):
    """Everything of the plain scan engine: checks, one call of each kernel,
    main path 2 and its loop route, the route comparisons. Returns the two
    kernels' entries of the kernels line."""
    import torch

    from repro_torch import convert
    from repro_torch.core import potus as pp
    from repro_torch.core import queues as pq
    from repro_torch.core import simulator as psim
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks
    from repro_torch.kernels import potus_slot as ps

    # -- kernels 2 and 3 against their plain versions ----------------------------
    dyadic_scan_checks(pt, kp, ks, cuda)
    for shape in ((60, 8, 6), (128, 16, 10), (96, 4, 3), (250, 32, 24)):
        args, gamma = random_problem(0, *shape, cuda)
        e_l, e_x = check_price_and_schedule(kp, ks, args, gamma, 2.0, 1.0, f"random {shape}",
                                            False)
        print(f"random (I, K, C)={shape}: schedule max_abs_err={e_x:.3e}, price {e_l:.3e} "
              "(rtol/atol 1e-5)")
    for shape in ((60, 8, 12), (128, 32, 16), (256, 16, 24)):
        args, _ = price_problem(0, *shape, cuda)
        lk, lp = kp.potus_price_call(*args, 3.0, 1.0), kp.potus_price_plain(*args, 3.0, 1.0)
        check(prices_close(lk, lp), f"price {shape}: beyond rtol/atol 1e-5 or +inf elsewhere")
        err = max_err(lk, lp)
        print(f"random price (I, K, C)={shape}: max_abs_err={err:.3e} bitwise="
              f"{torch.equal(lk, lp)}")

    # -- one call of each at I=16384, from a mid-run state -----------------------
    sys_ = fleet_system(pt, FLEET_I, FLEET_T)
    topo, net, placement, arr = sys_
    cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus")
    mid = psim._run_sim_impl(topo, net, placement, arr, 64, cfg, device=cuda)
    prob = pp.make_problem(topo, net, placement, cuda)
    U = torch.as_tensor(net.U, dtype=torch.float32, device=cuda)
    calls = one_call(kp, ks, pq, convert, prob, U, mid.final_state, cuda, card)
    del prob, mid
    torch.cuda.empty_cache()

    # -- main path 2: engine="jax", potus, I=16384 -------------------------------
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                         engine="jax", scheduler="potus", V=FLEET_V, window=FLEET_W,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for counter in (ps.launches, ks.launches, kp.launches):
        counter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n_sched, n_price, n_slot = ks.launches.n, kp.launches.n, ps.launches.n
    peak = torch.cuda.max_memory_allocated()
    print(f"main path 2: engine=jax potus I={FLEET_I} T={FLEET_T} launches: potus_schedule="
          f"{n_sched} potus_price={n_price} potus_slot={n_slot}; peak device memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB, of which {held} bytes were held before "
          "the run)")
    check(n_sched == FLEET_T, f"schedule kernel launches {n_sched} != T={FLEET_T}")
    check(n_price == 0 and n_slot == 0, "main path 2 launched the price or the slot kernel")
    res2 = pt.simulate(spec)
    same = all(np.array_equal(getattr(res1, f), getattr(res2, f)) for f in SERIES) and all(
        np.array_equal(getattr(res1.final_state, f), getattr(res2.final_state, f))
        for f in ("q_in", "q_rem", "q_out_bolt", "transit"))
    print(f"  two runs bitwise identical: {same}")
    check(same, "main path 2: two runs differ")
    for name in SERIES:
        check(np.isfinite(getattr(res1, name)).all()
              and getattr(res1, name).shape == (FLEET_T,),
              f"main path 2: {name} not finite or of the wrong shape")
    check(float(res1.served_total.sum()) > 0, "main path 2: nothing was served")
    per_slot = timed_runs(lambda: pt.simulate(spec), FLEET_T, 4)
    print(f"  wall ms/slot over {len(per_slot)} timed runs: median {np.median(per_slot):.4f}, "
          f"min {per_slot.min():.4f}, max {per_slot.max():.4f} (first run {first_ms:.4f}) "
          f"[{card}]")
    setup = timed_runs(lambda: pt.simulate(dataclasses.replace(spec, T=0)), 1, 2)
    print(f"  set-up alone (a T=0 run: arrivals, problem, state and u_pair on the card): "
          f"{setup[0]:.3f} and {setup[1]:.3f} ms [{card}]")
    print(f"  avg_backlog={res1.avg_backlog!r} avg_cost={res1.avg_cost!r} "
          f"served_total_mean={float(res1.served_total.mean())!r} [{card}]")
    profile_run(lambda: pt.simulate(spec))

    # -- kernel route against plain route ----------------------------------------
    compare_scan_routes("fleet", psim, kops.plain, sys_, FLEET_T, cfg, cuda, kernel=res1)
    del res1, res2
    torch.cuda.empty_cache()

    # the potus-loop route (kernel 3), through the facade, counted
    loop_sys = fleet_system(pt, LOOP_I, FLEET_T)
    loop_spec = pt.EngineSpec(topo=loop_sys[0], net=loop_sys[1], placement=loop_sys[2],
                              arrivals=loop_sys[3], T=FLEET_T, engine="jax",
                              scheduler="potus-loop", V=FLEET_V, window=FLEET_W, device="cuda")
    for counter in (ps.launches, ks.launches, kp.launches):
        counter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop_res = pt.simulate(loop_spec)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n_loop_price, n_loop_sched = kp.launches.n, ks.launches.n
    print(f"potus-loop route: engine=jax I={LOOP_I} T={FLEET_T} launches: potus_price="
          f"{n_loop_price} potus_schedule={n_loop_sched}; {loop_ms:.3f} ms/slot [{card}]")
    check(n_loop_price == FLEET_T, f"price kernel launches {n_loop_price} != T={FLEET_T}")
    check(n_loop_sched == 0, "the potus-loop route launched the schedule kernel")
    loop_cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus-loop")
    compare_scan_routes(f"fleet I={LOOP_I}", psim, kops.plain, loop_sys, FLEET_T, loop_cfg,
                        cuda, kernel=loop_res)
    compare_scan_routes("paper", psim, kops.plain, paper_system(pt, 300), 300,
                        pt.SimConfig(V=2.0, window=2, scheduler="potus-loop"), cuda)
    # 16 instances (a src and three serve per chain) restart 3 slots apart, 8 slots each:
    # restarts run from slot 8 to slot 61 of 64
    restart = [int(i) for c in range(topo.n_components) if c % 3 < 2
               for i in topo.instances_of(c)[:1 if c % 3 == 0 else 3]]
    events = pt.rolling_restart(topo, start=8, down_slots=8, stagger=3,
                                instances=restart).compile(topo, 64)
    check(len(restart) == 16 and (events.alive_t == 0).any(axis=1)[8:61].all(),
          "rolling restart: the restarts do not fall inside the run")
    compare_scan_routes("fleet rolling-restart", psim, kops.plain, sys_, 64, cfg, cuda,
                        events=events)

    entry = dict(route="cuda")
    return [
        {"name": "potus_schedule", **entry,
         "source": "src/repro_torch/kernels/csrc/potus_schedule.cu",
         "replaces": "src/repro/kernels/potus_schedule.py:35", "launches": n_sched,
         **calls["potus_schedule"], "library_ms": None},
        {"name": "potus_price", **entry, "source": "src/repro_torch/kernels/csrc/potus_price.cu",
         "replaces": "src/repro/kernels/potus_price.py:26", "launches": n_loop_price,
         **calls["potus_price"], "library_ms": None},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import _build
    from repro_torch.kernels import potus_slot as ps

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all started together
        list(pool.map(_build.build, KERNELS))
    print("kernel build: " + ", ".join(f"{k} {_build.BUILD_SECONDS[k]:.2f} s" for k in KERNELS)
          + f" (wall {time.perf_counter() - t0:.2f} s, in parallel)")

    # -- 2. kernel against plain version on the card -------------------------
    T_d, W_d, AC_d = 40, 2, 16
    topo, net, placement, arr = dyadic_system(pt, T_d, W_d)
    for sched in ("potus", "shuffle", "jsq"):
        consts, state, streams = step_inputs(cf, topo, net, placement, arr, T_d, W_d, 2.0, 0.5,
                                             AC_d, cuda)
        sp, mp = run_slots(ps.potus_slot_step_plain, consts, state, streams, 1, sched, AC_d)
        for K in (1, 8):
            sk, mk = run_slots(ps.potus_slot_call, consts, state, streams, K, sched, AC_d)
            torch.cuda.synchronize()
            err = max_abs(sk, mk, sp, mp)
            same = all(torch.equal(x, y) for x, y in zip(sk, sp)) and torch.equal(mk, mp)
            print(f"dyadic {sched} K={K}: kernel vs plain max_abs_err={err} bitwise={same}")
            check(same, f"dyadic {sched} K={K}: kernel differs from the plain version")

    topo, net, placement, arr = fleet_system(pt, FLEET_I, FLEET_T)
    check(topo.n_instances == FLEET_I, "fleet size")
    consts, state0, streams = step_inputs(cf, topo, net, placement, arr, FLEET_T, FLEET_W,
                                          FLEET_V, 1.0, FLEET_AGE_CAP, cuda)
    sp, mp = run_slots(ps.potus_slot_step_plain, consts, state0, streams, 1, "potus",
                       FLEET_AGE_CAP)
    mp = mp.cpu().numpy()
    for K in (1, 8):
        sk, mk = run_slots(ps.potus_slot_call, consts, state0, streams, K, "potus",
                           FLEET_AGE_CAP)
        sk2, mk2 = run_slots(ps.potus_slot_call, consts, state0, streams, K, "potus",
                             FLEET_AGE_CAP)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(sk, sk2)) and torch.equal(mk, mk2)
        mk = mk.cpu().numpy()
        r16 = max(rel_diff(mk[q, :16], mp[q, :16]) for q in (0, 1))
        means = [rel_diff(mk[q].mean(), mp[q].mean()) for q in (0, 1)]
        print(f"fleet potus K={K} T={FLEET_T}: backlog/cost rel diff first 16 slots {r16:.3e}, "
              f"means {means[0]:.3e}/{means[1]:.3e}, repeat bitwise={repeat}")
        check(r16 <= 1e-4, "fleet: per-slot backlog/cost beyond rtol 1e-4 in the first 16 slots")
        check(max(means) <= 0.02, "fleet: long-run means differ by more than 2%")
        check(repeat, "fleet: two kernel runs differ")

    # one call at the main path's shapes, from a mid-run state
    mid, _ = run_slots(ps.potus_slot_call, consts, state0, streams, 8, "potus", FLEET_AGE_CAP,
                       T=64)
    one = tuple(x[64:65] for x in streams)
    args = (consts, mid, *one, 64)
    kw = dict(scheduler="potus", age_cap=FLEET_AGE_CAP, n_slots=1)
    s_k, m_k = ps.potus_slot_call(*args, **kw)
    s_p, m_p = ps.potus_slot_step_plain(*args, **kw)
    one_err = max_abs(s_k, torch.stack(m_k), s_p, torch.stack(m_p))
    ms_kernel = time_calls(lambda: ps.potus_slot_call(*args, **kw), 50)
    ms_plain = time_calls(lambda: ps.potus_slot_step_plain(*args, **kw), 10)
    nbytes, nops = bytes_and_ops(consts, mid, 1)
    bound_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S else "operations"
    print(f"one call at I={FLEET_I}: max_abs_err={one_err:.3e} kernel {ms_kernel:.4f} ms, "
          f"plain {ms_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
          f"{nops} ops) [{card}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            ps.potus_slot_call(*args, **kw)
        torch.cuda.synchronize()
    phases = [r for r in device_times(prof) if r[0].startswith("potus_p")]
    for name, count, ms in sorted(phases):
        print(f"  phase {name.split('(')[0]}: {ms / max(count, 1):.4f} ms per launch")
    if not phases:
        print("  phase times: not measured (the profiler saw no device time)")

    # -- 3. the main path ----------------------------------------------------
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                         scheduler="potus", V=FLEET_V, window=FLEET_W,
                         age_cap=FLEET_AGE_CAP, device="cuda")
    ps.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    main_launches = ps.launches.n
    print(f"main path: potus I={FLEET_I} T={FLEET_T} launches={main_launches}")
    check(main_launches == FLEET_T, f"launch count {main_launches} != T={FLEET_T}")
    walls = [wall_ms]
    res2 = pt.simulate(spec)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.simulate(spec)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same = all(np.array_equal(getattr(res1, f), getattr(res2, f))
               for f in ("backlog", "comm_cost")) and all(
        getattr(res1, f) == getattr(res2, f)
        for f in ("avg_response", "p95_response", "completed_mass", "saturated_frac"))
    print(f"  two runs bitwise identical: {same}")
    check(same, "main path: two runs differ")
    check(np.isfinite(res1.backlog).all() and np.isfinite(res1.comm_cost).all()
          and res1.backlog.shape == (FLEET_T,) and np.isfinite(res1.avg_response)
          and res1.completed_mass > 0, "main path: result not finite or of the wrong shape")
    per_slot = np.array(walls) / FLEET_T
    print(f"  wall ms/slot over {len(walls)} runs: median {np.median(per_slot):.4f}, "
          f"min {per_slot.min():.4f}, max {per_slot.max():.4f} [{card}]")
    print(f"  first run {wall_ms / FLEET_T:.4f} ms/slot, avg_backlog={res1.avg_backlog!r} "
          f"avg_cost={res1.avg_cost!r} avg_response={res1.avg_response!r} "
          f"completed_mass={res1.completed_mass!r} saturated_frac={res1.saturated_frac!r} "
          f"[{card}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pt.simulate(spec)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_times(prof)
    busy_ms = sum(r[2] for r in rows)
    if busy_ms > 0:
        print(f"  device busy {busy_ms:.3f} ms of {prof_ms:.3f} ms wall: "
              f"share {busy_ms / prof_ms:.4f} (profiled run)")
        for name, count, ms in rows[:8]:
            print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    else:
        print("  device busy share: not measured (the profiler saw no device time)")

    def compare_route(label, topo_, net_, pl_, arr_, T_, sched, V, W, age_cap):
        cfg = pt.SimConfig(V=V, window=W, scheduler=sched)
        kw_ = dict(age_cap=age_cap, device=cuda)
        t_a = time.perf_counter()
        a = cf._run_cohort_fused_impl(topo_, net_, pl_, arr_, None, T_, cfg, **kw_)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        b = cf._run_cohort_fused_impl(topo_, net_, pl_, arr_, None, T_, cfg,
                                      step=ps.potus_slot_step_plain, **kw_)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
                  rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
        means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
        print(f"{label} {sched} T={T_}: kernel {(t_b - t_a) * 1e3 / T_:.3f} ms/slot, plain "
              f"{(t_c - t_b) * 1e3 / T_:.3f} ms/slot; first 16 slots rel diff {r16:.3e}, "
              f"means {means:.3e}; avg_backlog {a.avg_backlog!r}/{b.avg_backlog!r} "
              f"avg_response {a.avg_response!r}/{b.avg_response!r}")
        check(r16 <= 1e-4 and means <= 0.02, f"{label} {sched}: kernel route vs plain route")

    for sched in ("potus", "shuffle", "jsq"):
        compare_route("fleet", topo, net, placement, arr, FLEET_T, sched, FLEET_V, FLEET_W,
                      FLEET_AGE_CAP)
    compare_route("paper", *paper_system(pt, 300), 300, "potus", 2.0, 2, 64)

    # -- 4. the plain scan engine: kernels 2 and 3, main path 2 --------------------
    scan_kernels = scan_engine(pt, card, cuda)

    # -- 5. the kernels line, 6. the last line ---------------------------------
    print(json.dumps({"kernels": [{
        "name": "potus_slot", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/potus_slot.cu",
        "replaces": "src/repro/kernels/potus_slot.py:57",
        "launches": main_launches, "max_abs_err": one_err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, *scan_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
