#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), holds every kernel against
its plain PyTorch version on the card, and drives the port's paths on the
I=16384 serving fleet, counting the kernel launches of each:

* main path 1 — ``simulate(EngineSpec(engine="cohort-fused",
  scheduler="potus", device="cuda"))``: the slot kernel (``potus_slot``);
* the dense route of the same engine, ``scheduler="potus-loop"``, on an
  I=1024 fleet (phase A): the price kernel (``potus_price``) and the drain
  kernel (``cohort_drain``); kernel 4 alone on dyadic and random inputs
  (B), once (C) and in 16 dense steps (D) at I=16384 from path 1's mid-run
  state; ``events=`` on the compact route, which launches no kernel (E);
  the ``benchmarks/disruption.py`` k-failure scenario (F);
* main path 2 — ``simulate(EngineSpec(engine="jax", scheduler="potus",
  device="cuda"))``, the plain scan engine (the Fig. 5 path): the fused
  schedule kernel (``potus_schedule``); and its ``scheduler="potus-loop"``
  route, on an I=1024 fleet: the price kernel.

It checks the results and prints:

* the card's name and power limit, the torch/CUDA versions and build
  seconds;
* per check, the largest difference kernel vs plain version;
* per kernel, one call's kernel, plain and bound ms at the main path's
  shapes (for the slot kernel each phase's device time, for the drain
  kernel the library call's ms);
* per path, its wall ms per slot, its metrics, the device busy share, the
  top device items and (path 2, phase D) the peak device memory; each
  phase's seconds;
* each comparison of the kernel route with the plain route or with the
  port on the CPU;
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
KERNELS = ("potus_slot", "potus_schedule", "potus_price", "cohort_drain")
ZERO_COUNTS = dict.fromkeys(KERNELS, 0)
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n = read_counts()
    n_sched = n["potus_schedule"]
    peak = torch.cuda.max_memory_allocated()
    print(f"main path 2: engine=jax potus I={FLEET_I} T={FLEET_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB, of which {held} bytes were held before the run)")
    check(n == dict(ZERO_COUNTS, potus_schedule=FLEET_T), f"main path 2 launches {n}")
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop_res = pt.simulate(loop_spec)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n = read_counts()
    n_loop_price = n["potus_price"]
    print(f"potus-loop route: engine=jax I={LOOP_I} T={FLEET_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; {loop_ms:.3f} ms/slot [{card}]")
    check(n == dict(ZERO_COUNTS, potus_price=FLEET_T), f"potus-loop route launches {n}")
    loop_cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus-loop")
    compare_scan_routes(f"fleet I={LOOP_I}", psim, kops.plain, loop_sys, FLEET_T, loop_cfg,
                        cuda, kernel=loop_res)
    compare_scan_routes("paper", psim, kops.plain, paper_system(pt, 300), 300,
                        pt.SimConfig(V=2.0, window=2, scheduler="potus-loop"), cuda)
    compare_scan_routes("fleet rolling-restart", psim, kops.plain, sys_, 64, cfg, cuda,
                        events=fleet_restart(pt, topo, 64))

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


# ---------------------------------------------------------------------------
# the fused cohort engine's dense route (kernel 4) and its events route
# ---------------------------------------------------------------------------

def fleet_restart(pt, topo, T):
    """16 instances (a src and three serve per chain) restart 3 slots apart, 8
    slots each: the restarts run from slot 8 to slot 61 of a T=64 run."""
    restart = [int(i) for c in range(topo.n_components) if c % 3 < 2
               for i in topo.instances_of(c)[:1 if c % 3 == 0 else 3]]
    events = pt.rolling_restart(topo, start=8, down_slots=8, stagger=3,
                                instances=restart).compile(topo, T)
    check(len(restart) == 16 and (events.alive_t == 0).any(axis=1)[8:61].all(),
          "rolling restart: the restarts do not fall inside the run")
    return events


def drain_problem(seed, I, C, Atot, dyadic, cuda):
    """Kernel 4's inputs from numpy: the uniform draw of
    tests/test_cohort_fused.py:407-411, or a dyadic one (integer src and
    ship, ratio in {0, 1/4, 1/2, 1}); components at random."""
    import torch

    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    if dyadic:
        src = (rng.integers(0, 5, (I, C, Atot + 1))
               * (rng.random((I, C, Atot + 1)) < 0.5)).astype(np.float32)
        ship = rng.integers(0, 12, (I, C)).astype(np.float32)
        ratio = rng.choice(np.array([0.0, 0.25, 0.5, 1.0], np.float32), (I, I))
    else:
        src = (rng.uniform(0, 4, (I, C, Atot + 1))
               * (rng.random((I, C, Atot + 1)) < 0.4)).astype(np.float32)
        ship = rng.uniform(0, 10, (I, C)).astype(np.float32)
        ratio = (rng.uniform(0, 1, (I, I)) * (rng.random((I, I)) < 0.3)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=cuda) for x in (src, ship, ratio, comp))


def exact_inputs(src, ship, ratio) -> bool:
    """Inputs on which every product and partial sum of kernel 4 is exact:
    integral masses and split ratios that are multiples of 1/64."""
    import torch

    return all(torch.equal(x, torch.round(x)) for x in (src * 64, ship * 64, ratio * 64))


def check_drain(kd, args, age_bucket, label):
    """Kernel 4 against its plain version on one input: bitwise where the
    inputs are exact, else rtol/atol 1e-5; returns (max_abs_err, bitwise)."""
    import torch

    k = kd.cohort_drain_call(*args, age_bucket)
    p = kd.cohort_drain_split_plain(*args, age_bucket)
    k2 = kd.cohort_drain_call(*args, age_bucket)
    torch.cuda.synchronize()
    err = float((k.double() - p.double()).abs().max()) if k.numel() else 0.0
    check(torch.equal(k, k2), f"{label}: two kernel runs differ")
    if exact_inputs(*args[:3]):
        check(torch.equal(k, p), f"{label}: kernel differs from the plain version on exact "
              f"inputs (max_abs_err {err:.3e})")
    else:
        check(torch.allclose(k, p, rtol=1e-5, atol=1e-5),
              f"{label}: kernel beyond rtol/atol 1e-5 (max_abs_err {err:.3e})")
    return err, torch.equal(k, p)


def drain_checks(pt, cuda):
    """Kernel 4 against its plain version: on the random and dyadic draws of
    tests/test_torch_cohort_drain.py, and on every slot's inputs of a dyadic
    run of the dense route (which itself takes the plain route)."""
    from types import SimpleNamespace

    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import ops as kops

    for shape in ((24, 5, 13, 8), (40, 3, 21, 16), (64, 7, 9, 0), (300, 12, 69, 64)):
        I, C, Atot, ab = shape
        for dyadic in (False, True):
            err, same = check_drain(kd, drain_problem(0, I, C, Atot, dyadic, cuda), ab,
                                    f"drain {shape} dyadic={dyadic}")
            print(f"drain (I, C, Atot, age_bucket)={shape} {'dyadic' if dyadic else 'uniform'}: "
                  f"max_abs_err={err:.3e} bitwise={same}")
    T, W, AC = 40, 1, 16
    topo, net, placement, arr = dyadic_system(pt, T, W)
    seen = {"slots": 0, "exact": 0}

    def both(*args):
        err, same = check_drain(kd, args[:4], args[4], f"dyadic dense t={seen['slots']}")
        seen["slots"] += 1
        seen["exact"] += exact_inputs(*args[:3])
        return kops.plain.cohort_drain_split(*args)

    ops = SimpleNamespace(**vars(kops.plain))
    ops.cohort_drain_split = both
    cf._run_cohort_fused_impl(topo, net, placement, arr, None, T,
                              pt.SimConfig(V=2.0, window=W, scheduler="potus-loop"),
                              age_cap=AC, device=cuda, ops=ops)
    check(seen["slots"] == T, "dyadic dense run: the drain ran on fewer slots than T")
    print(f"dyadic dense route T={T}: drain kernel vs plain on every slot, {seen['exact']} of "
          f"{T} slots with exact inputs checked bitwise, the rest within 1e-5")


def drain_bound(args, age_bucket):
    """Bytes (each input read once, land written once) and operations (the
    drain, ~5 per bucket, and 2 * Atot per nonzero ratio entry of this
    input) of one kernel-4 call; also the dense own-plane count 2 * I^2 * Atot."""
    src, ship, ratio, comp = args
    I, C, Aext = src.shape
    Atot = Aext - 1
    nbytes = sum(x.numel() * x.element_size() for x in args) + 4 * I * Atot
    nnz = int((ratio != 0).sum())
    nops = 5 * src.numel() + 2 * Atot * nnz
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes,
            nops, nnz, 2 * I * I * Atot / PEAK_F32_S * 1e3)


def compare_cohort(label, cf, pt, sys_, T, cfg, cuda, against="plain", kernel=None, **kw):
    """The card's kernel route (``kernel``: a result already run, else run
    here) against the plain route on the card (``against="plain"``) or the
    port on the CPU (``"cpu"``): per-slot backlog and cost within rtol 1e-4
    over the first 16 slots, long-run means within 2%."""
    import torch

    from repro_torch.kernels import ops as kops

    topo, net, placement, arr = sys_
    t_a = time.perf_counter()
    a = kernel if kernel is not None else cf._run_cohort_fused_impl(
        topo, net, placement, arr, None, T, cfg, device=cuda, **kw)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    b = (cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg, device=cuda,
                                   ops=kops.plain, **kw) if against == "plain" else
         cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg, device="cpu", **kw))
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
    check(np.isfinite(a.backlog).all() and np.isfinite(a.comm_cost).all()
          and a.backlog.shape == (T,) and a.completed_mass > 0,
          f"{label}: result not finite, of the wrong shape, or nothing completed")
    kernel_ms = "ran above" if kernel is not None else f"{(t_b - t_a) * 1e3 / T:.3f} ms/slot"
    print(f"{label} {cfg.scheduler} T={T}: card {kernel_ms}, {against} "
          f"{(t_c - t_b) * 1e3 / T:.3f} ms/slot; first 16 slots rel diff {r16:.3e}, means "
          f"{means:.3e}; avg_backlog {a.avg_backlog!r}/{b.avg_backlog!r} "
          f"avg_response {a.avg_response!r}/{b.avg_response!r}")
    check(r16 <= 1e-4 and means <= 0.02, f"{label} {cfg.scheduler}: card vs {against}")
    return a, b


def same_result(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("backlog", "comm_cost")) \
        and all(getattr(a, f) == getattr(b, f) or (np.isnan(getattr(a, f))
                                                   and np.isnan(getattr(b, f)))
                for f in ("avg_response", "p95_response", "completed_mass", "saturated_frac"))


def counters():
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks
    from repro_torch.kernels import potus_slot as ps

    return {"potus_slot": ps.launches, "potus_schedule": ks.launches,
            "potus_price": kp.launches, "cohort_drain": kd.launches}


def reset_counts():
    for c in counters().values():
        c.reset()


def read_counts():
    return {name: c.n for name, c in counters().items()}


def recovery_slots(backlog, t0, t1) -> int:
    """benchmarks/disruption.py:_recovery_slots: slots after recovery until
    backlog returns within 10% of the pre-failure mean."""
    pre = backlog[max(t0 - 20, 0):t0].mean()
    ok = np.nonzero(backlog[t1:] <= 1.1 * pre)[0]
    return int(ok[0]) if ok.size else int(len(backlog[t1:]))


def dyadic_events_card_vs_cpu(pt, cf, cuda):
    """Both routes under events on the dyadic system (tests/test_torch_cohort_events.py):
    every sum is exact, so the card's run equals the port's run on the CPU
    bitwise, for every scheduler, under a rolling restart and a k-failure."""
    T, W = 120, 2
    topo, net, placement, arr = dyadic_system(pt, T + 13, W)
    pairs = [int(i) for i in range(topo.n_instances)
             if topo.comp_parallelism[topo.inst_comp[i]] == 2]
    traces = {"rolling_restart": pt.rolling_restart(topo, start=10, down_slots=6, stagger=3,
                                                    instances=pairs).compile(topo, T),
              "k_failures": pt.k_failures(topo, 2, start=20, duration=30,
                                          rng=np.random.default_rng(1)).compile(topo, T)}
    kw = dict(age_cap=32, warmup=10, drain_margin=30)
    for sched in ("potus", "shuffle", "jsq", "potus-loop"):
        cfg = pt.SimConfig(V=2.0, beta=0.5, window=W, scheduler=sched)
        for name, ev in traces.items():
            a = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg,
                                          device=cuda, events=ev, **kw)
            b = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg,
                                          device="cpu", events=ev, **kw)
            check(same_result(a, b) and a.completed_mass > 0,
                  f"dyadic {sched} {name}: the card's run differs from the CPU's")
    print("dyadic system T=120 under a rolling restart and a k-failure: card equals CPU "
          "bitwise for potus, shuffle, jsq and potus-loop")


def card_vs_cpu_paper(label, cf, sys_, T, cfg, cuda, **kw):
    """The card against the port on the CPU on the paper profile. Shuffle
    ignores queue state: per-slot backlog/cost within rtol 1e-4 over the
    first 16 slots, means within 2%. POTUS breaks the paper system's many
    exact price ties by the last bit of its queues, which the two devices
    round differently (the CPU's cumsum accumulates in double), so its
    trajectories part within a few slots (DESIGN.md §8): its first-16 rel
    diff is printed, and its means are held to the chaos floor of
    tests/test_cohort_fused.py::TestPotusPaperSystem (response and backlog
    10%, cost 2%)."""
    topo, net, placement, arr = sys_
    a = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg, device=cuda, **kw)
    b = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg, device="cpu", **kw)
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = {f: rel_diff(getattr(a, f), getattr(b, f))
             for f in ("avg_backlog", "avg_cost", "avg_response")}
    print(f"{label} {cfg.scheduler} T={T}: card vs CPU first 16 slots rel diff {r16:.3e}, means "
          + ", ".join(f"{f} {v:.3e}" for f, v in means.items()))
    check(np.isfinite(a.backlog).all() and a.completed_mass > 0, f"{label}: not finite")
    if cfg.scheduler == "shuffle":
        check(r16 <= 1e-4 and max(means.values()) <= 0.02, f"{label} shuffle: card vs CPU")
    else:
        check(means["avg_response"] <= 0.10 and means["avg_backlog"] <= 0.10
              and means["avg_cost"] <= 0.02, f"{label} {cfg.scheduler}: beyond the chaos floor")
    return a


def cohort_dense(pt, card, cuda, fleet, consts, mid, streams):
    """Phases A-F: the dense potus-loop route end to end (A), kernel 4 on
    dyadic and random inputs (B), one kernel-4 call (C) and 16 dense steps (D)
    at I=16384 from path 1's mid-run state, events on the compact route at
    I=16384 (E), and the benchmarks/disruption.py scenario (F). Returns
    kernel 4's entry of the kernels line."""
    import torch

    from repro_torch.core import cohort_fused as cf
    from repro_torch.core import potus as pp
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import ops as kops

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: plain products would round")

    # -- A. the dense potus-loop route end to end, I=1024 -----------------------
    t_phase = time.perf_counter()
    loop_sys = fleet_system(pt, LOOP_I, FLEET_T)
    spec = pt.EngineSpec(topo=loop_sys[0], net=loop_sys[1], placement=loop_sys[2],
                         arrivals=loop_sys[3], T=FLEET_T, scheduler="potus-loop", V=FLEET_V,
                         window=FLEET_W, age_cap=FLEET_AGE_CAP, device="cuda")
    reset_counts()
    runs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(pt.simulate(spec))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FLEET_T)
        if len(runs) == 1:
            n = read_counts()
    res1, res2 = runs
    print(f"route A: cohort-fused potus-loop I={LOOP_I} T={FLEET_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f" [{card}]")
    check(n == dict(ZERO_COUNTS, potus_price=FLEET_T, cohort_drain=FLEET_T),
          f"route A launches {n}")
    a_launches = n["cohort_drain"]
    same = same_result(res1, res2)
    print(f"  two runs bitwise identical: {same}")
    check(same, "route A: two runs differ")
    print(f"  wall ms/slot of the two runs: {walls[0]:.4f}, {walls[1]:.4f}; "
          f"avg_backlog={res1.avg_backlog!r} avg_cost={res1.avg_cost!r} "
          f"avg_response={res1.avg_response!r} completed_mass={res1.completed_mass!r} [{card}]")
    # ~2000 launches per slot: profile 8 slots, or reading the trace takes minutes
    print("  profiled: the first 8 slots")
    profile_run(lambda: pt.simulate(dataclasses.replace(spec, T=8)))
    cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus-loop")
    compare_cohort(f"route A fleet I={LOOP_I}", cf, pt, loop_sys, FLEET_T, cfg, cuda,
                   kernel=res1, age_cap=FLEET_AGE_CAP)
    compare_cohort("route A paper", cf, pt, paper_system(pt, 300), 300,
                   pt.SimConfig(V=2.0, window=2, scheduler="potus-loop"), cuda, age_cap=64)
    print(f"  phase A {time.perf_counter() - t_phase:.1f} s")

    # -- B. kernel 4 against its plain version on dyadic and random inputs --------
    t_phase = time.perf_counter()
    drain_checks(pt, cuda)
    print(f"  phase B {time.perf_counter() - t_phase:.1f} s")

    # -- C. one kernel-4 call at I=16384 from path 1's mid-run state ---------------
    t_phase = time.perf_counter()
    topo, net, placement, _ = fleet
    dense = pp.make_problem(topo, net, placement, cuda)
    edges = cf._compact(topo).edges
    u_pair = pp._u_pair(consts.U, dense.inst_container)
    act, pred, nxt = streams

    def step(ops, state, t, drain_split=None):
        sched = partial(pp._schedule_with, ops, method="sort")  # kernel 2 on the kernel route
        return cf._fused_step(consts, dense, sched, edges, u_pair, FLEET_V, 1.0, FLEET_AGE_CAP,
                              state, (act[t], pred[t], nxt[t], t),
                              drain_split=drain_split or ops.cohort_drain_split)

    captured = []

    def capture(*args):
        captured.append(args)
        return kops.plain.cohort_drain_split(*args)

    step(kops, mid, 64, drain_split=capture)
    args, age_bucket = captured[0][:4], captured[0][4]
    k = kd.cohort_drain_call(*args, age_bucket)
    p = kd.cohort_drain_split_plain(*args, age_bucket)
    torch.cuda.synchronize()
    err = float((k.double() - p.double()).abs().max())
    check(torch.allclose(k, p, rtol=1e-5, atol=1e-5),
          f"one cohort_drain call at I={FLEET_I}: beyond rtol/atol 1e-5 (max_abs_err {err:.3e})")
    check(float(p.sum()) > 0, f"one cohort_drain call at I={FLEET_I}: nothing landed")
    del k, p
    ms = time_calls(lambda: kd.cohort_drain_call(*args, age_bucket), 20)
    plain_ms = time_calls(lambda: kd.cohort_drain_split_plain(*args, age_bucket), 5)
    src, ship, ratio, comp = args
    I, C, Aext = src.shape
    drained = pt.drain_ages(src, ship)
    land_src = drained[:, :, :Aext - 1].clone()
    land_src[:, :, age_bucket] += drained[:, :, -1]
    lhs, rhs = ratio.T, land_src.reshape(I, C * (Aext - 1))
    library_ms = time_calls(lambda: torch.matmul(lhs, rhs), 5)
    del drained, land_src, rhs
    bound_ms, bound_by, nbytes, nops, nnz, dense_ms = drain_bound(args, age_bucket)
    print(f"one cohort_drain call at I={FLEET_I} (path 1's state at t=64, X from the sort "
          f"scheduler): max_abs_err={err:.3e} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (the all-plane f32 matmul) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes} bytes, {nops} ops, {nnz} nonzero ratios of {I * I}); dense "
          f"own-plane work 2*I^2*Atot would take {dense_ms:.4f} ms [{card}]")
    del captured, args, src, ship, ratio, comp, lhs
    print(f"  phase C {time.perf_counter() - t_phase:.1f} s")

    # -- D. 16 dense steps at I=16384, kernel route against plain route ------------
    t_phase = time.perf_counter()

    def dense_run(ops):
        state, mets = mid, []
        for t in range(64, 80):
            state, m = step(ops, state, t)
            mets.append(torch.stack(m))
        return torch.stack(mets).cpu().numpy()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk = dense_run(kops)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 16
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    mp = dense_run(kops.plain)
    r16 = max(rel_diff(mk[:, q], mp[:, q]) for q in (0, 1))
    print(f"phase D: 16 dense steps at I={FLEET_I} (sort scheduler): {step_ms:.3f} ms per step, "
          f"launches cohort_drain={n['cohort_drain']} potus_schedule={n['potus_schedule']}; "
          f"kernel vs plain route per-slot backlog/cost rel diff {r16:.3e}; peak device memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
    check(n == dict(ZERO_COUNTS, potus_schedule=16, cohort_drain=16), f"phase D launches {n}")
    check(np.isfinite(mk).all() and r16 <= 1e-4, "phase D: kernel route vs plain route")
    profile_run(lambda: step(kops, mid, 64))
    del dense, u_pair
    torch.cuda.empty_cache()
    print(f"  phase D {time.perf_counter() - t_phase:.1f} s")

    # -- E. events on the compact route at I=16384 ---------------------------------
    t_phase = time.perf_counter()
    events = fleet_restart(pt, topo, 64)
    ev_spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=fleet[3], T=64,
                            scheduler="potus", V=FLEET_V, window=FLEET_W, age_cap=FLEET_AGE_CAP,
                            warmup=16, drain_margin=16, events=events, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e1 = pt.simulate(ev_spec)
    torch.cuda.synchronize()
    ev_ms = (time.perf_counter() - t0) * 1e3 / 64
    n = read_counts()
    e2 = pt.simulate(ev_spec)
    same = same_result(e1, e2)
    print(f"phase E: cohort-fused potus I={FLEET_I} T=64 rolling restart of 16: {ev_ms:.3f} "
          f"ms/slot, launches " + " ".join(f"{k}={v}" for k, v in n.items())
          + f"; two runs bitwise identical: {same} [{card}]")
    check(n == ZERO_COUNTS, f"phase E launched a kernel: {n}")
    check(same, "phase E: two runs differ")
    profile_run(lambda: pt.simulate(ev_spec))
    compare_cohort("phase E fleet rolling-restart", cf, pt, fleet, 64,
                   pt.SimConfig(V=FLEET_V, window=FLEET_W), cuda, against="cpu", kernel=e1,
                   age_cap=FLEET_AGE_CAP, warmup=16, drain_margin=16, events=events)
    dyadic_events_card_vs_cpu(pt, cf, cuda)
    print(f"  phase E {time.perf_counter() - t_phase:.1f} s")

    # -- F. the benchmarks/disruption.py scenario ----------------------------------
    t_phase = time.perf_counter()
    T = 300
    sys_ = paper_system(pt, T)
    ptopo = sys_[0]
    t_fail, dur = T // 3, max(T // 6, 4)
    k = max(int(0.2 * len(ptopo.bolt_instances)), 2)
    kfail = pt.k_failures(ptopo, k=k, start=t_fail, duration=dur,
                          rng=np.random.default_rng(11)).compile(ptopo, T)
    kw = dict(age_cap=max(4 * dur, 48), warmup=max(t_fail - 1, 1),
              drain_margin=T - min(t_fail + dur + 10, T - 1))
    bench = {(r["scheduler"], r["W"]): r for r in json.loads(
        (ROOT / "BENCH_disruption.json").read_text())["rows"] if r["section"] == "disruption"}
    for sched in ("potus", "shuffle"):
        for W in (0, 2, 6):
            cfg = pt.SimConfig(V=1.0, window=W, scheduler=sched)
            run = partial(cf._run_cohort_fused_impl, ptopo, sys_[1], sys_[2], sys_[3], None, T,
                          cfg, device=cuda, **kw)
            if W == 2:  # the card against the port on the CPU
                hurt = card_vs_cpu_paper(f"phase F k{k}-failure W={W}", cf, sys_, T, cfg, cuda,
                                         events=kfail, **kw)
            else:
                hurt = run(events=kfail)
            base = run()
            got = dict(resp_transient=float(hurt.avg_response),
                       peak_backlog=float(hurt.backlog[t_fail:t_fail + dur + 10].max()),
                       recovery_slots=recovery_slots(hurt.backlog, t_fail, t_fail + dur),
                       resp_degradation=float(hurt.avg_response - base.avg_response))
            check(all(np.isfinite(v) for v in got.values()), f"phase F {sched} W={W}: not finite")
            ref = bench[(sched, W)]
            print(f"  disruption {sched} W={W}: " + ", ".join(
                f"{name} {v:.3f} (BENCH_disruption.json {ref[name]}, rel "
                f"{rel_diff(v, ref[name]):.3f})" for name, v in got.items()) + f" [{card}]")
    print(f"  phase F {time.perf_counter() - t_phase:.1f} s")

    return {"name": "cohort_drain", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_drain.cu",
            "replaces": "src/repro/kernels/cohort_drain.py:38", "launches": a_launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = read_counts()
    main_launches = n["potus_slot"]
    print(f"main path: potus I={FLEET_I} T={FLEET_T} launches={main_launches} (" + " ".join(
        f"{k}={v}" for k, v in n.items()) + ")")
    check(n == dict(ZERO_COUNTS, potus_slot=FLEET_T), f"main path launches {n}")
    walls = [wall_ms]
    res2 = pt.simulate(spec)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.simulate(spec)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same = same_result(res1, res2)
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

    for sched in ("potus", "shuffle", "jsq"):
        compare_cohort("fleet", cf, pt, (topo, net, placement, arr), FLEET_T,
                       pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler=sched), cuda,
                       age_cap=FLEET_AGE_CAP)
    compare_cohort("paper", cf, pt, paper_system(pt, 300), 300,
                   pt.SimConfig(V=2.0, window=2, scheduler="potus"), cuda, age_cap=64)

    # -- 4. the fused cohort engine's dense route and events route: phases A-F ------
    drain_kernel = cohort_dense(pt, card, cuda, (topo, net, placement, arr), consts, mid,
                                streams)

    # -- 5. the plain scan engine: kernels 2 and 3, main path 2 --------------------
    scan_kernels = scan_engine(pt, card, cuda)

    # -- 6. the kernels line, 7. the last line ---------------------------------
    print(json.dumps({"kernels": [{
        "name": "potus_slot", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/potus_slot.cu",
        "replaces": "src/repro/kernels/potus_slot.py:57",
        "launches": main_launches, "max_abs_err": one_err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, *scan_kernels, drain_kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
