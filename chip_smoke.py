#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version on the card, drives
the port's main path — ``simulate(EngineSpec(engine="cohort-fused",
scheduler="potus", device="cuda"))`` on the I=16384 serving fleet — counts
the kernel launches of that run, checks the results, and prints:

* the card's name and power limit, the torch/CUDA versions, build seconds;
* per check, the largest difference kernel vs plain version;
* per phase kernel, its device time; per call, kernel, plain and bound ms;
* the main path's wall ms per slot, its metrics and the device busy share;
* one JSON line ``{"kernels": [...]}``, then, last,
  ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is not 0 and the last line is not
printed. Without a CUDA device it exits with code 2 and prints no result.
It imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the I=16384 serving fleet of benchmarks/systems_bench.py:137 (_cohort_fleet)
FLEET_I, FLEET_T, FLEET_W, FLEET_V, FLEET_AGE_CAP = 16384, 128, 4, 2.0, 64
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
    _build.build("potus_slot")
    print(f"kernel build: potus_slot {_build.BUILD_SECONDS['potus_slot']:.2f} s "
          f"(wall {time.perf_counter() - t0:.2f} s)")

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

    # -- 4. the kernels line, 5. the last line ---------------------------------
    print(json.dumps({"kernels": [{
        "name": "potus_slot", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/potus_slot.cu",
        "replaces": "src/repro/kernels/potus_slot.py:57",
        "launches": main_launches, "max_abs_err": one_err, "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
