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
  the ``benchmarks/disruption.py`` grid as one ``run_sweep`` (F);
* main path 2 — ``simulate(EngineSpec(engine="jax", scheduler="potus",
  device="cuda"))``, the plain scan engine (the Fig. 5 path): the fused
  schedule kernel (``potus_schedule``); and its ``scheduler="potus-loop"``
  route, on an I=1024 fleet: the price kernel;
* phase G, the serving path — ``PotusDispatcher`` on the card (the
  schedule kernel once per slot) over a ``ReplicaFleet`` of 4
  ``ServingEngine`` replicas sharing one qwen2.5-32b decoder at full width
  (4 of 64 layers, bf16, weights from a seeded ``torch.Generator``): the
  flash attention kernel (``flash_attention``, per prefill and layer) and
  the decode attention kernel (``decode_attention``, per decode round and
  layer); both kernels alone at qwen2.5-32b and zamba2-1.2b widths beside
  SDPA; the kernel route against the plain route teacher-forced, in bf16
  and in f32; one of the two served runs with a ``FlightRecorder`` on the
  dispatcher and one on the fleet (J4);
* phase H, the SSM and hybrid models at full width and depth in bf16,
  weights from a seeded ``torch.Generator``: the SSD intra-chunk kernel
  (``ssd_intra_chunk``) alone at mamba2-1.3b widths through
  ``ssd_chunked``'s kernel route; one mamba2-1.3b ``forward`` of 2048
  tokens (one launch per Mamba2 block), each block held to the plain route
  from the same input and 2 layers in f32 end to end; zamba2-1.2b serving
  two 512-token prompts through a ``ServingEngine`` (kernel 7 per Mamba2
  block and flash attention per shared-attention invocation in each
  prefill, decode attention per invocation in each decode round), its
  tokens against the entry points', every launch of the three kernels on
  that path held against its plain version on the path's own arguments
  in bf16 and f32, each block and attention invocation held to the plain
  route from the same input in bf16, the kernel route against the plain
  route end to end in f32, and prefill/decode against a forward;
* phase I, scenario sweeps — ``run_sweep(engine="cohort-fused")`` on the
  I=16384 fleet's V x W grid: the slot kernel once a launch for all the
  scenarios of a partition (its grid has a scenario axis), each scenario
  bitwise its own ``simulate``; the dyadic sweep against the CPU and every
  batched call against the batched plain version; the paper profile's
  Fig. 6ab and Fig. 5 grids (``benchmarks/torch_figures.py``) against the
  CPU, whose runs go in a process of their own started first;
* phase J, observability (``metrics=``, span tracing, the obs dump; no
  kernel of its own): J1 the metric streams of both ported engines on the
  dyadic system — the card's equal the CPU's, metrics on leave every
  trajectory bitwise as off, and a compact ``cohort-fused`` run with
  metrics (which takes ``compact_slot_step``, not the slot kernel, as the
  reference does) equals the plain and the kernel route; J2 the I=16384
  fleet with metrics on: path 2 (kernel 2 still once a slot) and the
  compact ``cohort-fused`` run (``potus_slot=0``), their wall beside the
  metrics-off paths in turns; J3 ``benchmarks/torch_figures.py``'s
  metrics dump through the k-failure transient, read back by
  ``tools/obs_report.py --recovery``, its Chrome trace, and a
  ``torch.profiler`` trace listing the span names.

It checks the results and prints:

* the card's name and power limit, the torch/CUDA versions and build
  seconds;
* per check, the largest difference kernel vs plain version;
* per kernel, one call's kernel, plain and bound ms at the main path's
  shapes (for the drain kernel the library call's ms); for the slot and
  SSD kernels the device ms per call from a ``torch.profiler`` trace, split
  by device function, beside the event-timed ms; for the attention kernels
  the device ms per call of the kernel and of
  ``scaled_dot_product_attention`` beside their event-timed ms, the route
  each call took (tensor cores or SIMT) and the reached TFLOP/s or GB/s;
* per path, its wall ms per slot, its metrics, the device busy share, the
  top device items and (path 2, phase D) the peak device memory; each
  phase's seconds; for the served run its tokens, slots, wall seconds,
  tokens/s, ms per decode round, prefill ms per prompt token and peak
  device memory;
* each comparison of the kernel route with the plain route or with the
  port on the CPU;
* for phase I, the sweep's and a loop of ``simulate`` calls' wall s in
  turns and scenario-slots/s, the busy share, and the slot kernel's device
  ms per call at N=4 and N=1;
* for phase J, the wall ms/slot of path 2 and of the compact
  ``cohort-fused`` run with metrics on and off, in turns, the launches and
  route of each, the peak device memory and the recovery story of the dump;
* one JSON line ``{"kernels": [...]}`` (seven kernels; the slot kernel's
  row carries its batched entry under ``"batched"``), then, last,
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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the I=16384 serving fleet of benchmarks/systems_bench.py:137 (_cohort_fleet)
FLEET_I, FLEET_T, FLEET_W, FLEET_V, FLEET_AGE_CAP = 16384, 128, 4, 2.0, 64
# the potus-loop route runs max_succ argmin passes per slot (3072 at I=16384,
# seconds per slot), so its fleet is cut to I=1024 until the loop gets a kernel
LOOP_I = 1024
KERNELS = ("potus_slot", "potus_schedule", "potus_price", "cohort_drain", "flash_attention",
           "decode_attention", "ssd_intra_chunk")
ZERO_COUNTS = dict.fromkeys(KERNELS, 0)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor cores, bf16
# tensor cores (dense)
PEAK_BYTES_S, PEAK_F32_S, PEAK_BF16_S = 3.35e12, 67e12, 989e12
# phase G, the served run: qwen2.5-32b at full width, depth cut to 4 of 64 layers, bf16; a
# fleet of 4 replicas behind the dispatcher (examples/serving_demo.py's traffic, scaled up)
SERVE_ARCH, SERVE_LAYERS = "qwen2_5_32b", 4
SERVE_RATES = (4.0, 2.0, 2.0, 2.0)  # decode rounds per slot; replica 0 is the fast one
SERVE_BATCH, SERVE_MAX_LEN, SERVE_MAX_NEW, SERVE_REQUESTS = 4, 1024, 16, 32
SERVE_PROMPT_LENS = (32, 64, 128, 256, 512)
SERVE_STRAGGLE = (6, 12)  # replica 0 serves at 25% over slots [6, 12)
# phase H, the SSM and hybrid models at full width and depth, bf16: mamba2-1.3b forward
# (b=1, T=2048) and zamba2-1.2b served (2 prompts of 512 tokens, 16 decode rounds); kernel 7
# alone at mamba2-1.3b widths (H=64, P=64, S=128, chunk 256): (b, T, dtype) cases
SSD_ARCH, HYBRID_ARCH = "mamba2_1_3b", "zamba2_1_2b"
SSD_CASES = ((1, 2048, "bfloat16"), (1, 2048, "float32"), (2, 1000, "float32"))
# of max |ref|: tests/test_kernels.py:98-108; the f32 states are held at the f32 limit in every
# case (both sides compute them in f32), only a bf16 y_diag at the bf16 one
SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SSM_T, HYBRID_PROMPT, HYBRID_STEPS, HYBRID_MAX_LEN = 2048, 512, 16, 544
SSM_FORWARD_RUNS = 10  # timed forwards of H2
HYBRID_PREFILL_RUNS = 5  # warm prefills of each H3 prompt, timed


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
    """T slots through ``step`` in launches of K; returns (state, (4, T)
    metrics), or (4, N, T) for a batch of N scenarios (streams (T, I, C)
    shared or (N, T, I, C) stacked)."""
    import torch

    act, pred, nxt = streams
    T = act.shape[-3] if T is None else T
    mets = []
    for t0 in range(0, T, K):
        n = min(K, T - t0)
        sl = (..., slice(t0, t0 + n), slice(None), slice(None))
        state, m = step(consts, state, act[sl], pred[sl], nxt[sl], t0,
                        scheduler=scheduler, age_cap=age_cap, n_slots=n)
        mets.append(torch.stack(m))
    return state, torch.cat(mets, dim=-1)


def batch_inputs(cf, sys_, T, W, Vs, betas, age_cap, device, stacked):
    """One partition's slot-kernel inputs for N = len(Vs) scenarios: the
    batched constants (V and beta (N,)), state and streams — shared, or
    stacked with scenario n's arrivals rolled by n slots — and each
    scenario's own (consts, state, streams)."""
    import torch

    topo, net, placement, arr = sys_
    one = [step_inputs(cf, topo, net, placement, np.roll(arr, n, axis=0) if stacked else arr,
                       T, W, V, beta, age_cap, device)
           for n, (V, beta) in enumerate(zip(Vs, betas))]
    f32 = dict(dtype=torch.float32, device=device)
    consts = one[0][0]._replace(V=torch.tensor(Vs, **f32), beta=torch.tensor(betas, **f32))
    state = tuple(torch.stack([o[1][q] for o in one]) for q in range(7))
    streams = (tuple(torch.stack([o[2][q] for o in one]) for q in range(3)) if stacked
               else one[0][2])
    return consts, state, streams, one


def max_abs(a_state, a_met, b_state, b_met) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(tuple(a_state) + (a_met,), tuple(b_state) + (b_met,)))


def bytes_and_ops(consts, state, n_slots, stacked=False):
    """What one call must move (each input read once, each output written
    once) and the arithmetic it does, counted from the shapes. A batch of N
    scenarios (``state`` with its leading axis, ``consts.V`` (N,)) moves
    its state and metrics N times, the shared constants once, and the
    (K, I, C) arrival streams once if shared, N times if ``stacked``."""
    q_rem, admit, q_in, q_out, transit, rmass, rtime = state
    N = q_rem.shape[0] if q_rem.dim() == 4 else 1
    I, S, W1 = q_rem.shape[-3:]
    A = q_in.shape[-1]
    C = consts.adj_rows.shape[1]
    NK = consts.U.shape[0]
    state_floats = sum(x.numel() for x in state)
    const_floats = (sum(x.numel() for x in consts[:17]) - consts.comp_onehot.numel()
                    + sum(x.numel() for x in consts[17:]))
    stream_floats = (N if stacked else 1) * 3 * n_slots * I * C
    floats = 2 * state_floats + const_floats + stream_floats + 4 * N * n_slots
    ops = N * n_slots * (3 * NK * I + I * (2 * C * C + 10 * S * (A + 1) + 12 * A + 20 * C))
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


def device_ms(fn, n, parts=None):
    """Device ms per call of ``fn``, from a ``torch.profiler`` trace of ``n``
    calls: for each device function, its mean duration per record times its
    launches per call (records / n, rounded), summed. Unlike
    ``time_calls``, the host's cost of launching is left out, so a call that
    costs the host more than the card is not timed at the host's rate. The
    trace now and then drops a record (or all of them: it is then taken
    again, up to three times); a mean over the records kept is not shortened
    by that. ``parts``, a dict, receives the ms per call of each name."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_times(prof)
        if rows:
            per_call = {name.split("(")[0]: ms / count * max(1, round(count / n))
                        for name, count, ms in rows}
            if parts is not None:
                parts.update(per_call)
            return sum(per_call.values())
    check(False, f"device_ms: three traces of {n} calls held no device records")


def device_times(prof):
    """(name, count, device ms) per device-side event name, longest first.
    A ``record_function`` span shows on the device timeline too; it is a range
    over kernels already counted, so it is left out."""
    import torch

    rows = []
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
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
    their plain versions (+inf in the same places), device ms per call (a
    ``torch.profiler`` trace) beside the event-timed ms (CUDA events, warmed
    up), plain ms, bound."""
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
        dev_ms = device_ms(lambda: call(*args, *extra, FLEET_V, 1.0), 20)
        ms = time_calls(lambda: call(*args, *extra, FLEET_V, 1.0), 20)
        plain_ms = time_calls(lambda: plain(*args, *extra, FLEET_V, 1.0), 3)
        bound_ms, bound_by, nbytes, nops = kernel_bound(args, gamma)
        print(f"one {name} call at I={FLEET_I} (mid-run state, t=64): max_abs_err={err:.3e} "
              f"device ms per call: kernel {dev_ms:.4f}; event ms per call: kernel {ms:.4f}, "
              f"plain {plain_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
              f"{nops} ops) [{card}]")
        out[name] = dict(max_abs_err=err, ms=dev_ms, device_ms=dev_ms, event_ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def profile_run(fn, top=8, suffix="", also=()):
    """Device busy share and the top device items of one profiled run, and
    the items whose name starts with one of ``also`` wherever they rank."""
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
              f"share {busy_ms / prof_ms:.4f} (profiled run){suffix}")
        for i, (name, count, ms) in enumerate(rows):
            if i < top or name.split("<")[0].split("(")[0].removeprefix("void ").startswith(also):
                print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}{suffix}")
    else:
        print(f"  device busy share: not measured (the profiler saw no device time){suffix}")
    return busy_ms, prof_ms


def wall_and_issue(fn, n):
    """Wall ms of ``n`` synchronised calls of ``fn``, and the host's ms until
    each call returns (everything issued, before the synchronize): where the
    two meet, the host sets the wall."""
    import torch

    walls, issued = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issued.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return np.array(walls), np.array(issued)


def timed_runs(fn, T, n):
    """Wall ms per slot of ``n`` synchronised runs."""
    return wall_and_issue(fn, n)[0] / T


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


def fleet_inputs(pt, cf, cuda):
    """The I=16384 fleet, its step constants, initial state and streams."""
    fleet = fleet_system(pt, FLEET_I, FLEET_T)
    check(fleet[0].n_instances == FLEET_I, "fleet size")
    return (fleet, *step_inputs(cf, *fleet, FLEET_T, FLEET_W, FLEET_V, 1.0, FLEET_AGE_CAP,
                                cuda))


def fleet_mid(ps, consts, state0, streams):
    """Path 1's state after 64 slots of the slot kernel (launches of 8)."""
    return run_slots(ps.potus_slot_call, consts, state0, streams, 8, "potus", FLEET_AGE_CAP,
                     T=64)[0]


def dense_stepper(pt, cf, fleet, consts, streams, cuda):
    """``step(ops, state, t, drain_split=None)``: one slot of the dense
    potus-loop route's ``_fused_step`` on the I=16384 fleet, from any state,
    with the sort scheduler (kernel 2 on the kernel route)."""
    from repro_torch.core import potus as pp

    topo, net, placement, _ = fleet
    dense = pp.make_problem(topo, net, placement, cuda)
    edges = cf._compact(topo).edges
    u_pair = pp._u_pair(consts.U, dense.inst_container)
    act, pred, nxt = streams

    def step(ops, state, t, drain_split=None):
        sched = partial(pp._schedule_with, ops, method="sort")
        return cf._fused_step(consts, dense, sched, edges, u_pair, FLEET_V, 1.0, FLEET_AGE_CAP,
                              state, (act[t], pred[t], nxt[t], t),
                              drain_split=drain_split or ops.cohort_drain_split)

    return step


class _Captured(Exception):
    """Ends a run once the drain's inputs of the wanted slot are taken."""


def drain_args_fleet(step, mid):
    """Kernel 4's arguments at I=16384: one dense step from path 1's state at
    slot 64 (X from the sort scheduler). Returns ``(args, age_bucket)``."""
    from repro_torch.kernels import ops as kops

    captured = []

    def capture(*args):
        captured.append(args)
        return kops.plain.cohort_drain_split(*args)

    step(kops, mid, 64, drain_split=capture)
    return captured[0][:4], captured[0][4]


def drain_args_loop(pt, cf, cuda, t=64):
    """Kernel 4's arguments on route A's I=1024 fleet at slot ``t``: the dense
    potus-loop route on the card (kernel 3, the plain drain) run up to that
    slot. Returns ``(args, age_bucket)``."""
    from repro_torch.kernels import ops as kops

    topo, net, placement, arr = fleet_system(pt, LOOP_I, FLEET_T)
    seen = []

    def capture(*args):
        seen.append(args)
        if len(seen) > t:
            raise _Captured
        return kops.plain.cohort_drain_split(*args)

    ops = SimpleNamespace(**vars(kops.plain))
    ops.potus_price = kops.potus_price
    ops.cohort_drain_split = capture
    try:
        cf._run_cohort_fused_impl(topo, net, placement, arr, None, FLEET_T,
                                  pt.SimConfig(V=FLEET_V, window=FLEET_W,
                                               scheduler="potus-loop"),
                                  age_cap=FLEET_AGE_CAP, device=cuda, ops=ops)
    except _Captured:
        pass
    check(len(seen) == t + 1, f"route A ran {len(seen)} slots, not {t + 1}")
    return seen[t][:4], seen[t][4]


def drain_timing(kd, args, age_bucket, label, card):
    """Kernel 4 on one input: held against its plain version (bitwise on
    exact inputs, else rtol/atol 1e-5), two runs bitwise, something landed;
    then its device ms per call and per phase (a ``torch.profiler`` trace),
    the event-timed ms, the reached GB/s of the ratio read (its bytes over
    the phase that reads it) and that phase's ms on an all-zero ratio of the
    same shape (the stream without the products of the nonzeros), the plain
    version's ms, the library call's (``ratio.T @ land_src`` over all
    component planes, by device and by event) and the bound. Returns the
    numbers."""
    import torch

    from repro_torch.core.compact import drain_ages

    err, same = check_drain(kd, args, age_bucket, label)
    landed = float(kd.cohort_drain_split_plain(*args, age_bucket).sum())
    check(landed > 0, f"{label}: nothing landed")
    parts = {}
    dev = device_ms(lambda: kd.cohort_drain_call(*args, age_bucket), 20, parts=parts)
    ev = time_calls(lambda: kd.cohort_drain_call(*args, age_bucket), 20)
    plain_ms = time_calls(lambda: kd.cohort_drain_split_plain(*args, age_bucket), 5)
    src, ship, ratio, comp = args
    I, C, Aext = src.shape
    drained = drain_ages(src, ship)
    land_src = drained[:, :, :Aext - 1].clone()
    land_src[:, :, age_bucket] += drained[:, :, -1]
    lhs, rhs = ratio.T, land_src.reshape(I, C * (Aext - 1))
    lib_dev = device_ms(lambda: torch.matmul(lhs, rhs), 5)
    lib_ev = time_calls(lambda: torch.matmul(lhs, rhs), 5)
    del drained, land_src, lhs, rhs
    # the stream alone: the same call on an all-zero ratio, which has no products to take
    zero, stream_parts = torch.zeros_like(ratio), {}
    device_ms(lambda: kd.cohort_drain_call(src, ship, zero, comp, age_bucket), 20,
              parts=stream_parts)
    del zero
    bound_ms, bound_by, nbytes, nops, nnz, dense_ms = drain_bound(args, age_bucket)
    per_col = (ratio != 0).sum(dim=0)
    ratio_ms = sum(ms for name, ms in parts.items() if "phase_b" in name)
    stream_ms = sum(ms for name, ms in stream_parts.items() if "phase_b" in name)
    gb_s = ratio.numel() * ratio.element_size() / (ratio_ms * 1e-3) / 1e9 if ratio_ms else 0.0
    print(f"{label}: max_abs_err={err:.3e} bitwise={same}, two runs bitwise; device ms per "
          f"call: kernel {dev:.4f}; event ms per call: kernel {ev:.4f}, plain {plain_ms:.4f}; "
          f"ratio read at {gb_s:.1f} GB/s (phase B {ratio_ms:.4f} ms; on an all-zero ratio "
          f"{stream_ms:.4f}); library (the all-plane f32 matmul) device "
          f"{lib_dev:.4f} (event {lib_ev:.4f}); bound {bound_ms:.4f} ms ({bound_by}: {nbytes} "
          f"bytes, {nops} ops, {nnz} nonzero ratios of {I * I} in "
          f"{int((per_col > 0).sum())} columns, at most {int(per_col.max())} a column); dense "
          f"own-plane work 2*I^2*Atot would take {dense_ms:.4f} ms [{card}]")
    for name, ms in sorted(parts.items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: {ms:.4f} ms per call")
    return dict(max_abs_err=err, device_ms=dev, event_ms=ev, parts=parts, ratio_gb_s=gb_s,
                stream_ms=stream_ms, plain_ms=plain_ms, library_ms=lib_dev,
                library_event_ms=lib_ev, bound_ms=bound_ms, bound_by=bound_by)


def drain_kernel(card, cuda, step=None, mid=None):
    """Kernel 4 alone at the shapes of its two paths, each held against its
    plain version and timed by device and by phase (:func:`drain_timing`):
    phase D's I=16384 input (path 1's state at slot 64, one dense step) and
    route A's I=1024 input at slot 64; and one dense step at I=16384 from
    slot 64, wall-timed. ``step`` (:func:`dense_stepper`) and
    ``mid`` come from the caller, or are built here from the fleet, so that
    two checkouts can be compared in turns on one card. Returns kernel 4's
    entry of the kernels line, its ``launches`` left to the caller."""
    import torch

    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import potus_slot as ps

    if step is None:
        fleet, consts, state0, streams = fleet_inputs(pt, cf, cuda)
        mid = fleet_mid(ps, consts, state0, streams)
        step = dense_stepper(pt, cf, fleet, consts, streams, cuda)
    args, age_bucket = drain_args_fleet(step, mid)
    big = drain_timing(kd, args, age_bucket, f"one cohort_drain call at I={FLEET_I} (path 1's "
                       "state at t=64, X from the sort scheduler)", card)
    del args
    walls, issued = wall_and_issue(lambda: step(kops, mid, 64), 8)
    print(f"one dense step at I={FLEET_I} from t=64 (kernels 2 and 4): wall ms over 8: median "
          f"{np.median(walls):.4f}, min {walls.min():.4f}, max {walls.max():.4f}; host ms to "
          f"issue it: median {np.median(issued):.4f} [{card}]")
    torch.cuda.empty_cache()
    args, age_bucket = drain_args_loop(pt, cf, cuda)
    small = drain_timing(kd, args, age_bucket, f"one cohort_drain call at I={LOOP_I} (route "
                         "A's state at t=64, X from the argmin loop)", card)
    return {"name": "cohort_drain", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_drain.cu",
            "replaces": "src/repro/kernels/cohort_drain.py:38", "launches": None,
            "ms": big["device_ms"], **big, "dense_step_ms": float(np.median(walls)),
            f"at_I{LOOP_I}": small}


def compare_cohort(label, cf, pt, sys_, T, cfg, cuda, against="plain", kernel=None, other=None,
                   **kw):
    """The card's kernel route (``kernel``: a result already run, else run
    here) against the plain route on the card (``against="plain"``), the
    port on the CPU (``"cpu"``) or the kernel route (``"kernel"``, for a
    ``kernel`` result of another route), ``other`` when that one has run
    already: per-slot backlog and cost within rtol 1e-4 over the first 16
    slots, long-run means within 2%."""
    import torch

    from repro_torch.kernels import ops as kops

    topo, net, placement, arr = sys_
    run = partial(cf._run_cohort_fused_impl, topo, net, placement, arr, None, T, cfg, **kw)
    t_a = time.perf_counter()
    a = kernel if kernel is not None else run(device=cuda)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    b = other if other is not None else {
        "plain": lambda: run(device=cuda, ops=kops.plain), "cpu": lambda: run(device="cpu"),
        "kernel": lambda: run(device=cuda)}[against]()
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
    check(np.isfinite(a.backlog).all() and np.isfinite(a.comm_cost).all()
          and a.backlog.shape == (T,) and a.completed_mass > 0,
          f"{label}: result not finite, of the wrong shape, or nothing completed")
    kernel_ms = "ran above" if kernel is not None else f"{(t_b - t_a) * 1e3 / T:.3f} ms/slot"
    other_ms = "ran above" if other is not None else f"{(t_c - t_b) * 1e3 / T:.3f} ms/slot"
    print(f"{label} {cfg.scheduler} T={T}: card {kernel_ms}, {against} {other_ms}; "
          f"first 16 slots rel diff {r16:.3e}, means "
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
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks
    from repro_torch.kernels import potus_slot as ps
    from repro_torch.kernels import ssd_scan as kss

    return {"potus_slot": ps.launches, "potus_schedule": ks.launches,
            "potus_price": kp.launches, "cohort_drain": kd.launches,
            "flash_attention": kfa.launches, "decode_attention": kda.launches,
            "ssd_intra_chunk": kss.launches}


def route_counters():
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa

    return {"flash_attention": kfa, "decode_attention": kda}


def kernel_routes():
    """Launches of each route of kernels 5 and 6 (tensor cores, SIMT) since
    the last reset: {kernel: {"tc": n, "simt": n}}."""
    return {name: {"tc": m.launches_tc.n, "simt": m.launches_simt.n}
            for name, m in route_counters().items()}


def all_on_tensor_cores(n):
    """The routes expected when every launch of kernels 5 and 6 in the
    counts ``n`` took the tensor cores (bf16 at head_dim 64 or 128)."""
    return {name: {"tc": n[name], "simt": 0} for name in route_counters()}


def reset_counts():
    for c in counters().values():
        c.reset()
    for m in route_counters().values():
        m.launches_tc.reset()
        m.launches_simt.reset()


def read_counts():
    return {name: c.n for name, c in counters().items()}


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


def hold_card_vs_cpu(label, scheduler, a, b):
    """A card's result ``a`` against the port's on the CPU ``b``, on the
    paper profile. Shuffle ignores queue state: per-slot backlog/cost within
    rtol 1e-4 over the first 16 slots, means within 2%. POTUS breaks the
    paper system's many exact price ties by the last bit of its queues,
    which the two devices round differently (the CPU's cumsum accumulates in
    double), so its trajectories part within a few slots (DESIGN.md §8): its
    first-16 rel diff is printed, and its means are held to the chaos floor
    of tests/test_cohort_fused.py::TestPotusPaperSystem (response and
    backlog 10%, cost 2%)."""
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = {f: rel_diff(getattr(a, f), getattr(b, f))
             for f in ("avg_backlog", "avg_cost", "avg_response")}
    print(f"{label}: card vs CPU first 16 slots rel diff {r16:.3e}, means "
          + ", ".join(f"{f} {v:.3e}" for f, v in means.items()))
    check(np.isfinite(a.backlog).all() and a.completed_mass > 0, f"{label}: not finite")
    if scheduler == "shuffle":
        check(r16 <= 1e-4 and max(means.values()) <= 0.02, f"{label} shuffle: card vs CPU")
    else:
        floor = {"avg_response": 0.10, "avg_backlog": 0.10, "avg_cost": 0.02}
        check(all(v <= floor[f] for f, v in means.items()),
              f"{label} {scheduler}: beyond the chaos floor")


def cohort_dense(pt, card, cuda, fleet, consts, mid, streams):
    """Phases A-F: the dense potus-loop route end to end (A), kernel 4 on
    dyadic and random inputs (B), kernel 4 alone at I=16384 from path 1's
    mid-run state and at route A's I=1024 (C), 16 dense steps at I=16384 from
    path 1's mid-run state (D), events on the compact route at I=16384 (E),
    and the benchmarks/disruption.py grid as one sweep (F). Returns kernel 4's
    entry of the kernels line."""
    import torch

    from repro_torch.core import cohort_fused as cf
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

    # -- C. kernel 4 alone at I=16384 (path 1's state at t=64) and at I=1024 (route A) --
    t_phase = time.perf_counter()
    step = dense_stepper(pt, cf, fleet, consts, streams, cuda)
    entry = drain_kernel(card, cuda, step=step, mid=mid)
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
    del step
    torch.cuda.empty_cache()
    print(f"  phase D {time.perf_counter() - t_phase:.1f} s")

    # -- E. events on the compact route at I=16384 ---------------------------------
    t_phase = time.perf_counter()
    topo, net, placement, _ = fleet
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

    # -- F. the benchmarks/disruption.py grid, one sweep -----------------------------
    t_phase = time.perf_counter()
    disruption_sweep(pt, card, cuda)
    print(f"  phase F {time.perf_counter() - t_phase:.1f} s")

    return dict(entry, launches=a_launches)


# ---------------------------------------------------------------------------
# phase G: the serving path (dispatcher -> fleet -> engines -> dense decoder)
# ---------------------------------------------------------------------------

ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:13
# kernels 5 and 6 alone at the served models' widths: flash (B, Hq, Hkv, D) and decode
# (B, S, Hq, Hkv, D); flash (widths, S, dtype, causal) cases, S=300 a ragged tile
FLASH_DIMS = {"qwen2.5-32b": (1, 40, 8, 128), "zamba2-1.2b": (1, 32, 32, 64)}
FLASH_CASES = (("qwen2.5-32b", 32, "bfloat16", True), ("qwen2.5-32b", 128, "bfloat16", True),
               ("qwen2.5-32b", 300, "bfloat16", True), ("qwen2.5-32b", 512, "bfloat16", True),
               ("qwen2.5-32b", 4096, "bfloat16", True), ("qwen2.5-32b", 512, "float32", True),
               ("qwen2.5-32b", 512, "bfloat16", False), ("zamba2-1.2b", 512, "bfloat16", True),
               ("zamba2-1.2b", 544, "bfloat16", True))
# the kernels line's case: the largest served prompt
FLASH_ENTRY = ("qwen2.5-32b", 512, "bfloat16", True)
DECODE_DIMS = {"qwen2.5-32b": (4, 1024, 40, 8, 128), "zamba2-1.2b": (2, 544, 32, 32, 64)}
DECODE_ENTRY = ("qwen2.5-32b", "bfloat16")
# the device function names of kernels 5 and 6, printed wherever they rank in a profile
ATTENTION_KERNELS = ("flash_tc_kernel", "flash_simt_kernel", "decode_split_tc_kernel",
                     "decode_split_kernel", "decode_merge_kernel")


def attention_bound(nbytes, flops, dtype):
    """The least time of one call: bytes over HBM, operations over the peak
    of their type (bf16 tensor cores, or f32 outside them)."""
    import torch

    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_close(label, got, want, dtype_name):
    """|got - want| <= tol + tol * |want| everywhere (assert_allclose's rule
    with rtol = atol = tol); returns the max abs error."""
    import torch

    tol = ATT_TOL[dtype_name]
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)),
          f"{label}: kernel vs plain beyond {tol} (max_abs_err {err:.3e})")
    return err


def library_sdpa(q, k, v, **kw):
    """One ``F.scaled_dot_product_attention`` call with GQA; the yardstick of
    ``library_ms`` (never called by the port)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def flash_kernel_checks(card, cuda):
    """Kernel 5 alone against its plain version at qwen2.5-32b widths (Hq=40,
    Hkv=8, D=128) and zamba2-1.2b widths (Hq=Hkv=32, D=64), B=1: two runs
    bitwise, the route each call took (tensor cores for bf16 at D 64 and 128,
    SIMT otherwise), the device ms per call of the kernel and of SDPA (and
    their event-timed ms), the plain version's ms, the bound and the reached
    TFLOP/s. Returns the kernels line's entry (``FLASH_ENTRY``)."""
    import torch

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops as kops

    worst, entry = 0.0, None
    for widths, S, name, causal in FLASH_CASES:
        B, Hq, Hkv, D = FLASH_DIMS[widths]
        dtype = getattr(torch, name)
        g = torch.Generator(device=cuda).manual_seed(S)
        q, k, v = (torch.randn((B, h, S, D), generator=g, device=cuda).to(dtype)
                   for h in (Hq, Hkv, Hkv))
        reset_counts()
        out = kf.flash_attention_call(q, k, v, causal)
        want = kf.flash_attention_plain(q, k, v, causal)
        again = kf.flash_attention_call(q, k, v, causal)
        torch.cuda.synchronize()
        kernel_route = kf.route(dtype, D)
        label = f"flash {widths} S={S} {name} causal={causal} ({kernel_route})"
        routes = kernel_routes()["flash_attention"]
        check(routes == {r: 2 * (r == kernel_route) for r in ("tc", "simt")},
              f"{label}: routes {routes}")
        err = attention_close(label, out, want, name)
        check(torch.equal(out, again), f"{label}: two kernel runs differ")
        worst = max(worst, err)
        del want
        n = 20
        kernel = partial(kf.flash_attention_call, q, k, v, causal)
        sdpa = partial(library_sdpa, q, k, v, is_causal=causal)
        ms, event_ms = device_ms(kernel, n), time_calls(kernel, n)
        library_ms, library_event_ms = device_ms(sdpa, n), time_calls(sdpa, n)
        plain_ms = time_calls(lambda: kf.flash_attention_plain(q, k, v, causal), 3)
        elem = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem  # q, k, v in; out
        flops = 4 * B * Hq * D * S * S // (2 if causal else 1)
        bound_ms, bound_by = attention_bound(nbytes, flops, dtype)
        print(f"{label}: max_abs_err={err:.3e} (tol {ATT_TOL[name]}), two runs bitwise; device "
              f"ms per call: kernel {ms:.4f}, library (SDPA) {library_ms:.4f}; event ms per call: "
              f"kernel {event_ms:.4f}, SDPA {library_event_ms:.4f}, plain {plain_ms:.4f}; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} flops); kernel "
              f"{flops / ms / 1e9:.2f} TFLOP/s, SDPA {flops / library_ms / 1e9:.2f} [{card}]")
        if (widths, S, name, causal) == FLASH_ENTRY:
            entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         library_event_ms=library_event_ms)
        del q, k, v, out, again
        torch.cuda.empty_cache()
    # the model's (B, S, H, D) layout through kernels.ops: strided views, no copy
    B, Hq, Hkv, D = FLASH_DIMS["qwen2.5-32b"]
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 300, h, D), generator=g, device=cuda).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    got = kops.flash_attention(q, k, v, causal=True)
    want = kops.plain.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = attention_close("flash model layout B=2 S=300", got, want, "bfloat16")
    check(got.is_contiguous(), "flash model layout: the output is not contiguous")
    print(f"flash through kernels.ops, (B, S, H, D) views, B=2 S=300 (a ragged tile) bf16: "
          f"max_abs_err={err:.3e} [{card}]")
    worst = max(worst, err)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:24", "max_abs_err": worst,
            **entry}


def decode_pos_sets(B, S, L, rng):
    """The timed ``pos`` (0, S-1 and random values) and the batches that put
    every split edge of the plan's L (0, L-1, L, 2L-1, S-1) in some request."""
    timed = np.array([0, S - 1, *rng.integers(1, S - 1, B - 2)], np.int32)[:B]
    edges = [p for p in (0, L - 1, L, 2 * L - 1, S - 1) if p < S]
    edges += [S - 1] * (-len(edges) % B)
    return timed, [np.array(edges[i:i + B], np.int32) for i in range(0, len(edges), B)]


def decode_kernel_checks(card, cuda):
    """Kernel 6 alone against its plain version at qwen2.5-32b widths (B=4,
    S=1024, Hq=40, Hkv=8, D=128) and zamba2-1.2b widths (B=2, S=544,
    Hq=Hkv=32, D=64), bf16 and f32: on the timed ``pos`` and on every split
    edge of the plan (two runs bitwise each), the device ms per call of the
    kernel and of SDPA (and their event-timed ms), the plain version's ms, the
    bound and the reached GB/s. Returns the kernels line's entry
    (``DECODE_ENTRY``)."""
    import torch

    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    worst, entry = 0.0, None
    for widths, (B, S, Hq, Hkv, D) in DECODE_DIMS.items():
        L, splits = kd.decode_split_plan(B, Hkv, S, n_sm)
        pos_np, edges = decode_pos_sets(B, S, L, np.random.default_rng(0))
        pos = torch.as_tensor(pos_np, device=cuda)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            g = torch.Generator(device=cuda).manual_seed(6)
            q = torch.randn((B, Hq, D), generator=g, device=cuda).to(dtype)
            kc, vc = (torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(dtype)
                      for _ in range(2))
            kernel_route = kf.route(dtype, D)
            label = (f"decode {widths} B={B} S={S} {name} ({kernel_route}, L={L}, {splits} "
                     f"splits, {B * Hkv * splits} blocks)")
            err = 0.0
            reset_counts()
            for p_np in (pos_np, *edges):
                p = torch.as_tensor(p_np, device=cuda)
                out = kd.decode_attention_call(q, kc, vc, p)
                again = kd.decode_attention_call(q, kc, vc, p)
                torch.cuda.synchronize()
                at = f"{label} pos={p_np.tolist()}"
                err = max(err, attention_close(at, out, kd.decode_attention_plain(q, kc, vc, p),
                                               name))
                check(torch.equal(out, again), f"{at}: two kernel runs differ")
            routes = kernel_routes()["decode_attention"]
            check(routes == {r: 2 * (1 + len(edges)) * (r == kernel_route) for r in ("tc", "simt")},
                  f"{label}: routes {routes}")
            worst = max(worst, err)
            kernel = partial(kd.decode_attention_call, q, kc, vc, pos)
            # SDPA on the kernel-native layout, made outside the timing
            qs = q[:, :, None]
            ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=cuda)[None, :] <= pos[:, None].long())[:, None, None, :]
            sdpa = partial(library_sdpa, qs, ks, vs, attn_mask=mask)
            passes = {}
            ms, event_ms = device_ms(kernel, 50, passes), time_calls(kernel, 50)
            library_ms, library_event_ms = device_ms(sdpa, 50), time_calls(sdpa, 50)
            plain_ms = time_calls(lambda: kd.decode_attention_plain(q, kc, vc, pos), 10)
            elem = q.element_size()
            rows = int((pos_np.astype(np.int64) + 1).sum())
            nbytes = 2 * rows * Hkv * D * elem + 2 * q.numel() * elem + 4 * B
            flops = 4 * Hq * D * rows
            bound_ms, bound_by = attention_bound(nbytes, flops, dtype)
            print(f"{label}: max_abs_err={err:.3e} (tol {ATT_TOL[name]}) over pos "
                  f"{[pos_np.tolist(), *(e.tolist() for e in edges)]}, two runs bitwise; device "
                  f"ms per call (timed pos {pos_np.tolist()}): kernel {ms:.4f} ("
                  + ", ".join(f"{k.split('<')[0]} {v:.4f}" for k, v in passes.items())
                  + f"), library (SDPA, "
                  f"bool mask) {library_ms:.4f}; event ms per call: kernel {event_ms:.4f}, SDPA "
                  f"{library_event_ms:.4f}, plain {plain_ms:.4f}; bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes} bytes over the {rows} cache rows read, {flops} flops); "
                  f"kernel {nbytes / ms / 1e6:.1f} GB/s [{card}]")
            if (widths, name) == DECODE_ENTRY:
                entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             library_event_ms=library_event_ms)
            del q, kc, vc, ks, vs
            torch.cuda.empty_cache()
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:23", "max_abs_err": worst,
            **entry}


def timed_engine_class():
    """``ServingEngine`` that records the wall ms of each decode round and of
    each prefill (both end in a device-to-host copy of the greedy tokens,
    which waits for the device)."""
    from repro_torch.serving.engine import ServingEngine

    class TimedEngine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_ms, self.prefill_ms, self.prefill_tokens = [], [], []

        def _decode_round(self):
            t0 = time.perf_counter()
            out = super()._decode_round()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def _admit_one(self):
            plen = len(self.queue[0].tokens) if self.queue else 0
            t0 = time.perf_counter()
            admitted = super()._admit_one()
            if admitted:
                self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
                self.prefill_tokens.append(plen)
            return admitted

    return TimedEngine


def serve(cfg, model, cuda, engine_cls, recorders=False):
    """The served run: 32 requests, Poisson(1.5) per slot from numpy seed 0,
    prompts of {32, ..., 512} tokens and 16 new tokens each, routed by
    ``PotusDispatcher`` on the card over 4 ``ServingEngine`` replicas through
    a flash straggler on replica 0; until every request is done. With
    ``recorders`` the dispatcher and the fleet each get a ``FlightRecorder``
    (J4). Returns (requests, slots, fleet, dispatcher)."""
    from repro_torch.core import events as pev
    from repro_torch.obs import FlightRecorder
    from repro_torch.serving import dispatcher as pd
    from repro_torch.serving import fleet as pf
    from repro_torch.serving.engine import Request

    R = len(SERVE_RATES)
    horizon = 400
    rec = (lambda: FlightRecorder(capacity=horizon)) if recorders else (lambda: None)
    fleet = pf.ReplicaFleet([engine_cls(cfg, model, max_batch=SERVE_BATCH,
                                        max_len=SERVE_MAX_LEN, service_rate=r)
                             for r in SERVE_RATES], recorder=rec())
    disp = pd.PotusDispatcher(
        n_frontends=1, replica_hosts=np.arange(1, R + 1), frontend_hosts=np.array([0]),
        host_costs=(np.ones((R + 1, R + 1)) - np.eye(R + 1)).astype(np.float32),
        replica_rates=np.array(SERVE_RATES),
        cfg=pd.DispatcherConfig(V=1.0, gamma=16.0, tokens_per_request=float(SERVE_MAX_NEW)),
        recorder=rec(), device=cuda)
    trace = pev.flash_straggler(disp.topo, start=SERVE_STRAGGLE[0],
                                duration=SERVE_STRAGGLE[1] - SERVE_STRAGGLE[0], factor=0.25,
                                instance=disp.F).compile(disp.topo, horizon)
    rng = np.random.default_rng(0)
    waiting, reqs, t = [], [], 0
    while len(reqs) < SERVE_REQUESTS or waiting or not all(r.done for r in reqs):
        check(t < horizon, f"served run: requests still open after {horizon} slots")
        made = len(reqs) + len(waiting)
        n_new = min(int(rng.poisson(1.5)), SERVE_REQUESTS - made)
        for rid in range(made, made + n_new):
            prompt = rng.integers(0, cfg.vocab_size, int(rng.choice(SERVE_PROMPT_LENS)))
            waiting.append(Request(rid, prompt, max_new=SERVE_MAX_NEW))
        ev = (trace.mu_t[t], trace.gamma_t[t], trace.alive_t[t])
        assign = pd.integral_assign(disp.route(np.array([float(n_new)]), fleet.backlog_tokens,
                                               events_row=ev))
        for r in range(R):
            for _ in range(int(assign[0, r])):
                if waiting:
                    req = waiting.pop(0)
                    reqs.append(req)
                    fleet.dispatch(r, req)
        fleet.step(t, mu_row=trace.mu_t[t][disp.F:], alive_row=trace.alive_t[t][disp.F:])
        t += 1
    return reqs, t, fleet, disp


def teacher_forced(cfg, model, cuda, n_steps=8):
    """The kernel route against ``kernels.ops.plain`` on one replica's model:
    4 prompts prefilled into a 4-slot cache, then ``n_steps`` decode steps
    fed the same tokens (numpy seed 1). Returns max |logit diff| / max |logit|
    over all prefill and decode logits."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    rng = np.random.default_rng(1)
    plens = SERVE_PROMPT_LENS[1:]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    fed = rng.integers(0, cfg.vocab_size, (n_steps, len(plens), 1))
    logits = {}
    for name, route in (("kernel", kops), ("plain", kops.plain)):
        cache = pz.init_cache(cfg, len(plens), SERVE_MAX_LEN, cuda)
        rows = []
        for i, p in enumerate(prompts):
            tokens = torch.as_tensor(p, device=cuda)[None]
            lg, one = pz.prefill(model, cfg, {"tokens": tokens}, SERVE_MAX_LEN, ops=route)
            for key, dst in cache.items():
                dst[:, i] = one[key][:, 0]
            rows.append(lg[:, 0].float())
        pos = torch.as_tensor(plens, dtype=torch.int32, device=cuda)
        for s in range(n_steps):
            lg, cache = pz.decode_step(model, cfg, torch.as_tensor(fed[s], device=cuda), pos,
                                       cache, ops=route)
            rows.append(lg[:, 0].float())
            pos = pos + 1
        logits[name] = torch.cat(rows)
    diff = float((logits["kernel"] - logits["plain"]).abs().max())
    scale = float(logits["plain"].abs().max())
    check(np.isfinite(diff) and np.isfinite(scale) and scale > 0, "teacher-forced: not finite")
    return diff / scale, diff, scale


def serving_path(card, cuda):
    """Phase G: kernels 5 and 6 alone, then the served run of qwen2.5-32b at
    full width (``SERVE_LAYERS`` layers, bf16) behind the dispatcher, its
    checks and its numbers; its second run with a ``FlightRecorder`` on the
    dispatcher and on the fleet (J4). Returns the two kernels' entries of
    the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as pz
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    flash = flash_kernel_checks(card, cuda)
    decode = decode_kernel_checks(card, cuda)

    cfg = get_config(SERVE_ARCH).with_(n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase G model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} of 64 layers, {cfg.param_dtype}: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.2f} s [{card}]")

    # the kernel route against the plain route, teacher-forced (also the warm-up)
    rel, diff, scale = teacher_forced(cfg, model, cuda)
    print(f"teacher-forced kernel vs plain route, {SERVE_LAYERS} layers bf16, 4 prompts x 8 "
          f"decode steps: "
          f"max |dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (limit 5e-2) [{card}]")
    check(rel <= 5e-2, "teacher-forced bf16: kernel route vs plain beyond 5e-2 of max |logit|")

    # the served run, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs, slots, fleet, _ = serve(cfg, model, cuda, timed_engine_class())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, routes = read_counts(), kernel_routes()
    peak = torch.cuda.max_memory_allocated()
    rounds = sum(e.decode_rounds for e in fleet.replicas)
    tokens = fleet.tokens_served
    round_ms = np.concatenate([e.round_ms for e in fleet.replicas])
    prefill_ms = sum(sum(e.prefill_ms) for e in fleet.replicas)
    prefill_tok = sum(sum(e.prefill_tokens) for e in fleet.replicas)
    # a decode round's least time: every weight but the embedding table read once over HBM,
    # and of that table the max_batch rows it gathers (the KV cache reads are left out)
    emb = model.embed
    round_bytes = (sum(p.numel() * p.element_size() for p in model.parameters())
                   - emb.numel() * emb.element_size()
                   + SERVE_BATCH * emb.shape[1] * emb.element_size())
    round_bound_ms = round_bytes / PEAK_BYTES_S * 1e3
    print(f"served run: {len(reqs)} requests, {tokens} tokens in {slots} slots, {rounds} decode "
          f"rounds, wall {wall:.3f} s, {tokens / wall:.1f} tokens/s; decode round median "
          f"{np.median(round_ms):.3f} ms (min {round_ms.min():.3f}, max {round_ms.max():.3f}), "
          f"bound {round_bound_ms:.4f} ms ({round_bytes} weight bytes); "
          f"prefill {prefill_ms / prefill_tok:.4f} ms per prompt token ({prefill_tok} tokens); "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
    print("  launches: " + " ".join(f"{k}={v}" for k, v in n.items()) + f"; routes {routes} "
          f"[{card}]")
    want = dict(ZERO_COUNTS, flash_attention=SERVE_LAYERS * SERVE_REQUESTS,
                decode_attention=SERVE_LAYERS * rounds, potus_schedule=slots)
    check(n == want, f"served run launches {n}, expected {want}")
    check(routes == all_on_tensor_cores(n),
          f"served run: a bf16 attention launch at head_dim 128 missed the tensor cores: {routes}")
    check(len(reqs) == SERVE_REQUESTS and all(
        r.done and len(r.generated) == SERVE_MAX_NEW for r in reqs),
        "served run: a request did not finish with 16 tokens")
    check(tokens == SERVE_REQUESTS * SERVE_MAX_NEW, "served run: tokens served")
    first = {r.rid: list(r.generated) for r in reqs}

    reqs2, slots2, fleet2, disp2 = serve(cfg, model, cuda, ServingEngine, recorders=True)
    same = slots2 == slots and {r.rid: list(r.generated) for r in reqs2} == first
    print(f"  two runs give identical tokens: {same} (the second with flight recorders) "
          f"[{card}]")
    check(same, "served run: two runs differ")
    rows_d, rows_f = disp2.recorder.rows(), fleet2.recorder.rows()
    h_col = [r["h"] for r in rows_d]
    print(f"  J4 flight recorders: dispatcher {len(rows_d)} rows for {slots2} routed slots, "
          f"h column = h_history: {h_col == disp2.h_history}; fleet {len(rows_f)} rows, last "
          f"{rows_f[-1]} [{card}]")
    check(len(rows_d) == slots2 and [r["slot"] for r in rows_d] == list(range(slots2)),
          "J4: one dispatcher row per routed slot")
    check(h_col == disp2.h_history, "J4: the dispatcher rows' h differs from h_history")
    check(len(rows_f) == slots2 and rows_f[-1]["tokens_served"] == fleet2.tokens_served,
          "J4: one fleet row per slot")
    profile_run(lambda: serve(cfg, model, cuda, ServingEngine), top=10, suffix=f" [{card}]",
                also=ATTENTION_KERNELS)
    del model
    torch.cuda.empty_cache()

    # the same check at 2 layers in f32: the kernels' own error, without bf16's
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    rel, diff, scale = teacher_forced(cfg32, model32, cuda)
    print(f"teacher-forced kernel vs plain route, 2 layers f32: max |dlogit| {diff:.4e} of "
          f"max |logit| {scale:.4e} = {rel:.4e} (limit 1e-4) [{card}]")
    check(rel <= 1e-4, "teacher-forced f32: kernel route vs plain beyond 1e-4 of max |logit|")
    del model32
    torch.cuda.empty_cache()
    print(f"  phase G {time.perf_counter() - t_phase:.1f} s [{card}]")
    return [dict(flash, launches=n["flash_attention"]),
            dict(decode, launches=n["decode_attention"])]


# ---------------------------------------------------------------------------
# phase H: the SSM and hybrid models (mamba2-1.3b forward, zamba2-1.2b served)
# ---------------------------------------------------------------------------

def ssd_inputs(seed, b, T, dtype, device, H=64, P=64, S=128):
    """(x, dt, A, B, C) of ``ssd_chunked`` at mamba2-1.3b widths, in the
    model's types: x, dt, B and C in ``dtype``, A float32. dt and A follow
    Mamba2's published initialisation ranges (dt about 0.001-0.1 from a
    shifted softplus, A in [-16, -1]), so the decay spans a 256-token chunk."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(b, T, H, P).to(dtype)
    z = randn(b, T, H) - 4.0
    dt = torch.logaddexp(z, torch.zeros_like(z)).to(dtype)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=g, device=device))
    return x, dt, A, randn(b, T, S).to(dtype), randn(b, T, S).to(dtype)


def ssd_kernel_inputs(x, dt, A, B, C, chunk):
    """The kernel's arguments as ``ssd_chunked`` hands them over (the dt=0 pad,
    the chunk reshape, the float32 ``dA_cum``): caught on its kernel route."""
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.models import mamba as pm

    caught = []

    def route(*args):
        caught.append(args)
        return kss.ssd_intra_chunk_call(*args)

    y = pm.ssd_chunked(x, dt, A, B, C, chunk, ops=SimpleNamespace(ssd_intra_chunk=route))
    check(len(caught) == 1, "ssd_chunked did not take its kernel route once")
    check(tuple(y.shape) == tuple(x.shape) and bool(y.isfinite().all()),
          "ssd_chunked: the output is not finite or of the wrong shape")
    return caught[0]


def ssd_bound(args, dtype):
    """Bytes (each input read once, y_diag and the states written once) and
    operations of one call: C·Bᵀ once per (b, chunk) over the causal
    triangle, the weighted (Q, Q) x (Q, P) product per head over the triangle,
    and the (P, Q) x (Q, S) state product per head; two per multiply-add."""
    xc, dtc, dA_cum, Bc, Cc = args
    b, nc, Q, H, P = xc.shape
    S = Bc.shape[-1]
    tri = Q * (Q + 1) // 2
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + xc.numel() * xc.element_size() + b * nc * H * P * S * 4)
    flops = 2 * b * nc * (tri * S + H * tri * P + H * Q * P * S)
    return (*attention_bound(nbytes, flops, dtype), nbytes, flops)


def ssd_kernel_checks(card, cuda, chunk):
    """H1: kernel 7 alone at mamba2-1.3b widths through ``ssd_chunked``'s
    kernel route, against its plain version on the same inputs. Returns the
    kernels line's entry (the bf16 b=1 T=2048 case, the H2 forward's calls)."""
    import torch

    from repro_torch.kernels import ssd_scan as kss

    worst, entry = 0.0, None
    for b, T, name in SSD_CASES:
        dtype = getattr(torch, name)
        args = ssd_kernel_inputs(*ssd_inputs(T + b, b, T, dtype, cuda), chunk)
        y, st = kss.ssd_intra_chunk_call(*args)
        y2, st2 = kss.ssd_intra_chunk_call(*args)
        yp, sp = kss.ssd_intra_chunk_plain(*args)
        torch.cuda.synchronize()
        check(y.dtype == args[0].dtype and st.dtype == torch.float32, "ssd: output types")
        label = (f"ssd b={b} T={T} {name} (nc={args[0].shape[1]}, types "
                 f"{'/'.join(str(t.dtype).split('.')[-1] for t in args)})")
        rels, err = [], 0.0
        for got, want in ((y, yp), (st, sp)):
            d = float((got.float() - want.float()).abs().max())
            rels.append(d / max(float(want.float().abs().max()), 1e-6))
            err = max(err, d)
        check(rels[0] <= SSD_TOL[name], f"{label}: y_diag kernel vs plain {rels[0]} beyond "
              f"{SSD_TOL[name]} of max |ref|")
        check(rels[1] <= SSD_TOL["float32"], f"{label}: states kernel vs plain {rels[1]} beyond "
              f"{SSD_TOL['float32']} of max |ref|")
        check(torch.equal(y, y2) and torch.equal(st, st2), f"{label}: two kernel runs differ")
        worst = max(worst, err)
        del yp, sp
        parts = {}
        ms = device_ms(lambda: kss.ssd_intra_chunk_call(*args), 20, parts=parts)
        event_ms = time_calls(lambda: kss.ssd_intra_chunk_call(*args), 20)
        plain_ms = time_calls(lambda: kss.ssd_intra_chunk_plain(*args), 3)
        bound_ms, bound_by, nbytes, flops = ssd_bound(args, dtype)
        split = ", ".join(f"{k[:40]} {v:.4f}" for k, v in sorted(parts.items(),
                                                                 key=lambda r: -r[1]))
        print(f"{label}: y rel {rels[0]:.3e} (limit {SSD_TOL[name]}), states rel {rels[1]:.3e} "
              f"(limit {SSD_TOL['float32']}) of max |ref|, max_abs_err={err:.3e}, two runs "
              f"bitwise; device ms per call: kernel {ms:.4f} ({split}); event ms per call: "
              f"kernel {event_ms:.4f}, plain {plain_ms:.4f}; bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes} bytes, {flops} flops); library: none, no one PyTorch "
              f"call computes the block [{card}]")
        if (b, T, name) == SSD_CASES[0]:
            entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        torch.cuda.empty_cache()
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:23", "max_abs_err": worst, **entry,
            "library_ms": None}


def logit_gap(a, b):
    """max |a - b| / max |b|, both finite."""
    diff = float((a.float() - b.float()).abs().max())
    scale = float(b.float().abs().max())
    check(np.isfinite(diff) and np.isfinite(scale) and scale > 0, "logits not finite")
    return diff / scale, diff, scale


def rounded_plain(xc, dtc, dA_cum, Bc, Cc):
    """The plain version with y_diag rounded to ``xc``'s type, as the kernel
    returns it."""
    from repro_torch.kernels import ssd_scan as kss

    y, states = kss.ssd_intra_chunk_plain(xc, dtc, dA_cum, Bc, Cc)
    return y.to(xc.dtype), states


def layer_gaps(cfg, model, x, ops_a, ops_b):
    """Each Mamba2 block and each shared-attention invocation (its attention's
    output, before the residual) run by two routes from the same input
    (route b's residual stream, as teacher forcing feeds both the same
    tokens): the largest max |out_a - out_b| / max |out_b| over the Mamba2
    blocks, and over the attention invocations (0 without them)."""
    import torch

    from repro_torch.models import mamba as pm
    from repro_torch.models import model_zoo as pz

    positions = torch.arange(x.shape[1], device=x.device)
    ssm_worst = attn_worst = 0.0
    for gi, (s, e, attn_after) in enumerate(pz._hybrid_groups(cfg)):
        for block in model.blocks[s:e]:
            out_b = pm.mamba_block(block, x, cfg, ops=ops_b)
            ssm_worst = max(ssm_worst,
                            logit_gap(pm.mamba_block(block, x, cfg, ops=ops_a), out_b)[0])
            x = out_b + x
        if attn_after:
            shared = model.shared_attn[gi % cfg.n_shared_attn]
            h = shared.ln1(x)
            (out_a, _), (out_b, _) = (shared.attn(h, positions, o) for o in (ops_a, ops_b))
            attn_worst = max(attn_worst, logit_gap(out_a, out_b)[0])
            x, _ = shared(x, positions, ops_b)
    return ssm_worst, attn_worst


def ssm_forward(card, cuda):
    """H2: mamba2-1.3b at full width and depth in bf16, one forward of b=1,
    T=2048 by the kernel route (counted, timed, profiled) and by the plain
    route. Every block is held to the plain route from the same input; the
    logits' gap after 48 bf16 layers is printed, not held: a one-ulp change
    of a bf16 activation grows through the random-weight stack, which the
    plain route shows against itself when only y_diag is rounded to x's
    type, as the kernel returns it (printed beside). Then 2 layers in f32,
    held end to end. Returns the kernel route's launch count of
    ``ssd_intra_chunk``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    cfg = get_config(SSD_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase H model: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} Mamba2 layers, "
          f"H={cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} P={cfg.ssm_headdim} "
          f"S={cfg.ssm_state} chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
          f"{n_params} parameters ({n_params * 2 / 1e9:.2f} GB) [{card}]")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, SSM_T)),
                             device=cuda)
    batch = {"tokens": tokens}
    reset_counts()
    logits, _ = pz.forward(model, cfg, batch)
    torch.cuda.synchronize()
    n = read_counts()
    print(f"  forward b=1 T={SSM_T}, kernel route: launches " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f" [{card}]")
    check(n == dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers), f"H2 launches {n}")
    check(tuple(logits.shape) == (1, SSM_T, cfg.vocab_size) and bool(logits.isfinite().all()),
          "H2: logits not finite or of the wrong shape")
    reset_counts()
    plain, _ = pz.forward(model, cfg, batch, ops=kops.plain)
    torch.cuda.synchronize()
    check(read_counts() == ZERO_COUNTS, "H2: the plain route launched a kernel")
    rel, diff, scale = logit_gap(logits, plain)
    print(f"  kernel vs plain route, {cfg.n_layers} layers bf16, end to end: max |dlogit| "
          f"{diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded, not held) [{card}]")
    rounded, _ = pz.forward(model, cfg, batch, ops=SimpleNamespace(
        ssd_intra_chunk=rounded_plain))
    rel, diff, scale = logit_gap(rounded, plain)
    print(f"  plain route with y_diag rounded to x's type vs plain route, end to end: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded) [{card}]")
    del plain, rounded
    worst, _ = layer_gaps(cfg, model, model.embed[tokens], kops, kops.plain)
    print(f"  kernel vs plain route, each of the {cfg.n_layers} blocks from the same input, bf16: "
          f"largest max |dout| / max |out| {worst:.4e} (limit 5e-2) [{card}]")
    check(worst <= 5e-2, "H2 bf16: a block's kernel route beyond 5e-2 of its plain route")
    walls, issued = wall_and_issue(lambda: pz.forward(model, cfg, batch), SSM_FORWARD_RUNS)
    peak = torch.cuda.max_memory_allocated()
    print(f"  forward wall ms over {SSM_FORWARD_RUNS} runs: median {np.median(walls):.3f} (min "
          f"{walls.min():.3f}, max {walls.max():.3f}), {SSM_T / np.median(walls) * 1e3:.1f} "
          f"tokens/s; host ms to issue it: median {np.median(issued):.3f} (min "
          f"{issued.min():.3f}, max {issued.max():.3f}); peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    profile_run(lambda: pz.forward(model, cfg, batch), top=10, suffix=f" [{card}]")
    launches = n["ssd_intra_chunk"]
    del model, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    a, _ = pz.forward(model32, cfg32, batch)
    b, _ = pz.forward(model32, cfg32, batch, ops=kops.plain)
    rel, diff, scale = logit_gap(a, b)
    print(f"  kernel vs plain route, 2 layers f32: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.4e} = {rel:.4e} (limit 1e-4) [{card}]")
    check(rel <= 1e-4, "H2 f32: kernel route vs plain beyond 1e-4 of max |logit|")
    del model32, a, b
    torch.cuda.empty_cache()
    return launches


class HeldRoute:
    """An ``ops`` namespace for the model that launches each kernel through
    ``kernels.ops`` and, on every call, holds it against its plain version on
    the same arguments (the path's own shapes, layouts and caches) and
    against a second launch (bitwise). Its launches are the comparison's:
    run it outside a counted run. ``worst`` holds each kernel's largest
    error (relative to max |plain| for the SSD block, absolute for
    attention) and ``calls`` its number of held calls."""

    def __init__(self):
        self.worst, self.calls = {}, {}

    def _held(self, name, err):
        self.worst[name] = max(self.worst.get(name, 0.0), err)
        self.calls[name] = self.calls.get(name, 0) + 1

    def ssd_intra_chunk(self, *args):
        import torch

        from repro_torch.kernels import ops as kops

        y, st = kops.ssd_intra_chunk(*args)
        y2, st2 = kops.ssd_intra_chunk(*args)
        yp, sp = kops.plain.ssd_intra_chunk(*args)
        name = str(args[0].dtype).split(".")[-1]
        label = f"H3 ssd_intra_chunk {name} at {tuple(args[0].shape)}"
        check(torch.equal(y, y2) and torch.equal(st, st2), f"{label}: two kernel runs differ")
        rel_y, rel_s = (float((a.float() - b.float()).abs().max())
                        / max(float(b.float().abs().max()), 1e-6) for a, b in ((y, yp), (st, sp)))
        check(rel_y <= SSD_TOL[name] and rel_s <= SSD_TOL["float32"],
              f"{label}: kernel vs plain y {rel_y:.3e}, states {rel_s:.3e} of max |ref|")
        self._held("ssd_intra_chunk", max(rel_y, rel_s))
        return y, st

    def flash_attention(self, q, k, v, causal=True):
        import torch

        from repro_torch.kernels import ops as kops

        out = kops.flash_attention(q, k, v, causal=causal)
        name = str(q.dtype).split(".")[-1]
        label = f"H3 flash_attention {name} at {tuple(q.shape)}"
        check(torch.equal(out, kops.flash_attention(q, k, v, causal=causal)),
              f"{label}: two kernel runs differ")
        self._held("flash_attention", attention_close(
            label, out, kops.plain.flash_attention(q, k, v, causal=causal), name))
        return out

    def decode_attention(self, q, k_cache, v_cache, pos):
        import torch

        from repro_torch.kernels import ops as kops

        out = kops.decode_attention(q, k_cache, v_cache, pos)
        name = str(q.dtype).split(".")[-1]
        label = f"H3 decode_attention {name} at {tuple(k_cache.shape)} pos {pos.tolist()}"
        check(torch.equal(out, kops.decode_attention(q, k_cache, v_cache, pos)),
              f"{label}: two kernel runs differ")
        self._held("decode_attention", attention_close(
            label, out, kops.plain.decode_attention(q, k_cache, v_cache, pos), name))
        return out

    def report(self, dtype_name, card):
        import torch

        torch.cuda.synchronize()
        limits = {"ssd_intra_chunk": f"rel of max |ref| {self.worst.get('ssd_intra_chunk', 0):.3e}"
                                     f" (limit y {SSD_TOL[dtype_name]}, states 1e-5)"}
        for name in ("ssd_intra_chunk", "flash_attention", "decode_attention"):
            check(self.calls.get(name, 0) > 0, f"H3 {dtype_name}: {name} was never held")
            worst = limits.get(name, f"max_abs_err {self.worst[name]:.3e} (rtol = atol = "
                                     f"{ATT_TOL[dtype_name]})")
            print(f"  {dtype_name} generation: {name} held on each of its {self.calls[name]} "
                  f"calls against its plain version, worst {worst}, two runs bitwise [{card}]")


def hybrid_generate(cfg, model, prompts, cuda, ops=None, feed=None):
    """Greedy generation by the model's own entry points, as ``ServingEngine``
    does it (batch-1 prefills copied into the slots of one cache, then decode
    steps over both), or, with ``feed`` (B, 1 + steps), those tokens fed in
    place of the argmax (teacher forcing). On the kernel route (``ops=None``)
    the launches of each prefill and decode step are checked, on
    ``kernels.ops.plain`` that there are none. Returns (tokens (B, 1 +
    steps), logits (B, 1 + steps, V))."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    if ops is None:
        want_prefill = dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers, flash_attention=n_inv)
        want_step = dict(ZERO_COUNTS, decode_attention=n_inv)
    elif ops is kops.plain:
        want_prefill = want_step = ZERO_COUNTS
    else:
        want_prefill = want_step = None  # a held route: its launches are the comparison's
    max_len = HYBRID_MAX_LEN  # the engine's, so both runs see one cache size
    cache = pz.init_cache(cfg, len(prompts), max_len, cuda)
    rows, toks = [], []
    for i, p in enumerate(prompts):
        reset_counts()
        lg, one = pz.prefill(model, cfg, {"tokens": torch.as_tensor(p, device=cuda)[None]},
                             max_len, ops=ops)
        n = read_counts()
        check(want_prefill is None or n == want_prefill, f"H3: one prefill launched {n}")
        for key, dst in cache.items():
            dst[:, i] = one[key][:, 0]
        rows.append(lg[:, 0])
    logits = [torch.cat(rows)]
    toks.append(torch.argmax(logits[-1], dim=-1))
    pos = torch.full((len(prompts),), HYBRID_PROMPT, dtype=torch.int32, device=cuda)
    for step in range(HYBRID_STEPS):
        cur = toks[-1] if feed is None else feed[:, step]
        reset_counts()
        lg, cache = pz.decode_step(model, cfg, cur[:, None], pos, cache, ops=ops)
        n = read_counts()
        check(want_step is None or n == want_step, f"H3: one decode step launched {n}")
        logits.append(lg[:, 0])
        toks.append(torch.argmax(lg[:, 0], dim=-1))
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(logits, 1)


def handover_gap(cfg, model, prompts, toks, logits, cuda):
    """A forward over each prompt and its generated tokens against the
    prefill/decode logits at the generated positions: max |dlogit| / max
    |logit|, with the forward's launches checked."""
    import torch

    from repro_torch.models import model_zoo as pz

    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    full = torch.cat([torch.as_tensor(np.stack(prompts), device=cuda), toks[:, :-1]], dim=1)
    reset_counts()
    fwd, _ = pz.forward(model, cfg, {"tokens": full})
    check(read_counts() == dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers,
                                flash_attention=n_inv), "H3: forward launches")
    return logit_gap(fwd[:, HYBRID_PROMPT - 1:], logits)


def hybrid_served(card, cuda):
    """H3: zamba2-1.2b at full width and depth. In bf16: two prompts of 512
    tokens served by a ``ServingEngine`` (prefill each, then 16 decode
    rounds), counted and timed; the same generation by the entry points,
    whose tokens must equal the engine's; once more with every launch of
    the three kernels held against its plain version on the path's own
    arguments (``HeldRoute``); and every Mamba2 block and shared-attention
    invocation held to the plain route from the same input. In f32 (the same
    model drawn in f32): the held generation again, the kernel route against
    the plain route end to end, and the hand-over from the chunked scan to
    the recurrence (a forward over each prompt and its generated tokens
    against the prefill/decode logits at the 17 generated positions), each
    within 5e-2 of max |logit|. In bf16 the hand-over is printed, not held:
    a one-ulp change grows through the random-weight stack."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz
    from repro_torch.serving.engine import Request

    cfg = get_config(HYBRID_ARCH)
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    n_params = sum(p.numel() for p in model.parameters())
    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    print(f"phase H model: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} Mamba2 layers (S="
          f"{cfg.ssm_state}) + {cfg.n_shared_attn} shared attention blocks x {n_inv} "
          f"invocations ({cfg.n_heads} heads), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}: {n_params} parameters ({n_params * 2 / 1e9:.2f} GB) [{card}]")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, HYBRID_PROMPT) for _ in range(2)]

    eng = timed_engine_class()(cfg, model, max_batch=2, max_len=HYBRID_MAX_LEN,
                               service_rate=float(HYBRID_STEPS))
    reqs = [Request(i, p, max_new=HYBRID_STEPS + 1) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, routes = read_counts(), kernel_routes()
    print(f"  served: 2 prompts x {HYBRID_PROMPT} tokens, {eng.decode_rounds} decode rounds, "
          f"{eng.tokens_served} tokens in {wall:.3f} s; prefill "
          f"{sum(eng.prefill_ms) / sum(eng.prefill_tokens):.4f} ms per prompt token, decode "
          f"round median {np.median(eng.round_ms):.3f} ms (min {min(eng.round_ms):.3f}, max "
          f"{max(eng.round_ms):.3f}) [{card}]")
    print("  launches: " + " ".join(f"{k}={v}" for k, v in n.items()) + f"; routes {routes} "
          f"[{card}]")
    want = dict(ZERO_COUNTS, ssd_intra_chunk=2 * cfg.n_layers, flash_attention=2 * n_inv,
                decode_attention=HYBRID_STEPS * n_inv)
    check(n == want, f"H3 served launches {n}, expected {want}")
    check(routes == all_on_tensor_cores(n),
          f"H3: a bf16 attention launch at head_dim 64 missed the tensor cores: {routes}")
    check(all(r.done and len(r.generated) == HYBRID_STEPS + 1 for r in reqs),
          "H3: a request did not finish")
    served = [list(r.generated) for r in reqs]
    # the served run holds the process's first zamba2 prefills, with their first-use costs:
    # time each prompt's prefill again, warm
    pre, issued = [], []
    for p in prompts:
        batch = {"tokens": torch.as_tensor(p, device=cuda)[None]}
        w, i = wall_and_issue(lambda: pz.prefill(model, cfg, batch, HYBRID_MAX_LEN),
                              HYBRID_PREFILL_RUNS)
        pre.append(w / HYBRID_PROMPT)
        issued.append(i / HYBRID_PROMPT)
    pre, issued = np.concatenate(pre), np.concatenate(issued)
    print(f"  warm prefill over {len(pre)} runs: median {np.median(pre):.4f} ms per prompt token "
          f"(min {pre.min():.4f}, max {pre.max():.4f}); host ms per token to issue it: median "
          f"{np.median(issued):.4f} (min {issued.min():.4f}, max {issued.max():.4f}) [{card}]")

    toks, logits = hybrid_generate(cfg, model, prompts, cuda)
    same = served == toks.tolist()
    print(f"  the entry points give the engine's tokens: {same} [{card}]")
    check(same, "H3: two runs give different tokens")
    rel, diff, scale = handover_gap(cfg, model, prompts, toks, logits, cuda)
    print(f"  forward vs prefill/decode at the {HYBRID_STEPS + 1} generated positions, bf16: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded, not held) "
          f"[{card}]")
    held = HeldRoute()
    toks, _ = hybrid_generate(cfg, model, prompts, cuda, ops=held)
    held.report("bfloat16", card)
    check(served == toks.tolist(), "H3: the held route gives other tokens")
    x = model.embed[torch.as_tensor(prompts[0], device=cuda)[None]]
    ssm_worst, attn_worst = layer_gaps(cfg, model, x, kops, kops.plain)
    print(f"  kernel vs plain route from the same input, bf16: largest max |dout| / max |out| "
          f"{ssm_worst:.4e} over the {cfg.n_layers} Mamba2 blocks, {attn_worst:.4e} over the "
          f"{n_inv} attention invocations (limit 5e-2) [{card}]")
    check(max(ssm_worst, attn_worst) <= 5e-2,
          "H3 bf16: a block's kernel route beyond 5e-2 of its plain route")
    del model, eng, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    held = HeldRoute()
    toks, logits = hybrid_generate(cfg32, model32, prompts, cuda, ops=held)
    held.report("float32", card)
    ptoks, plain = hybrid_generate(cfg32, model32, prompts, cuda, ops=kops.plain, feed=toks)
    rel, diff, scale = logit_gap(logits, plain)
    print(f"  kernel vs plain route, prefill and {HYBRID_STEPS} decode steps fed the kernel "
          f"route's tokens, end to end, f32: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.4e} = {rel:.4e} (limit 5e-2); argmax tokens equal: "
          f"{bool(torch.equal(toks, ptoks))} [{card}]")
    check(rel <= 5e-2, "H3 f32: kernel route vs plain beyond 5e-2 of max |logit|")
    rel, diff, scale = handover_gap(cfg32, model32, prompts, toks, logits, cuda)
    print(f"  forward vs prefill/decode at the {HYBRID_STEPS + 1} generated positions, f32: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (limit 5e-2) [{card}]")
    check(rel <= 5e-2, "H3: forward vs prefill/decode beyond 5e-2 of max |logit|")
    del model32, logits, plain
    torch.cuda.empty_cache()


def ssm_path(card, cuda):
    """Phase H: kernel 7 alone (H1), the mamba2-1.3b forward (H2), zamba2-1.2b
    served (H3). Returns kernel 7's entry of the kernels line."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    entry = ssd_kernel_checks(card, cuda, get_config(SSD_ARCH).ssm_chunk)
    launches = ssm_forward(card, cuda)
    hybrid_served(card, cuda)
    torch.cuda.empty_cache()
    print(f"  phase H {time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(entry, launches=launches)


# ---------------------------------------------------------------------------
# phase F and phase I: scenario sweeps (core/sweep.py, run_fused_sweep)
# ---------------------------------------------------------------------------

def cpu_run(name):
    """The port's run on the CPU that phase F or I3 holds the card against:
    ``transient`` (phase F's W=2 scenarios), ``fig6ab`` or ``fig5`` (I3);
    returns (sweep, wall s). It runs after the card's run it is held
    against, so no timed phase runs beside it."""
    import torch

    import benchmarks.torch_figures as tf

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the paper profile's tensors are tiny
    try:
        if name == "transient":
            grid = tf.transient_grid("cpu", T=300, windows=(2,))
            return grid[6], grid[7]
        if name == "fig6ab":
            return tf.fig6ab_sweep("cpu")[3:]
        return tf.fig5_sweep("fat-tree", "cpu")[3:]
    finally:
        torch.set_num_threads(threads)


def disruption_sweep(pt, card, cuda):
    """Phase F: ``benchmarks/disruption.py``'s grid (potus and shuffle x W
    (0, 2, 6) x events (none, a k-failure), T=300 on the paper profile) as
    one ``run_sweep`` through ``benchmarks/torch_figures.py``; the W=2
    scenarios held against the port on the CPU, the rows printed beside
    ``BENCH_disruption.json`` (recorded, not checked)."""
    import torch

    import benchmarks.torch_figures as tf

    grid = tf.transient_grid(cuda, T=300)
    _, T, t_fail, dur, scen, Ws, sw, wall = grid
    torch.cuda.synchronize()
    print(f"phase F: one sweep of {len(sw)} scenarios in {sw.n_batches} partitions, T={T}, "
          f"{scen.name}: wall {wall:.3f} s [{card}]")
    cpu = cpu_run("transient")[0]
    for (scn, a) in sw.select(window=2):
        b = cpu.result(scheduler=scn.scheduler, window=2, events=scn.events)
        hold_card_vs_cpu(f"phase F {scn.scheduler} W=2 events={scn.events}", scn.scheduler, a,
                         b)
    bench = {(r["scheduler"], r["W"]): r for r in json.loads(
        (ROOT / "BENCH_disruption.json").read_text())["rows"] if r["section"] == "disruption"}
    for sched in ("potus", "shuffle"):
        for W in Ws:
            hurt = sw.result(scheduler=sched, window=W, events="kfail")
            got = dict(resp_transient=float(hurt.avg_response),
                       peak_backlog=float(hurt.backlog[t_fail:t_fail + dur + 10].max()),
                       recovery_slots=tf.recovery_slots(hurt.backlog, t_fail, t_fail + dur),
                       resp_degradation=tf.degradation(sw, sched, W))
            check(all(np.isfinite(v) for v in got.values()), f"phase F {sched} W={W}: not finite")
            ref = bench[(sched, W)]
            print(f"  disruption {sched} W={W}: " + ", ".join(
                f"{name} {v:.3f} (BENCH_disruption.json {ref[name]}, rel "
                f"{rel_diff(v, ref[name]):.3f})" for name, v in got.items()) + f" [{card}]")
    for row in tf.disruption_rows(grid):
        print(f"  {row.csv()}")


class HeldSlotRoute:
    """An ``ops`` namespace for the fused engine's compact partitions that
    launches the slot kernel through ``kernels.ops`` and holds every call,
    bitwise, against the plain version on the same batched arguments.
    ``calls`` counts the held calls."""

    def __init__(self):
        self.calls = 0

    def potus_slot_step(self, *args, **kw):
        import torch

        from repro_torch.kernels import ops as kops

        s_k, m_k = kops.potus_slot_step(*args, **kw)
        s_p, m_p = kops.plain.potus_slot_step(*args, **kw)
        same = (all(torch.equal(x, y) for x, y in zip(s_k, s_p))
                and all(torch.equal(x, y) for x, y in zip(m_k, m_p)))
        check(same, f"I2: a batched slot-kernel call (N={s_k[0].shape[0]}) differs from the "
              "batched plain version")
        self.calls += 1
        return s_k, m_k


SWEEP_V, SWEEP_W = (1.0, 2.0, 5.0, 10.0), (0, 4)


def sweep_path(card, cuda, fleet=None):
    """Phase I, scenario sweeps: I1 the I=16384 fleet's V x W grid through
    ``run_sweep(engine="cohort-fused")`` (2 partitions of N=4 sharing one
    arrival stream), each scenario bitwise against its own ``simulate``,
    the kernel's launches per partition, two runs, the sweep's and a loop of
    ``simulate``'s wall in turns, the busy share, kernel 1 at N=4 and N=1;
    I2 the dyadic system's sweep (potus, shuffle, jsq) bitwise against the
    CPU and every batched call against the batched plain version; I3 the
    paper profile's Fig. 6ab grid (one partition of N=28, stacked streams)
    and Fig. 5's V x W grid on the scan engine, held against the CPU at the
    chaos floor (the CPU's runs made after the card's). Returns kernel 1's
    batched entry for the kernels line."""
    import torch

    import benchmarks.torch_figures as tf
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    # -- I1. the fleet, I=16384 ------------------------------------------------------
    t_phase = time.perf_counter()
    topo, net, placement, arr = fleet if fleet is not None else fleet_system(pt, FLEET_I, FLEET_T)
    spec = pt.SweepSpec(V=SWEEP_V, window=SWEEP_W, scheduler="potus", use_pallas=True)
    opts = {"age_cap": FLEET_AGE_CAP}

    def sweep():
        return pt.run_sweep(topo, net, placement, arr, FLEET_T, spec, engine="cohort-fused",
                            engine_opts=opts, device=cuda)

    def simulate(scn):
        return pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                         T=FLEET_T, scheduler="potus", V=scn.V,
                                         window=scn.window, age_cap=FLEET_AGE_CAP,
                                         device="cuda"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    sw1 = sweep()
    torch.cuda.synchronize()
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_part = len(SWEEP_W)
    print(f"I1: sweep of {len(sw1)} scenarios (V {SWEEP_V} x W {SWEEP_W}) on the fleet "
          f"I={FLEET_I} T={FLEET_T}: n_batches={sw1.n_batches}, launches " + " ".join(
              f"{k}={v}" for k, v in n.items()) + f"; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    check(sw1.n_batches == n_part, f"I1: {sw1.n_batches} partitions, expected {n_part}")
    # each partition's kernel runs T calls, as one scenario's run does, not N x T
    check(n == dict(ZERO_COUNTS, potus_slot=n_part * FLEET_T), f"I1 launches {n}")
    sweep_launches = n["potus_slot"]
    sw2 = sweep()
    same = all(same_result(a, b) for (_, a), (_, b) in zip(sw1, sw2))
    print(f"  two runs bitwise identical: {same}")
    check(same, "I1: two sweeps differ")
    loop = [simulate(scn) for scn in sw1.scenarios]
    for (scn, res), one in zip(sw1, loop):
        check(same_result(res, one) and res.completed_mass > 0 and np.isfinite(res.avg_response),
              f"I1: scenario V={scn.V} W={scn.window} differs from its own simulate")
    print(f"  each of the {len(sw1)} scenarios bitwise equal to its own simulate: True; "
          + ", ".join(f"V={scn.V:g} W={scn.window}: avg_backlog {r.avg_backlog:.3f} "
                      f"avg_response {r.avg_response:.4f}" for scn, r in sw1))
    walls = {"sweep": [], "loop": []}
    for _ in range(3):
        for name, fn in (("sweep", sweep), ("loop", lambda: [simulate(scn)
                                                             for scn in sw1.scenarios])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    slots = len(sw1) * FLEET_T
    med = {k: float(np.median(v)) for k, v in walls.items()}
    for name, label in (("sweep", "the sweep"), ("loop", f"a loop of {len(sw1)} simulate")):
        print(f"  wall s of {label}, in turns: median {med[name]:.4f} "
              f"({', '.join(f'{w:.4f}' for w in walls[name])}); {slots / med[name]:.1f} "
              f"scenario-slots/s [{card}]")
    print(f"  sweep against the loop: {med['loop'] / med['sweep']:.3f}x (recorded) [{card}]")
    busy_ms, prof_ms = profile_run(sweep, top=6)

    # kernel 1 alone at N=4 (the V grid at W=4, shared stream) and N=1, from slot 64
    consts, state0, streams, one = batch_inputs(cf, (topo, net, placement, arr), FLEET_T,
                                                FLEET_W, list(SWEEP_V), [1.0] * len(SWEEP_V),
                                                FLEET_AGE_CAP, cuda, stacked=False)
    mid = run_slots(ps.potus_slot_call, consts, state0, streams, 8, "potus", FLEET_AGE_CAP,
                    T=64)[0]
    args = (consts, mid, *(x[64:65] for x in streams), 64)
    kw = dict(scheduler="potus", age_cap=FLEET_AGE_CAP, n_slots=1)
    s_k, m_k = ps.potus_slot_call(*args, **kw)
    s_p, m_p = ps.potus_slot_step_plain(*args, **kw)
    err = max_abs(s_k, torch.stack(m_k), s_p, torch.stack(m_p))
    check(err == 0.0, f"one batched call (N={len(SWEEP_V)}) at I={FLEET_I}: kernel vs plain "
          f"max_abs_err={err}")
    c1 = one[1][0]  # V=2: the main path's scenario
    args1 = (c1, tuple(x[1].contiguous() for x in mid), *(x[64:65] for x in streams), 64)
    s_1, m_1 = ps.potus_slot_call(*args1, **kw)
    check(all(torch.equal(x, y[1]) for x, y in zip(s_1, s_k))
          and all(torch.equal(x, y[1]) for x, y in zip(m_1, m_k)),
          "scenario 1 of the batched call differs from its own call")
    parts4, parts1 = {}, {}
    ms4 = device_ms(lambda: ps.potus_slot_call(*args, **kw), 50, parts=parts4)
    ms1 = device_ms(lambda: ps.potus_slot_call(*args1, **kw), 50, parts=parts1)
    ev4 = time_calls(lambda: ps.potus_slot_call(*args, **kw), 50)
    ev1 = time_calls(lambda: ps.potus_slot_call(*args1, **kw), 50)
    plain_ms = time_calls(lambda: ps.potus_slot_step_plain(*args, **kw), 5)
    N = len(SWEEP_V)
    nbytes, nops = bytes_and_ops(consts, mid, 1, stacked=False)
    bound_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S else "operations"
    print(f"one batched call at I={FLEET_I}, N={N}, K=1: max_abs_err={err:.3e}, scenario 1 "
          f"bitwise its own call; device ms per call: N={N} {ms4:.4f}, N=1 {ms1:.4f} (same "
          f"process); event ms per call: N={N} {ev4:.4f}, N=1 {ev1:.4f}, plain N={N} "
          f"{plain_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes: the state "
          f"in and out and the metrics {N} times, the constants and the shared (1, I, C) "
          f"arrival streams once; {nops} ops) [{card}]")
    def bare(parts):  # a call of N > 1 runs the <true> instances, of one the <false>
        return {name.removeprefix("void ").split("<")[0]: ms for name, ms in parts.items()}

    parts1 = bare(parts1)
    for name, ms in sorted(bare(parts4).items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: N={N} {ms:.4f}, N=1 {parts1.get(name, float('nan')):.4f} ms "
              "per call")
    del consts, state0, streams, one, mid, args, args1, s_k, s_p, s_1
    torch.cuda.empty_cache()
    print(f"  I1 {time.perf_counter() - t_phase:.1f} s")

    # -- I2. the dyadic system: card = CPU bitwise, each batched call = plain -----------
    t_phase = time.perf_counter()
    T_d = 40
    dtopo, dnet, dplace, darr = dyadic_system(pt, T_d + 8, 2)
    rng = np.random.default_rng(9)
    dpred = (darr * 2.0 ** rng.integers(-1, 2, size=darr.shape)).astype(np.float32)
    arrs = {"a": darr, "mis": (darr, dpred)}
    dspec = pt.SweepSpec(V=(1.0, 2.0), beta=0.5, window=(0, 2),
                         scheduler=("potus", "shuffle", "jsq"), arrival=("a", "mis"),
                         use_pallas=True)
    dopts = dict(age_cap=16, warmup=8, drain_margin=12)
    card_sw = pt.run_sweep(dtopo, dnet, dplace, arrs, T_d, dspec, engine="cohort-fused",
                           engine_opts=dopts, device=cuda)
    cpu_sw = pt.run_sweep(dtopo, dnet, dplace, arrs, T_d, dspec, engine="cohort-fused",
                          engine_opts=dopts, device="cpu")
    check(card_sw.n_batches == cpu_sw.n_batches == 6, "I2: partitions")
    check(all(same_result(a, b) and a.completed_mass > 0 for (_, a), (_, b)
              in zip(card_sw, cpu_sw)), "I2: the card's sweep differs from the CPU's")
    held = HeldSlotRoute()
    arr_map = {"a": (darr, None), "mis": (darr, dpred)}
    held_res, _ = cf.run_fused_sweep(dtopo, dnet, dplace, arr_map, T_d, dspec, device=cuda,
                                     ops=held, **dopts)
    check(held.calls == 6 * T_d and all(same_result(a, b) for a, (_, b)
                                        in zip(held_res, card_sw)), "I2: held route")
    print(f"I2: dyadic sweep of {len(card_sw)} scenarios (potus, shuffle, jsq x W (0, 2) x V "
          f"(1, 2) x arrivals (one mis-predicted), 6 partitions of N=4, T={T_d}): card equals "
          f"CPU bitwise; {held.calls} batched kernel calls each bitwise equal to the batched "
          f"plain version")
    print(f"  I2 {time.perf_counter() - t_phase:.1f} s")

    # -- I3. the paper profile: Fig. 6ab and Fig. 5 against the CPU at the chaos floor ---
    t_phase = time.perf_counter()
    _, p_arr, preds, sw6, wall6 = tf.fig6ab_sweep(cuda)
    sw6c, wall6c = cpu_run("fig6ab")
    check(sw6.n_batches == 1 and len(sw6) == len(tf.FIG6AB_VS) * len(preds), "I3: Fig. 6ab grid")
    worst = {}
    for (scn, a), (_, b) in zip(sw6, sw6c):
        for f in ("avg_backlog", "avg_cost", "avg_response"):
            worst[f] = max(worst.get(f, 0.0), rel_diff(getattr(a, f), getattr(b, f)))
    print(f"I3: Fig. 6ab grid, one partition of N={len(sw6)} with stacked streams, T="
          f"{tf.T_COHORT}, age_cap {tf.AGE_CAP['fig6ab']}: card {wall6:.3f} s, CPU {wall6c:.3f} "
          f"s (one thread); worst card vs CPU rel diff of the means " + ", ".join(
              f"{f} {v:.3e}" for f, v in worst.items()) + f" [{card}]")
    check(worst["avg_response"] <= 0.10 and worst["avg_backlog"] <= 0.10
          and worst["avg_cost"] <= 0.02, "I3 Fig. 6ab: beyond the chaos floor")
    for row in tf.fig6ab_rows(p_arr, preds, sw6, wall6):
        print(f"  card {row.csv()}")
    for row in tf.fig6ab_rows(p_arr, preds, sw6c, wall6c):
        print(f"  CPU  {row.csv()}")
    sys5, arr5, _, sw5, wall5 = tf.fig5_sweep("fat-tree", cuda)
    sw5c, wall5c = cpu_run("fig5")
    worst = {}
    for (scn, a), (_, b) in zip(sw5, sw5c):
        check(np.isfinite(a.backlog).all() and a.backlog.shape == (tf.T_SIM,), "I3 Fig. 5")
        for f in ("avg_backlog", "avg_cost"):
            worst[f] = max(worst.get(f, 0.0), rel_diff(getattr(a, f), getattr(b, f)))
    print(f"I3: Fig. 5 grid on the scan engine, {len(sw5)} scenarios in {sw5.n_batches} "
          f"partitions, T={tf.T_SIM}: card {wall5:.3f} s, CPU {wall5c:.3f} s; worst card vs CPU "
          f"rel diff of the means " + ", ".join(f"{f} {v:.3e}" for f, v in worst.items())
          + f" [{card}]")
    check(worst["avg_backlog"] <= 0.10 and worst["avg_cost"] <= 0.02,
          "I3 Fig. 5: beyond the chaos floor")
    shuffle5 = tf._run_jax(sys5, arr5, tf.T_SIM, pt.SimConfig(V=1.0, scheduler="shuffle"), cuda)
    for row in tf.fig5_rows("fat-tree", sw5, shuffle5, wall5):
        print(f"  card {row.csv()}")
    print(f"  I3 {time.perf_counter() - t_phase:.1f} s")
    return {"N": N, "ms": ms4, "event_ms": ev4, "n1_ms": ms1, "n1_event_ms": ev1,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "sweep_launches": sweep_launches, "sweep_wall_s": med["sweep"],
            "loop_wall_s": med["loop"], "busy_share": busy_ms / prof_ms if busy_ms else None}


# ---------------------------------------------------------------------------
# phase J: observability — metric streams, span tracing, the obs dump
# ---------------------------------------------------------------------------

OBS_T = 40  # J1's horizon on the dyadic system


def frames_equal(a, b) -> bool:
    """Two ``MetricsFrame``s hold the same streams bitwise, but for the
    dispatch entropy (a log), within rel 1e-6."""
    if list(a.streams) != list(b.streams):
        return False
    for name, x in a.streams.items():
        y = b.streams[name]
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if name == "dispatch":
            if not (np.array_equal(x[:, 0], y[:, 0]) and rel_diff(x[:, 1], y[:, 1]) <= 1e-6):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def same_scan(a, b) -> bool:
    """Two scan-engine results with the same per-slot series and final
    state, bitwise."""
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in SERIES) and all(
        np.array_equal(getattr(a.final_state, f.name), getattr(b.final_state, f.name))
        for f in dataclasses.fields(a.final_state))


def streams_finite(frame) -> bool:
    return all(np.isfinite(x).all() for x in frame.streams.values())


def obs_launches(engine, scheduler, T):
    """The kernel launches of a metrics-on run: the streams change no route
    but the compact ``cohort-fused`` one (no slot kernel)."""
    if scheduler == "potus-loop":
        return dict(ZERO_COUNTS, potus_price=T,
                    **({"cohort_drain": T} if engine == "cohort-fused" else {}))
    if engine == "jax" and scheduler == "potus":
        return dict(ZERO_COUNTS, potus_schedule=T)
    return dict(ZERO_COUNTS)


def obs_dyadic(pt, cf, cuda):
    """J1: on the dyadic system (every sum exact), each engine x scheduler
    with every stream its engine serves, and a k-failure on
    ``cohort-fused``: the card's streams equal the port's on the CPU
    (entropy within rel 1e-6), metrics on leave the trajectories bitwise as
    off, the launches are the metrics-off routes' (``potus_slot=0`` on the
    compact ``cohort-fused`` route), and a compact ``cohort-fused`` run with
    metrics equals the plain route and the kernel route bitwise."""
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import ENGINE_STREAMS

    W = 2
    topo, net, placement, arr = dyadic_system(pt, OBS_T + 13, W)
    # the instances phase E's dyadic k-failure takes (rng seed 1): every split stays dyadic
    kfail = pt.k_failures(topo, 2, start=10, duration=12,
                          rng=np.random.default_rng(1)).compile(topo, OBS_T)
    cases = [(e, s, None) for e in ("jax", "cohort-fused")
             for s in ("potus", "shuffle", "jsq", "potus-loop")]
    cases.append(("cohort-fused", "potus", kfail))
    kw = {"jax": {}, "cohort-fused": dict(age_cap=32, warmup=10, drain_margin=10)}
    for engine, sched, ev in cases:
        label = f"J1 {engine} {sched}" + (" k-failure" if ev is not None else "")
        spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=OBS_T,
                             engine=engine, scheduler=sched, V=2.0, beta=0.5, window=W,
                             events=ev, metrics=tuple(sorted(ENGINE_STREAMS[engine])),
                             device="cuda", **kw[engine])
        reset_counts()
        on = pt.simulate(spec)
        n = read_counts()
        off = pt.simulate(dataclasses.replace(spec, metrics=None))
        cpu = pt.simulate(dataclasses.replace(spec, device="cpu"))
        same = same_scan if engine == "jax" else same_result
        ent = rel_diff(on.metrics.streams["dispatch"][:, 1], cpu.metrics.streams["dispatch"][:, 1])
        extra = ""
        check(n == obs_launches(engine, sched, OBS_T), f"{label}: launches {n}")
        check(frames_equal(on.metrics, cpu.metrics), f"{label}: the card's streams differ from "
              "the CPU's")
        check(same(on, off) and same(on, cpu), f"{label}: metrics on changed the trajectory, or "
              "the card's differs from the CPU's")
        check(off.metrics is None and on.metrics.n_slots == OBS_T and streams_finite(on.metrics),
              f"{label}: frame")
        if engine == "cohort-fused" and sched != "potus-loop" and ev is None:
            plain = cf._run_cohort_fused_impl(topo, net, placement, arr, None, OBS_T,
                                              spec.config(), device=cuda, ops=kops.plain,
                                              **kw[engine])
            check(same_result(on, plain), f"{label}: the metrics-on run differs from the plain "
                  "route")
            extra = ", = plain route, = kernel route"
        print(f"{label}: {len(on.metrics.streams)} streams, launches " + (" ".join(
            f"{k}={v}" for k, v in n.items() if v) or "none") + f" (potus_slot={n['potus_slot']}); "
              f"card = CPU bitwise (entropy rel {ent:.2e}); metrics on = off bitwise" + extra)


def obs_fleet(pt, cf, card, cuda, fleet):
    """J2: the I=16384 fleet, T=128, with metrics on: path 2 (kernel 2 once
    a slot, the trajectory bitwise as off, the backlog stream = the result's
    backlog) and the compact ``cohort-fused`` run with every fused stream
    (no slot kernel; = the plain route bitwise, the kernel route within
    compare_cohort's tolerances), each timed in turns with its metrics-off
    path, the streams finite, the peak device memory."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.obs import ENGINE_STREAMS

    topo, net, placement, arr = fleet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def turns(label, spec_off, spec_on):
        """Runs metrics on, off, off, on, each timed; returns the first on
        run (launches counted) and the first off run."""
        walls, runs = {"off": [], "on": []}, {}
        for k, which in enumerate(("on", "off", "off", "on")):
            if k == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pt.simulate(spec_on if which == "on" else spec_off)
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3 / FLEET_T)
            runs.setdefault(which, res)
            if k == 0:
                runs["n"] = read_counts()
        print(f"  {label} wall ms/slot in turns (on, off, off, on): on " + ", ".join(
            f"{w:.4f}" for w in walls["on"]) + "; off " + ", ".join(
            f"{w:.4f}" for w in walls["off"]) + f"; medians off {np.median(walls['off']):.4f}, "
              f"on {np.median(walls['on']):.4f} [{card}]")
        return runs["on"], runs["off"], runs["n"]

    # -- path 2 with metrics on
    spec2 = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                          engine="jax", scheduler="potus", V=FLEET_V, window=FLEET_W,
                          device="cuda")
    on, off, n = turns("path 2", spec2, dataclasses.replace(spec2, metrics=True))
    print(f"J2 path 2 (engine=jax potus I={FLEET_I} T={FLEET_T}) metrics on: launches " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; {len(on.metrics.streams)} streams; "
          f"= metrics off bitwise: {same_scan(on, off)}; backlog stream = backlog: "
          f"{np.array_equal(on.metrics.streams['backlog'][:, 0], on.backlog)} [{card}]")
    check(n == dict(ZERO_COUNTS, potus_schedule=FLEET_T), f"J2 path 2 launches {n}")
    check(same_scan(on, off), "J2 path 2: metrics on changed the trajectory")
    check(np.array_equal(on.metrics.streams["backlog"][:, 0], on.backlog),
          "J2 path 2: the backlog stream is not the result's backlog")
    check(streams_finite(on.metrics), "J2 path 2: a stream is not finite")
    del on, off
    torch.cuda.empty_cache()

    # -- cohort-fused potus with every fused stream: the compact step, not the slot kernel
    spec1 = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                          scheduler="potus", V=FLEET_V, window=FLEET_W, age_cap=FLEET_AGE_CAP,
                          device="cuda")
    on, off, n = turns("cohort-fused potus (off = path 1, the slot kernel)", spec1,
                       dataclasses.replace(spec1,
                                           metrics=tuple(sorted(ENGINE_STREAMS["cohort-fused"]))))
    cfg = spec1.config()
    plain = cf._run_cohort_fused_impl(topo, net, placement, arr, None, FLEET_T, cfg,
                                      age_cap=FLEET_AGE_CAP, device=cuda, ops=kops.plain)
    print(f"J2 cohort-fused potus I={FLEET_I} T={FLEET_T} metrics on: route compact_slot_step "
          f"(the slot kernel computes no streams), launches " + " ".join(
              f"{k}={v}" for k, v in n.items()) + f"; {len(on.metrics.streams)} streams; "
          f"= plain route bitwise: {same_result(on, plain)} [{card}]")
    check(n == ZERO_COUNTS, f"J2 cohort-fused metrics on launched a kernel: {n}")
    check(same_result(on, plain), "J2 cohort-fused: metrics on differs from the plain route")
    check(np.array_equal(on.metrics.streams["backlog"][:, 0], on.backlog)
          and streams_finite(on.metrics), "J2 cohort-fused: streams")
    compare_cohort("J2 metrics on vs kernel route", cf, pt, fleet, FLEET_T, cfg, cuda,
                   against="kernel", kernel=on, other=off, age_cap=FLEET_AGE_CAP)
    peak = torch.cuda.max_memory_allocated()
    print(f"  J2 peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def obs_dump(pt, card, cuda):
    """J3: ``benchmarks/torch_figures.py``'s metrics dump on the card at the
    QUICK sizes with tracing on, read back by ``tools/obs_report.py
    --recovery`` in a process of its own (stdlib only): its peak-backlog and
    recovery slots are the ones the result's backlog gives (rounded to the
    dump's 6 decimals); the Chrome trace holds the chunk spans; and a
    ``torch.profiler`` trace of traced runs lists the span names."""
    import torch

    import benchmarks.torch_figures as tf
    from repro_torch.obs import disable_tracing, enable_tracing

    with tempfile.TemporaryDirectory() as tmp:
        res, obs_file, trace_file, t0, dur, wall = tf.dump_obs(
            cuda, obs_path=str(Path(tmp) / "OBS_disruption_torch.json"),
            trace_path=str(Path(tmp) / "TRACE_disruption_torch.json"))
        frame = res.metrics
        check(len(frame.streams) == len(tf.OBS_STREAMS) and streams_finite(frame)
              and np.array_equal(frame.streams["backlog"][:, 0], res.backlog),
              "J3: the dump's streams")
        report = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_report.py"), obs_file,
                                 "--recovery"], capture_output=True, text=True, check=True,
                                timeout=60).stdout
        story = dict(line.split() for line in report.split("recovery story")[1].splitlines()[1:]
                     if line.strip())
        want = tf.recovery_story(np.asarray(res.backlog, np.float64).round(6))
        spans = [e["name"] for e in json.loads(Path(trace_file).read_text())["traceEvents"]]
    got = (int(story["peak_backlog_slot"]), int(story["recovery_slot"]))
    print(f"J3 obs dump: {frame.n_slots} slots x {len(frame.streams)} streams, run {wall:.3f} s; "
          f"tools/obs_report.py --recovery: peak_backlog_slot {got[0]}, recovery_slot {got[1]} "
          f"(from the result's backlog: {want[0]}, {want[1]}; the failure at slot {t0} for "
          f"{dur}; the bench's recovery_slots "
          f"{tf.recovery_slots(res.backlog, t0, t0 + dur)}); Chrome trace: {len(spans)} spans "
          f"{sorted(set(spans))} [{card}]")
    check(got == want, "J3: obs_report's recovery story differs from the result's backlog")
    check("potus/cohort-fused/chunk" in spans, "J3: no chunk span in the Chrome trace")

    topo, net, placement, arr = dyadic_system(pt, OBS_T + 13, 2)
    tracer = enable_tracing()
    tracer.clear()
    try:
        # the spans are host ranges: a trace of the host's activity lists them
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for engine in ("jax", "cohort-fused"):
                pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                          T=OBS_T, engine=engine, window=2, chunk=8,
                                          metrics=True, device="cuda"))
            torch.cuda.synchronize()
    finally:
        disable_tracing()
    keys = {e.key for e in prof.key_averages()}
    names = {"potus/jax/problem-build", "potus/jax/chunk", "potus/cohort-fused/chunk"}
    print(f"  torch.profiler trace of two traced runs lists the spans {sorted(names & keys)}; "
          f"the tracer holds {len(tracer)} spans")
    check(names <= keys, f"J3: the profiler trace lacks spans {sorted(names - keys)}")


def obs_path(card, cuda, fleet=None):
    """Phase J, observability: J1 (:func:`obs_dyadic`), J2 (:func:`obs_fleet`)
    and J3 (:func:`obs_dump`); J4 runs in phase G. Builds the fleet when
    called alone."""
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf

    t0 = time.perf_counter()
    obs_dyadic(pt, cf, cuda)
    print(f"  J1 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs_fleet(pt, cf, card, cuda, fleet if fleet is not None
              else fleet_system(pt, FLEET_I, FLEET_T))
    print(f"  J2 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs_dump(pt, card, cuda)
    print(f"  J3 {time.perf_counter() - t0:.1f} s")


def slot_kernel(card, cuda):
    """Section 2: the slot kernel against its plain version on the card: the
    dyadic system bitwise (potus, shuffle, jsq; K=1 and 8), the I=16384
    fleet's metrics and two runs, and one call at the main path's shapes,
    held bitwise and timed. Returns the fleet, its constants, streams and
    mid-run state, and the kernel's row of the kernels line (its
    ``launches`` filled in by :func:`main_path`)."""
    import torch

    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

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

    fleet, consts, state0, streams = fleet_inputs(pt, cf, cuda)
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
    mid = fleet_mid(ps, consts, state0, streams)
    one = tuple(x[64:65] for x in streams)
    args = (consts, mid, *one, 64)
    kw = dict(scheduler="potus", age_cap=FLEET_AGE_CAP, n_slots=1)
    s_k, m_k = ps.potus_slot_call(*args, **kw)
    s_p, m_p = ps.potus_slot_step_plain(*args, **kw)
    one_err = max_abs(s_k, torch.stack(m_k), s_p, torch.stack(m_p))
    # every output (state and metrics) bitwise, as on every run so far at these shapes
    check(one_err == 0.0, f"one call at I={FLEET_I}: kernel vs plain max_abs_err={one_err}")
    slot_parts = {}
    ms_kernel = device_ms(lambda: ps.potus_slot_call(*args, **kw), 50, parts=slot_parts)
    event_ms = time_calls(lambda: ps.potus_slot_call(*args, **kw), 50)
    ms_plain = time_calls(lambda: ps.potus_slot_step_plain(*args, **kw), 10)
    nbytes, nops = bytes_and_ops(consts, mid, 1)
    bound_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S else "operations"
    print(f"one call at I={FLEET_I}: max_abs_err={one_err:.3e} device ms per call: kernel "
          f"{ms_kernel:.4f}; event ms per call: kernel {event_ms:.4f}, plain {ms_plain:.4f}; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {nops} ops) [{card}]")
    for name, ms in sorted(slot_parts.items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: {ms:.4f} ms per call")
    row = {"name": "potus_slot", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/potus_slot.cu",
           "replaces": "src/repro/kernels/potus_slot.py:57", "launches": None,
           "max_abs_err": one_err, "ms": ms_kernel, "event_ms": event_ms, "plain_ms": ms_plain,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return SimpleNamespace(fleet=fleet, consts=consts, streams=streams, mid=mid, row=row)


def main_path(fleet, card):
    """Section 3: main path 1, ``simulate`` on the I=16384 fleet through the
    cohort-fused engine's slot kernel: launches counted (one per slot), two
    runs bitwise, the result finite, wall ms/slot over five runs and a
    profiled run's device busy share. Returns the kernel's launches."""
    import torch

    import repro_torch.core as pt

    topo, net, placement, arr = fleet
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
    return main_launches


def card_setup():
    """TF32 off for cuBLAS and cuDNN; prints and returns the card's name and
    power limit (``nvidia-smi``) and the device. A section called alone
    (``slot_kernel``, ``main_path``, ``drain_kernel``, ``ssm_path``) starts
    with this and :func:`build_kernels`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card, torch.device("cuda")


def build_kernels(names=KERNELS):
    """One ``nvcc`` per ``csrc/<kernel>.cu``, all started together."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    print("kernel build: " + ", ".join(f"{k} {_build.BUILD_SECONDS[k]:.2f} s" for k in names)
          + f" (wall {time.perf_counter() - t0:.2f} s, in parallel)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf

    # -- 1. the card ---------------------------------------------------------
    card, cuda = card_setup()
    build_kernels()
    return run_phases(pt, cf, card, cuda)


def run_phases(pt, cf, card, cuda) -> int:
    """Every phase in order, then the kernels line and the last line."""
    import torch

    # -- 2. kernel against plain version on the card, 3. the main path ----------
    slot = slot_kernel(card, cuda)
    slot.row["launches"] = main_path(slot.fleet, card)

    for sched in ("potus", "shuffle", "jsq"):
        compare_cohort("fleet", cf, pt, slot.fleet, FLEET_T,
                       pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler=sched), cuda,
                       age_cap=FLEET_AGE_CAP)
    compare_cohort("paper", cf, pt, paper_system(pt, 300), 300,
                   pt.SimConfig(V=2.0, window=2, scheduler="potus"), cuda, age_cap=64)

    # -- 4. the fused cohort engine's dense route and events route: phases A-F ------
    drain_kernel = cohort_dense(pt, card, cuda, slot.fleet, slot.consts, slot.mid, slot.streams)

    # -- 5. the plain scan engine: kernels 2 and 3, main path 2 --------------------
    scan_kernels = scan_engine(pt, card, cuda)

    # -- 6. phase G: the serving path, kernels 5 and 6 ------------------------------
    attention_kernels = serving_path(card, cuda)

    # -- 7. phase H: the SSM and hybrid models, kernel 7 ----------------------------
    ssd_kernel = ssm_path(card, cuda)

    # -- 8. phase I: scenario sweeps, kernel 1 batched over the scenarios --------------
    t_phase = time.perf_counter()
    slot.row["batched"] = sweep_path(card, cuda, slot.fleet)
    print(f"  phase I {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- 9. phase J: observability (kernels 2, 3, 4 with metrics on; J4 ran in phase G) ----
    t_phase = time.perf_counter()
    obs_path(card, cuda, slot.fleet)
    print(f"  phase J {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- 10. the kernels line, 11. the last line ---------------------------------
    print(json.dumps({"kernels": [slot.row, *scan_kernels, drain_kernel, *attention_kernels,
                                  ssd_kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
