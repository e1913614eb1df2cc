"""The port's scenario sweeps (``repro_torch.core.run_sweep``) against the
reference's ``repro.core.sweep.run_sweep`` on the same numpy inputs.

* Grid order, ``n_batches`` and the spec's checks equal the reference's.
* Dyadic tier (the system of ``tests/test_cohort_fused.py``): every sum is
  exact in f32, so each scenario's ``backlog``, ``comm_cost`` and response
  statistics equal the reference's bitwise — on ``engine="cohort-fused"``
  (the reference with ``use_pallas=True``, its Pallas kernels in interpret
  mode as ``tests/test_sweep.py`` runs them) for potus, shuffle, jsq and
  potus-loop, across V, window, shared, stacked and mis-predicted arrivals
  and the ``events`` axis (none / a k-failure), with ``chunk=`` and
  ``slots_per_launch=``; and on ``engine="jax"`` for the four schedulers.
* Paper profile (the ``small_system`` of ``tests/conftest.py``): POTUS and
  JSQ part from the reference through price near-ties (DESIGN.md §8), so
  long-run means are held at the chaos floor of
  ``tests/test_cohort_fused.py::TestPotusPaperSystem``.
* ``init_state_batch``, ``stacked_host_traces`` and the batched plain slot
  step; ``sharded`` on a world of one (each scenario the dense sweep's,
  bitwise) and ``engine="cohort"``, which runs each scenario in turn; the
  rows of
  ``benchmarks/torch_figures.py`` and its imports.
"""
import ast
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro.core import queues as rq
from repro.core import simulator as rsim
from repro_torch.core import queues as pq
from repro_torch.core import simulator as psim

from test_torch_engine import _dyadic, _paper, _pow2_arrivals

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T = 48
OPTS = dict(age_cap=32, warmup=8, drain_margin=16)


def _kfail(mod, topo):
    # the two picks of seed 1 fall in parallelism-2 components: the even split
    # stays exact while they are down (tests/test_torch_cohort_events.py)
    return mod.k_failures(topo, 2, start=12, duration=16, rng=np.random.default_rng(1))


def _arrivals(topo):
    a = _pow2_arrivals(topo, T + 16, seed=3)
    b = _pow2_arrivals(topo, T + 16, seed=5)
    pred = _pow2_arrivals(topo, T + 16, seed=9)
    return {"a": a, "b": b, "mis": (a, pred)}


def _sweeps(spec_kw, engine, opts=None, arrival_keys=None, events=True):
    """The same grid through both packages on the dyadic system."""
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    arrs = _arrivals(ref_sys[0])
    if arrival_keys is not None:
        arrs = {k: arrs[k] for k in arrival_keys}
    out = []
    for mod, sys_, kw in ((rc, ref_sys, {}), (pt, port_sys, {"device": "cpu"})):
        ev = {"kfail": _kfail(mod, sys_[0])} if events else None
        spec = mod.SweepSpec(**spec_kw)
        out.append(mod.run_sweep(sys_[0], sys_[1], sys_[2], arrs, T, spec, engine=engine,
                                 engine_opts=opts, events=ev, **kw))
    return out


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y or (math.isnan(x) and math.isnan(y)), f


COHORT_FIELDS = ("backlog", "comm_cost", "avg_response", "p95_response", "completed_mass",
                 "saturated_frac", "n_cohorts")
SIM_FIELDS = ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total")


def _assert_grid(ref, port, fields):
    assert port.n_batches == ref.n_batches
    assert [dataclass_tuple(s) for s in port.scenarios] == [dataclass_tuple(s)
                                                            for s in ref.scenarios]
    for (_, r), (_, p) in zip(ref, port):
        _same(p, r, fields)


def dataclass_tuple(scn):
    return (scn.index, scn.V, scn.beta, scn.window, scn.scheduler, scn.arrival,
            scn.use_pallas, scn.sharded, scn.events)


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(V=(1.0, 2.0), beta=(0.5,), window=(0, 3), scheduler=("potus", "shuffle"),
         arrival=("a", "b")),
    dict(V=2.0, window=1, scheduler="jsq", events=("none", "kfail")),
    dict(V=[1, 5], beta=np.array([0.5, 1.0]), use_pallas=True),
])
def test_grid_order_equals_reference(kw):
    ref, port = rc.SweepSpec(**kw), pt.SweepSpec(**kw)
    assert port.n_scenarios == ref.n_scenarios == len(port.scenarios())
    assert [dataclass_tuple(s) for s in port.scenarios()] == [dataclass_tuple(s)
                                                              for s in ref.scenarios()]
    assert [s.config().__dict__ for s in port.scenarios()] == [
        s.config().__dict__ for s in ref.scenarios()]


@pytest.mark.parametrize("flag", ["use_pallas", "sharded"])
def test_single_flags_are_not_axes(flag):
    for mod in (rc, pt):
        with pytest.raises(TypeError):
            mod.SweepSpec(**{flag: (False, True)})


def test_missing_names_and_ambiguous_result_raise():
    topo, net, placement = _dyadic(pt)
    arr = _pow2_arrivals(topo, T + 16, seed=3)
    with pytest.raises(KeyError):
        pt.run_sweep(topo, net, placement, {"a": arr}, T, pt.SweepSpec(arrival=("a", "x")),
                     device="cpu")
    with pytest.raises(KeyError):
        pt.run_sweep(topo, net, placement, arr, T, pt.SweepSpec(events=("none", "x")),
                     device="cpu")
    sw = pt.run_sweep(topo, net, placement, arr, 8, pt.SweepSpec(V=(1.0, 3.0), window=(0, 1)),
                      device="cpu")
    assert len(sw.select(window=1)) == 2
    assert sw.result(window=1, V=3.0).backlog.shape == (8,)
    with pytest.raises(KeyError):
        sw.result(window=1)


@pytest.mark.parametrize("what", ["cohort", "metrics", "sharded"])
def test_not_ported_yet_raises(what):
    topo, net, placement = _dyadic(pt)
    arr = _pow2_arrivals(topo, T + 16, seed=3)
    if what == "sharded":  # ported: on a world of one each scenario equals the dense sweep's
        spec = pt.SweepSpec(V=(1.0, 2.0), scheduler=("potus", "jsq"))
        dense = pt.run_sweep(topo, net, placement, arr, 8, spec, engine="cohort-fused",
                             device="cpu")
        shard = pt.run_sweep(topo, net, placement, arr, 8, dataclasses.replace(
            spec, sharded=True), engine="cohort-fused", device="cpu")
        assert shard.n_batches == dense.n_batches == 2
        for (_, a), (_, b) in zip(dense, shard):
            np.testing.assert_array_equal(a.backlog, b.backlog)
            np.testing.assert_array_equal(a.comm_cost, b.comm_cost)
        with pytest.raises(pt.UnsupportedEngineOption, match="'sharded'"):
            pt.run_sweep(topo, net, placement, arr, 8, pt.SweepSpec(sharded=True),
                         engine="cohort", device="cpu")
        return
    # the event loop (module item 4) is ported: its sweep runs every scenario
    # in turn, one partition each, with metric streams on request
    opts = {"metrics": ("backlog",)} if what == "metrics" else {}
    spec = pt.SweepSpec(V=(1.0, 2.0), window=(0, 1))
    sw = pt.run_sweep(topo, net, placement, arr, 8, spec, engine="cohort", engine_opts=opts,
                      device="cpu")
    assert len(sw) == sw.n_batches == 4
    for scn, res in sw:
        one = pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                        T=8, engine="cohort", V=scn.V, window=scn.window,
                                        device="cpu", **opts))
        np.testing.assert_array_equal(res.backlog, one.backlog)
        np.testing.assert_array_equal(res.comm_cost, one.comm_cost)
        if what == "metrics":
            np.testing.assert_array_equal(res.metrics.streams["backlog"][:, 0], res.backlog)
        else:
            assert res.metrics is None


def test_reference_option_checks_hold():
    """``mu`` with a cohort engine, an option of another engine, and a
    mis-predicted arrival on the scan engine raise as in the reference."""
    topo, net, placement = _dyadic(pt)
    arrs = _arrivals(topo)
    with pytest.raises(pt.UnsupportedEngineOption):
        pt.run_sweep(topo, net, placement, arrs["a"], 8, pt.SweepSpec(), mu=topo.inst_mu,
                     engine="cohort-fused", device="cpu")
    with pytest.raises(pt.UnsupportedEngineOption):
        pt.run_sweep(topo, net, placement, arrs["a"], 8, pt.SweepSpec(),
                     engine_opts={"age_cap": 16}, device="cpu")
    with pytest.raises(pt.UnsupportedEngineOption):
        pt.run_sweep(topo, net, placement, arrs, 8, pt.SweepSpec(arrival=("mis",)),
                     device="cpu")
    with pytest.raises(ValueError):
        pt.run_sweep(topo, net, placement, arrs["a"], 8, pt.SweepSpec(),
                     engine_opts={"chunk": 0}, device="cpu")


def test_sweep_defaults_to_cuda_and_never_falls_back():
    topo, net, placement = _dyadic(pt)
    arr = _pow2_arrivals(topo, T + 16, seed=3)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for engine in ("jax", "cohort-fused"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.run_sweep(topo, net, placement, arr, 8, pt.SweepSpec(), engine=engine)


# ---------------------------------------------------------------------------
# the dyadic tier: bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler,windows", [("potus", (0, 2)), ("shuffle", (2,)),
                                               ("jsq", (2,)), ("potus-loop", (2,))])
def test_cohort_fused_dyadic_bitwise(scheduler, windows):
    """V x window x stacked arrivals (one mis-predicted) x events: a
    partition of 4 scenarios per window and events-or-not, each scenario
    bitwise (one window for the schedulers the slot kernel does not take in
    the reference, to keep the reference's compiles few)."""
    ref, port = _sweeps(dict(V=(1.0, 2.0), beta=0.5, window=windows, scheduler=scheduler,
                             arrival=("a", "mis"), events=("none", "kfail"), use_pallas=True),
                        "cohort-fused", OPTS)
    assert port.n_batches == 2 * len(windows)
    _assert_grid(ref, port, COHORT_FIELDS)


@pytest.mark.parametrize("chunk,K", [(None, 4), (16, 2)])
def test_cohort_fused_shared_stream_chunk_and_slots_per_launch(chunk, K):
    """One shared arrival stream (copied to the device once a chunk), V x
    beta in one partition, with chunk= and slots_per_launch=."""
    ref, port = _sweeps(dict(V=(1.0, 2.0, 4.0), beta=(0.5, 1.0), window=2,
                             scheduler=("potus", "jsq"), arrival="a", use_pallas=True),
                        "cohort-fused", dict(OPTS, chunk=chunk, slots_per_launch=K),
                        arrival_keys=("a",), events=False)
    assert port.n_batches == 2
    _assert_grid(ref, port, COHORT_FIELDS)


def test_cohort_fused_sweep_equals_simulate_per_scenario():
    topo, net, placement = _dyadic(pt)
    arrs = _arrivals(topo)
    spec = pt.SweepSpec(V=(1.0, 2.0), window=(0, 2), arrival=("a", "b"), scheduler="potus")
    sw = pt.run_sweep(topo, net, placement, arrs, T, spec, engine="cohort-fused",
                      engine_opts=OPTS, device="cpu")
    for scn, res in sw:
        one = pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement,
                                        arrivals=arrs[scn.arrival], T=T, V=scn.V,
                                        window=scn.window, device="cpu", **OPTS))
        _same(res, one, COHORT_FIELDS)


@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq", "potus-loop"])
def test_jax_engine_dyadic_bitwise(scheduler):
    ref, port = _sweeps(dict(V=(1.0, 2.0), beta=0.5, window=2, scheduler=scheduler,
                             arrival=("a", "b"), events=("none", "kfail")),
                        "jax", {"chunk": 20})
    assert port.n_batches == 2
    _assert_grid(ref, port, SIM_FIELDS)
    for (_, r), (_, p) in zip(ref, port):
        for f in ("q_in", "q_rem", "q_out_bolt", "transit"):
            np.testing.assert_array_equal(getattr(p.final_state, f),
                                          np.asarray(getattr(r.final_state, f)))


# ---------------------------------------------------------------------------
# the paper profile: means at the chaos floor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["cohort-fused", "jax"])
def test_paper_profile_means_within_chaos_floor(engine):
    ref_sys, port_sys = _paper(rc), _paper(pt)
    arr = ref_sys[3]
    spec_kw = dict(V=(1.0, 5.0), window=2, scheduler=("potus", "shuffle"))
    opts = {"age_cap": 64} if engine == "cohort-fused" else None
    ref = rc.run_sweep(*ref_sys[:3], arr, 120, rc.SweepSpec(**spec_kw), engine=engine,
                       engine_opts=opts)
    port = pt.run_sweep(*port_sys[:3], arr, 120, pt.SweepSpec(**spec_kw), engine=engine,
                        engine_opts=opts, device="cpu")
    assert port.n_batches == ref.n_batches == 2
    for (scn, r), (_, p) in zip(ref, port):
        # tests/test_cohort_fused.py::TestPotusPaperSystem: backlog and response 10%, cost 2%
        assert p.avg_backlog == pytest.approx(r.avg_backlog, rel=0.10), scn
        assert p.avg_cost == pytest.approx(r.avg_cost, rel=0.02), scn
        if engine == "cohort-fused":
            assert p.avg_response == pytest.approx(r.avg_response, rel=0.10), scn


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------

def test_init_state_batch_equals_reference():
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    W = 2
    prefixes = np.stack([_pow2_arrivals(ref_sys[0], W + 1, seed=s) for s in (3, 4, 5)])
    ref = rq.init_state_batch(ref_sys[0], W, prefixes)
    port = pq.init_state_batch(port_sys[0], W, prefixes, device="cpu")
    for f in ("q_in", "q_rem", "q_out_bolt", "transit"):
        x = getattr(port, f)
        assert x.shape[0] == 3 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("names", [("k", "k", "k"), ("k", "r", "k")])
def test_stacked_host_traces_equal_reference(names):
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    out = []
    for mod, sim, topo in ((rc, rsim, ref_sys[0]), (pt, psim, port_sys[0])):
        traces = {"none": None, "k": _kfail(mod, topo).compile(topo, T),
                  "r": mod.rolling_restart(topo, start=4, down_slots=6,
                                           stagger=3).compile(topo, T)}
        out.append(sim.stacked_host_traces(list(names), [traces[n] for n in names], T))
    (ref, ref_shared), (port, port_shared) = out
    assert port_shared == ref_shared == (len(set(names)) == 1)
    for x, y in zip(port, ref):
        assert x.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("stacked", [False, True])
def test_batched_plain_slot_step_equals_one_scenario_calls(stacked):
    """The plain version of the batched slot kernel: each scenario of a
    batch, bitwise, equals its own call (V, beta, state and streams)."""
    import chip_smoke
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import potus_slot as ps

    Tn, W, age_cap = 16, 2, 16
    sys_ = chip_smoke.dyadic_system(pt, Tn, W)
    consts, state, streams, one = chip_smoke.batch_inputs(
        cf, sys_, Tn, W, [2.0, 1.0, 4.0], [0.5, 1.0, 0.25], age_cap, "cpu", stacked)
    for scheduler in ("potus", "shuffle", "jsq"):
        s_b, m_b = chip_smoke.run_slots(kops.potus_slot_step, consts, state, streams, 4,
                                        scheduler, age_cap)
        assert m_b.shape == (4, 3, Tn)
        for n, (c_n, st_n, xs_n) in enumerate(one):
            s_1, m_1 = chip_smoke.run_slots(ps.potus_slot_step_plain, c_n, st_n, xs_n, 1,
                                            scheduler, age_cap)
            for x, y in zip(s_1 + (m_1,), tuple(b[n] for b in s_b) + (m_b[:, n],)):
                assert torch.equal(x, y)
    with pytest.raises(ValueError, match="potus_slot_call launches a CUDA kernel"):
        ps.potus_slot_call(consts, state, *(x[..., :1, :, :] for x in streams), 0,
                           age_cap=age_cap)


# ---------------------------------------------------------------------------
# benchmarks/torch_figures.py
# ---------------------------------------------------------------------------

FIGURES = ROOT / "benchmarks" / "torch_figures.py"


def test_figures_module_imports_neither_jax_nor_repro():
    tree = ast.parse(FIGURES.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "argparse", "dataclasses", "json", "os", "sys", "time",
                     "numpy", "repro_torch"}, names
    code = ("import sys, benchmarks.torch_figures; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, check=True).stdout.strip()
    assert got == "[]"


def test_figures_rows_csv_schema_at_smoke_size(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               REPRO_BENCH_SMOKE="1", OMP_NUM_THREADS="1")
    out = tmp_path / "rows.json"
    proc = subprocess.run([sys.executable, "-m", "benchmarks.torch_figures", "fig6c",
                           "disruption", "--device", "cpu", "--json", str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT, check=True)
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = []
    for line in lines[1:]:
        name, us, derived = line.split(",", 2)
        assert float(us) >= 0 and "=" in derived
        names.append(name)
    assert [n for n in names if n.startswith("fig6c/")] == [
        "fig6c/perfect", "fig6c/all-true-negative", "fig6c/false-positive-10",
        "fig6c/false-positive-20", "fig6c/false-positive-30"]
    assert {f"disruption/{s}/W{W}" for s in ("potus", "shuffle") for W in (0, 2, 6)} <= set(names)
    import json

    payload = json.loads(out.read_text())
    assert payload["schema"] == "repro-bench/v2"
    assert {r["engine"] for r in payload["rows"]} == {"torch-cohort-fused"}
    for row in payload["rows"]:
        assert {"section", "engine", "scheduler", "I", "T", "wall_s", "speedup",
                "scenario"} <= set(row)
