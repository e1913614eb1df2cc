"""The port's serving layer against the JAX reference (DESIGN.md §10).

* ``ServingEngine``: the port's engine generates the reference engine's
  tokens exactly on the same weights and prompts (the cases of
  ``tests/test_serving.py``), slot by slot;
* ``PotusDispatcher.route``: the same (F, R) assignments, h(t) and admission
  backlog as the reference for potus, potus-loop, shuffle and jsq, with and
  without an events row, slot by slot over a SimReplica fleet;
* a port ``SimReplica`` fleet driven by the port's dispatcher equals the
  port's fused cohort engine with ``service=`` bitwise (the pattern of
  ``tests/test_serving_fleet.py``);
* ``integral_assign`` and ``ServiceCredit`` equal the reference's;
* the whole path — dispatcher, model-backed fleet, engines, a straggler —
  gives the reference's tokens and routing (``examples/serving_demo.py``
  at a small size);
* the entry points refuse a missing card unless given ``device="cpu"``.

Everything runs on the CPU: the port's attention takes the plain versions of
its kernels, and the reference's model runs with ``use_pallas=False``.
"""
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.core import events as rev
from repro.models import model_zoo as rz
from repro.serving import dispatcher as rd
from repro.serving import engine as re
from repro.serving import fleet as rf
from repro_torch import convert
from repro_torch.configs import get_config as pget
from repro_torch.core import EngineSpec, simulate
from repro_torch.core import events as pev
from repro_torch.models import model_zoo as pz
from repro_torch.serving import dispatcher as pd
from repro_torch.serving import engine as pe
from repro_torch.serving import fleet as pf

TPR = 4.0  # tokens per request (power of two)
RATES_TOK = np.array([8.0, 8.0, 4.0, 4.0], np.float32)  # replica tokens/slot
T = 48


@pytest.fixture(scope="module")
def small_model():
    """The reduced internvl2 text decoder of ``tests/test_serving.py``, the
    reference's weights in both packages."""
    rcfg = rget("internvl2_1b").reduced().with_(frontend=None)
    pcfg = pget("internvl2_1b").reduced().with_(frontend=None)
    params = rz.init(jax.random.PRNGKey(0), rcfg)
    model = pz.init(pcfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(convert.model_params_from_numpy(pcfg, jax.tree.map(np.asarray, params)))
    return rcfg, params, pcfg, model


def _engines(small_model, **kw):
    rcfg, params, pcfg, model = small_model
    return re.ServingEngine(rcfg, params, **kw), pe.ServingEngine(pcfg, model, **kw)


def _same_steps(ref_eng, port_eng, n_slots, rates=None):
    """Step both engines ``n_slots`` times; every slot's emitted tokens and
    the dispatcher-facing metrics must be equal. Returns the emissions."""
    out = []
    for t in range(n_slots):
        rate = None if rates is None else rates[t]
        a, b = ref_eng.step(rate=rate), port_eng.step(rate=rate)
        assert b == a, f"slot {t}"
        assert port_eng.backlog_tokens == ref_eng.backlog_tokens
        assert port_eng.n_free_slots == ref_eng.n_free_slots
        out.append(b)
    assert port_eng.tokens_served == ref_eng.tokens_served
    return out


def test_engine_matches_reference_recycling_slots(small_model):
    """More requests than slots: admission, decode and recycling give the
    reference's tokens slot by slot."""
    ref_eng, port_eng = _engines(small_model, max_batch=2, max_len=48)
    rng = np.random.default_rng(0)
    for rid in range(4):
        prompt = rng.integers(0, small_model[0].vocab_size, 8)
        ref_eng.submit(re.Request(rid, prompt, max_new=5))
        port_eng.submit(pe.Request(rid, prompt, max_new=5))
    emitted = _same_steps(ref_eng, port_eng, 14)
    assert sum(len(e) for e in emitted) == 20
    assert port_eng.n_free_slots == 2 and port_eng.backlog_tokens == 0
    assert port_eng.decode_rounds > 0


def test_engine_matches_reference_and_its_own_forward(small_model):
    """The engine's greedy decode equals the reference engine's and argmax
    decoding with the port's full forward."""
    rcfg, params, pcfg, model = small_model
    prompt = np.random.default_rng(1).integers(0, rcfg.vocab_size, 8)
    seq, want = list(prompt), []
    for _ in range(4):
        logits, _ = pz.forward(model, pcfg, {"tokens": torch.tensor([seq])})
        want.append(int(torch.argmax(logits[0, -1])))
        seq.append(want[-1])
    ref_eng, port_eng = _engines(small_model, max_batch=1, max_len=32)
    r_ref, r_port = re.Request(1, prompt, max_new=4), pe.Request(1, prompt, max_new=4)
    ref_eng.submit(r_ref)
    port_eng.submit(r_port)
    _same_steps(ref_eng, port_eng, 6)
    assert r_port.done and r_port.generated == r_ref.generated == want


def test_engine_fractional_rate_and_max_len(small_model):
    """service_rate=0.5 and per-slot rate overrides (an event trace's mu row)
    decode on the reference's slots; a request that reaches max_len - 1
    stops there, as in the reference."""
    ref_eng, port_eng = _engines(small_model, max_batch=2, max_len=12, service_rate=0.5)
    rng = np.random.default_rng(2)
    for rid, (plen, max_new) in enumerate([(6, 8), (4, 3), (5, 2)]):
        prompt = rng.integers(0, small_model[0].vocab_size, plen)
        ref_eng.submit(re.Request(rid, prompt, max_new=max_new))
        port_eng.submit(pe.Request(rid, prompt, max_new=max_new))
    rates = [None] * 6 + [0.0, 0.25, 1.75, 2.0] + [None] * 10
    _same_steps(ref_eng, port_eng, len(rates), rates)
    assert port_eng._credit.fractional == ref_eng._credit.fractional
    assert port_eng.backlog_tokens == 0


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def _dispatchers(scheduler="potus", V=0.5, beta=1.0, gamma=64.0, window=0, sharded=False):
    """F=1 frontend + R=4 heterogeneous replicas on 5 hosts, hop-count U
    (``tests/test_serving_fleet.py:_make_dispatcher``), in both packages."""
    R = len(RATES_TOK)
    host_costs = np.ones((1 + R, 1 + R), np.float32) - np.eye(1 + R, dtype=np.float32)
    args = dict(n_frontends=1, replica_hosts=np.arange(1, 1 + R), frontend_hosts=np.array([0]),
                host_costs=host_costs, replica_rates=RATES_TOK)
    kw = dict(V=V, beta=beta, gamma=gamma, window=window, tokens_per_request=TPR,
              scheduler=scheduler, sharded=sharded)
    return (rd.PotusDispatcher(**args, cfg=rd.DispatcherConfig(**kw)),
            pd.PotusDispatcher(**args, cfg=pd.DispatcherConfig(**kw), device="cpu"))


def _arrivals(seed, n=T):
    return np.random.default_rng(seed).integers(0, 8, size=(n, 1)).astype(np.float32)


def _scenario(pkg):
    return pkg.FleetScenario(
        (pkg.FleetEvent("failure", 10, 22, instances=(1, 3)),
         pkg.FleetEvent("straggler", 26, 34, instances=(2,), factor=0.25)),
        name="k2+straggler")


def _drive(disp, fleet_mod, arrivals, trace):
    """``tests/test_serving_fleet.py:_run_fleet``: the dispatcher over a
    SimReplica fleet; returns the per-slot assignments."""
    F = disp.F
    fleet = fleet_mod.ReplicaFleet([fleet_mod.SimReplica(float(r), max_batch=1 << 20)
                                    for r in RATES_TOK])
    assigns = []
    for t in range(len(arrivals)):
        ev_row = mu_row = alive_row = None
        if trace is not None:
            ev_row = (trace.mu_t[t], trace.gamma_t[t], trace.alive_t[t])
            mu_row, alive_row = trace.mu_t[t][F:], trace.alive_t[t][F:]
        assign = disp.route(arrivals[t], fleet.backlog_tokens, events_row=ev_row)
        assigns.append(assign)
        for r in range(len(fleet)):
            mass = float(assign[:, r].sum())
            if mass > 0.0:
                fleet.dispatch(r, fleet_mod.FleetRequest(rid=t * 10 + r, tokens=mass * TPR,
                                                         submitted=t))
        fleet.step(t, mu_row=mu_row, alive_row=alive_row)
    return np.stack(assigns), fleet


@pytest.mark.parametrize("events", [False, True])
@pytest.mark.parametrize("scheduler", ["potus", "potus-loop", "shuffle", "jsq"])
def test_dispatcher_route_matches_reference(scheduler, events):
    ref_disp, port_disp = _dispatchers(scheduler=scheduler, window=2 if events else 0)
    arrivals = _arrivals(12)
    trace = None
    if events:
        trace = _scenario(pev).compile(port_disp.topo, T)
        ref_trace = _scenario(rev).compile(ref_disp.topo, T)
        for name in ("mu_t", "gamma_t", "alive_t"):
            assert np.array_equal(getattr(trace, name), getattr(ref_trace, name))
        predicted = np.random.default_rng(5).integers(0, 4, (1, 3)).astype(np.float32)
        for d in (ref_disp, port_disp):  # the same predicted window; route() edits it
            d.observe_prediction(predicted.copy())
    a_ref, f_ref = _drive(ref_disp, rf, arrivals, trace)
    a_port, f_port = _drive(port_disp, pf, arrivals, trace)
    assert np.array_equal(a_port, a_ref)
    assert np.array_equal(np.asarray(port_disp.h_history), np.asarray(ref_disp.h_history))
    assert np.array_equal(port_disp.pending, ref_disp.pending)
    assert port_disp.comm_cost_total == ref_disp.comm_cost_total
    assert np.array_equal(f_port.backlog_tokens, f_ref.backlog_tokens)
    assert a_port.sum() > 0


def test_dispatcher_without_a_card_and_sharded():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pd.PotusDispatcher(1, np.arange(1, 3), np.array([0]),
                               np.zeros((3, 3), np.float32), np.array([1.0, 1.0]))
    # DispatcherConfig(sharded=True) routes through sharded_schedule_batch on a
    # world of one: the reference's sharded route and the port's dense route
    ref_disp, port_disp = _dispatchers(sharded=True, window=2)
    _, dense_disp = _dispatchers(window=2)
    trace = _scenario(pev).compile(port_disp.topo, T)
    arrivals = _arrivals(12)
    a_ref, _ = _drive(ref_disp, rf, arrivals, trace)
    a_port, f_port = _drive(port_disp, pf, arrivals, trace)
    a_dense, f_dense = _drive(dense_disp, pf, arrivals, trace)
    assert np.array_equal(a_port, a_ref) and np.array_equal(a_port, a_dense)
    assert port_disp.h_history == dense_disp.h_history
    assert np.array_equal(f_port.backlog_tokens, f_dense.backlog_tokens)
    assert a_port.sum() > 0
    with pytest.raises(ValueError, match="Algorithm 1 only"):
        pd.PotusDispatcher(1, np.arange(1, 3), np.array([0]), np.zeros((3, 3), np.float32),
                           np.array([1.0, 1.0]),
                           cfg=pd.DispatcherConfig(scheduler="jsq", sharded=True), device="cpu")


# ---------------------------------------------------------------------------
# fleet vs the port's fused engine (bitwise on the dyadic configuration)
# ---------------------------------------------------------------------------

def _run_fused(disp, arrivals, trace=None, scheduler="potus"):
    """The same trace on the port's fused cohort engine: requests/slot at the
    spout, token rates and ``service=TPR`` at the replicas."""
    I, C, F = disp.topo.n_instances, disp.topo.n_components, disp.F
    act = np.zeros((len(arrivals), I, C), np.float32)
    act[:, 0, 1] = arrivals[:, 0]
    service = np.ones(I, np.float32)
    service[F:] = TPR
    res = simulate(EngineSpec(
        topo=disp.topo, net=disp.net, placement=disp.prob.inst_container.numpy(), arrivals=act,
        T=len(arrivals), engine="cohort-fused", scheduler=scheduler, V=disp.cfg.V,
        beta=disp.cfg.beta, window=disp.cfg.window, warmup=0, age_cap=64, events=trace,
        service=service, device="cpu"))
    return np.asarray(res.backlog, np.float32)


@pytest.mark.parametrize("failure", [False, True])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_fleet_matches_fused_engine(scheduler, failure):
    arrivals = _arrivals(11)
    _, disp = _dispatchers(scheduler=scheduler)
    trace = _scenario(pev).compile(disp.topo, T) if failure else None
    _drive(disp, pf, arrivals, trace)
    h_fleet = np.asarray(disp.h_history, np.float32)
    _, disp2 = _dispatchers(scheduler=scheduler)
    h_fused = _run_fused(disp2, arrivals, trace, scheduler)
    np.testing.assert_array_equal(h_fleet, h_fused)
    assert h_fleet.sum() > 0.0
    if failure:
        assert h_fleet[10:22].max() > h_fleet[:10].max()  # the outage bit


# ---------------------------------------------------------------------------
# integral_assign, ServiceCredit, SimReplica
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integral_assign_matches_reference(seed):
    rng = np.random.default_rng(seed)
    assign = rng.random((3, 5)) * rng.integers(1, 6, (3, 1))
    assign[0, :] = 0.4  # an exact tie
    assert np.array_equal(pd.integral_assign(assign), rd.integral_assign(assign))
    a = pd.integral_assign(assign, rng=np.random.default_rng(seed))
    b = rd.integral_assign(assign, rng=np.random.default_rng(seed))
    assert np.array_equal(a, b)
    assert np.array_equal(a.sum(axis=1), np.rint(assign.sum(axis=1)).astype(np.int64))


def test_service_credit_matches_reference():
    rates = [0.1] * 1000 + [0.25, 0.5, 1.75, 0.0, 0.5, 1 / 3, 2.0]
    a, b = pe.ServiceCredit(), re.ServiceCredit()
    for r in rates:
        a.add(r)
        b.add(r)
        assert a.take() == b.take()
        assert a.fractional == b.fractional
    assert isinstance(a.fractional, Fraction)


def test_sim_replica_matches_reference():
    reps = pf.SimReplica(service_rate=3.0, max_batch=2), rf.SimReplica(service_rate=3.0,
                                                                      max_batch=2)
    for rep, mod in zip(reps, (pf, rf)):
        for rid in range(3):
            rep.submit(mod.FleetRequest(rid=rid, tokens=4.0 + rid, submitted=0))
    for t in range(8):
        rate = 1.5 if t == 3 else None
        done = [[r.rid for r in rep.step(rate=rate, t=t)] for rep in reps]
        assert done[0] == done[1]
        assert reps[0].backlog_tokens == reps[1].backlog_tokens
        assert reps[0].n_free_slots == reps[1].n_free_slots
    assert reps[0].tokens_served == reps[1].tokens_served == 15.0


# ---------------------------------------------------------------------------
# the whole path: dispatcher -> model-backed fleet -> engines -> decoder
# ---------------------------------------------------------------------------

def _serve(disp, fleet, req_cls, vocab, trace, n_slots, rng):
    """``examples/serving_demo.py``'s loop, with unrouted requests kept in a
    FIFO: returns ({rid: tokens}, per-slot integral assignments)."""
    waiting, reqs, routed, rid = [], [], [], 0
    for t in range(n_slots):
        n_new = int(rng.poisson(1.5)) if t < 8 else 0
        for _ in range(n_new):
            waiting.append(req_cls(rid, rng.integers(0, vocab, 6), max_new=4))
            rid += 1
        ev = (trace.mu_t[t], trace.gamma_t[t], trace.alive_t[t])
        assign = rd.integral_assign(
            disp.route(np.array([float(n_new)]), fleet.backlog_tokens, events_row=ev))
        routed.append(assign)
        for r in range(len(fleet)):
            for _ in range(int(assign[0, r])):
                if waiting:
                    req = waiting.pop(0)
                    reqs.append(req)
                    fleet.dispatch(r, req)
        fleet.step(t, mu_row=trace.mu_t[t][disp.F:], alive_row=trace.alive_t[t][disp.F:])
    return {r.rid: list(r.generated) for r in reqs}, np.stack(routed), reqs


def test_serving_path_matches_reference(small_model):
    rcfg, params, pcfg, model = small_model
    rates = [4.0, 2.0, 2.0]
    kw = dict(n_frontends=1, replica_hosts=np.array([1, 2, 3]), frontend_hosts=np.array([0]),
              host_costs=(np.ones((4, 4)) - np.eye(4)).astype(np.float32),
              replica_rates=np.array(rates))
    dcfg = dict(V=1.0, gamma=16.0, tokens_per_request=4.0)
    ref_disp = rd.PotusDispatcher(**kw, cfg=rd.DispatcherConfig(**dcfg))
    port_disp = pd.PotusDispatcher(**kw, cfg=pd.DispatcherConfig(**dcfg), device="cpu")
    n_slots = 24
    traces = [mod.flash_straggler(d.topo, start=3, duration=5, factor=0.25,
                                  instance=d.F).compile(d.topo, n_slots)
              for mod, d in ((rev, ref_disp), (pev, port_disp))]
    ref_fleet = rf.ReplicaFleet.from_model(rcfg, params, rates, max_batch=2, max_len=32)
    port_fleet = pf.ReplicaFleet.from_model(pcfg, model, rates, max_batch=2, max_len=32)
    assert all(e.model is model for e in port_fleet.replicas)
    want, routed_ref, _ = _serve(ref_disp, ref_fleet, re.Request, rcfg.vocab_size, traces[0],
                                 n_slots, np.random.default_rng(0))
    got, routed_port, reqs = _serve(port_disp, port_fleet, pe.Request, pcfg.vocab_size,
                                    traces[1], n_slots, np.random.default_rng(0))
    assert np.array_equal(routed_port, routed_ref)
    assert got == want
    assert len(reqs) > 4 and all(r.done and len(r.generated) == 4 for r in reqs)
    assert port_fleet.tokens_served == ref_fleet.tokens_served == 4 * len(reqs)
