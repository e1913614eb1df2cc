"""The port's plain scan engine, ``simulate(EngineSpec(engine="jax",
device="cpu"))``, against the reference ``simulate(EngineSpec(engine="jax"))``.

* Dyadic tier (the system of ``tests/test_cohort_fused.py``): every quantity
  is a dyadic rational, so f32 sums are exact in any order, and ``backlog``,
  ``comm_cost``, ``q_in_total``, ``q_out_total``, ``served_total`` and
  ``final_state`` must match bitwise for all four schedulers: against the
  reference with ``use_pallas`` False and True, with ``chunk`` None and 48,
  with a ``mu=`` override, with ``identity_trace`` (bit-transparent) and
  with a ``rolling_restart`` of the parallelism-2 components' instances.
  While one of those is down, its component's alive count is 1, so the
  even split of eq. (4) stays dyadic.
* A rolling restart of every instance takes a parallelism-4 component to 3
  alive instances, and the split ``shortfall / 3`` is not dyadic: the two
  packages then sum the same correctly rounded values in another order, so
  that case is held to ``rtol 1e-5`` (a few f32 ulps of the totals).
* Paper profile: with queue feedback, POTUS and JSQ amplify rounding
  differences through price near-ties (DESIGN.md §8), so long-run means are
  compared within 2% (the chaos floor at T≈300); Shuffle ignores queue state
  and is held per slot to ``rtol 1e-5``.
* A run from a reference mid-run state (``convert``) takes the same step.
* Facade guards: ``engine="jax"`` accepts ``potus-loop``, ``events`` and
  ``mu``, and ``potus-loop`` also runs on ``engine="cohort-fused"``;
  a stream the scan engine lacks (``metrics=("saturation",)``) raises and
  names ``cohort-fused``; CUDA by default.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro.core import simulator as rsim
from repro_torch import convert
from repro_torch.core import simulator as psim

from test_torch_engine import _dyadic, _paper, _pow2_arrivals

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T_DYADIC = 120
SCHEDULERS = ("potus", "potus-loop", "shuffle", "jsq")
SERIES = ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total")
STATE = ("q_in", "q_rem", "q_out_bolt", "transit")


def _run(ref_sys, port_sys, arr, T, ref_events=None, port_events=None, use_pallas=False,
         **kw):
    base = dict(arrivals=arr, T=T, engine="jax", **kw)
    ref = rc.simulate(rc.EngineSpec(topo=ref_sys[0], net=ref_sys[1], placement=ref_sys[2],
                                    use_pallas=use_pallas, events=ref_events, **base))
    port = pt.simulate(pt.EngineSpec(topo=port_sys[0], net=port_sys[1], placement=port_sys[2],
                                     events=port_events, device="cpu", **base))
    return ref, port


def _assert_bitwise(ref, port):
    for name in SERIES:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    for name in STATE:
        np.testing.assert_array_equal(getattr(port.final_state, name),
                                      np.asarray(getattr(ref.final_state, name)), err_msg=name)


def _dyadic_case():
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    return ref_sys, port_sys, _pow2_arrivals(ref_sys[0], T_DYADIC + 16, seed=3)


DYADIC_KW = dict(V=2.0, beta=0.5, window=2)


@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_tier_bitwise(scheduler, use_pallas, chunk):
    ref_sys, port_sys, arr = _dyadic_case()
    ref, port = _run(ref_sys, port_sys, arr, T_DYADIC, use_pallas=use_pallas,
                     scheduler=scheduler, chunk=chunk, **DYADIC_KW)
    _assert_bitwise(ref, port)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_tier_mu_override_bitwise(scheduler):
    ref_sys, port_sys, arr = _dyadic_case()
    mu = np.where(ref_sys[0].inst_mu > 0, 2.0, 0.0).astype(np.float32)
    ref, port = _run(ref_sys, port_sys, arr, T_DYADIC, scheduler=scheduler, mu=mu,
                     **DYADIC_KW)
    _assert_bitwise(ref, port)
    plain, _ = _run(ref_sys, port_sys, arr, T_DYADIC, scheduler=scheduler, **DYADIC_KW)
    assert not np.array_equal(ref.served_total, plain.served_total)  # the override bites


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_tier_identity_trace_bitwise(scheduler):
    ref_sys, port_sys, arr = _dyadic_case()
    ref, port = _run(ref_sys, port_sys, arr, T_DYADIC,
                     ref_events=rc.identity_trace(ref_sys[0], T_DYADIC),
                     port_events=pt.identity_trace(port_sys[0], T_DYADIC),
                     scheduler=scheduler, **DYADIC_KW)
    _assert_bitwise(ref, port)
    none = pt.simulate(pt.EngineSpec(topo=port_sys[0], net=port_sys[1],
                                     placement=port_sys[2], arrivals=arr, T=T_DYADIC,
                                     engine="jax", scheduler=scheduler, device="cpu",
                                     **DYADIC_KW))
    _assert_bitwise(none, port)  # the identity trace is bit-transparent


def _restart(mod, topo, instances=None):
    return mod.rolling_restart(topo, start=10, down_slots=6, stagger=3,
                               instances=instances).compile(topo, T_DYADIC)


@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_tier_rolling_restart_bitwise(scheduler, chunk):
    ref_sys, port_sys, arr = _dyadic_case()
    topo = ref_sys[0]
    pairs = [int(i) for i in range(topo.n_instances)
             if topo.comp_parallelism[topo.inst_comp[i]] == 2]
    ref, port = _run(ref_sys, port_sys, arr, T_DYADIC,
                     ref_events=_restart(rc, ref_sys[0], pairs),
                     port_events=_restart(pt, port_sys[0], pairs),
                     scheduler=scheduler, chunk=chunk, **DYADIC_KW)
    _assert_bitwise(ref, port)
    none, _ = _run(ref_sys, port_sys, arr, T_DYADIC, scheduler=scheduler, **DYADIC_KW)
    assert not np.array_equal(none.backlog, ref.backlog)  # the restarts bite


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_rolling_restart_of_every_instance_within_rounding(scheduler):
    ref_sys, port_sys, arr = _dyadic_case()
    ref, port = _run(ref_sys, port_sys, arr, T_DYADIC,
                     ref_events=_restart(rc, ref_sys[0]), port_events=_restart(pt, port_sys[0]),
                     scheduler=scheduler, **DYADIC_KW)
    for name in SERIES:
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_paper_profile_within_chaos_floor(scheduler):
    ref_sys, port_sys = _paper(rc), _paper(pt)
    ref, port = _run(ref_sys, port_sys, ref_sys[3], 200, scheduler=scheduler, V=2.0, window=2)
    if scheduler == "shuffle":  # no queue feedback: per slot, to rounding
        for name in SERIES:
            np.testing.assert_allclose(getattr(port, name), getattr(ref, name), rtol=1e-5,
                                       err_msg=name)
    assert port.avg_backlog == pytest.approx(ref.avg_backlog, rel=0.02)
    assert port.avg_cost == pytest.approx(ref.avg_cost, rel=0.02)
    assert float(port.served_total.mean()) == pytest.approx(float(ref.served_total.mean()),
                                                            rel=0.02)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_step_from_reference_mid_run_state(scheduler):
    """Both packages take one slot from the same mid-run state of the paper
    profile (non-dyadic queues): the same decision to rounding."""
    ref_sys = _paper(rc)
    topo, net, placement, arr = ref_sys
    cfg = rc.SimConfig(V=2.0, window=2, scheduler=scheduler)
    mid = rc.simulate(rc.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                    T=60, engine="jax", scheduler=scheduler, V=2.0, window=2))
    new_arr = np.asarray(arr[63], np.float32)
    prob = rc.make_problem(topo, net, placement)
    U = jnp.asarray(net.U)
    kc = prob.inst_container
    args = (U, U[kc[:, None], kc[None, :]], jnp.asarray(topo.inst_mu),
            jnp.asarray(topo.selectivity[topo.inst_comp]), 2.0, 1.0)
    r_state, r_met = rsim.sim_step(prob, rsim._get_scheduler(cfg.scheduler), *args,
                                   jax_state(mid.final_state), jnp.asarray(new_arr))
    p_prob = convert.sched_problem_from_numpy(prob)
    Ut = torch.as_tensor(net.U)
    kt = p_prob.inst_container.long()
    p_args = (Ut, Ut[kt[:, None], kt[None, :]], torch.as_tensor(topo.inst_mu),
              torch.as_tensor(topo.selectivity[topo.inst_comp]), 2.0, 1.0)
    p_state, p_met = psim.sim_step(p_prob, psim._get_scheduler(scheduler), *p_args,
                                   convert.sim_state_from_numpy(mid.final_state),
                                   torch.as_tensor(new_arr))
    np.testing.assert_allclose([float(m) for m in p_met], [float(m) for m in r_met],
                               rtol=1e-5)
    for name in STATE:
        np.testing.assert_allclose(getattr(p_state, name).numpy(),
                                   np.asarray(getattr(r_state, name)), rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def jax_state(state):
    return rc.SimState(*(jnp.asarray(getattr(state, f.name))
                         for f in dataclasses.fields(rc.SimState)))


def _spec(**kw):
    topo, net, placement = _dyadic(pt)
    arr = _pow2_arrivals(topo, 40, seed=3)
    return pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=20,
                         engine="jax", **kw)


def test_facade_guards():
    # metric streams are ported; one the scan engine lacks names the engine that has it
    with pytest.raises(pt.UnsupportedEngineOption, match="saturation.*'cohort-fused'"):
        pt.simulate(_spec(device="cpu", metrics=("saturation",)))
    with pytest.raises(pt.UnsupportedEngineOption, match="'age_cap'"):
        pt.simulate(_spec(device="cpu", age_cap=32))
    topo = _spec().topo
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.simulate(_spec(device="cpu", mu=np.ones(topo.n_instances, np.float32),
                          events=pt.identity_trace(topo, 20)))
    with pytest.raises(ValueError, match="chunk"):
        pt.simulate(_spec(device="cpu", chunk=0))
    with pytest.raises(ValueError, match="unknown scheduler"):
        pt.simulate(_spec(device="cpu", scheduler="nope"))
    # potus-loop runs on both ported engines
    assert pt.simulate(_spec(device="cpu", scheduler="potus-loop")).backlog.shape == (20,)
    assert pt.simulate(dataclasses.replace(_spec(device="cpu", scheduler="potus-loop"),
                                           engine="cohort-fused")).backlog.shape == (20,)
    with pytest.raises(pt.UnsupportedEngineOption, match="not ported yet"):
        psim._run_sim_impl(topo, _spec().net, _spec().placement, _spec().arrivals, 20,
                           pt.SimConfig(sharded=True))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    def ran(*a, **k):
        raise AssertionError("simulate ran although CUDA was asked for and absent")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(psim, "_run_sim_impl", ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.simulate(_spec())


@pytest.mark.parametrize("builder", ["make_problem", "init_state", "_run_sim_impl"])
def test_builders_default_to_cuda_and_never_fall_back(monkeypatch, builder):
    """The reference's calls, which name no device, ask for the card: without
    one they raise instead of building CPU tensors that would take the plain
    versions."""
    from repro_torch.core import potus as ppotus
    from repro_torch.core import queues as pqueues

    spec = _spec()
    topo, W = spec.topo, 2
    calls = {
        "make_problem": lambda: ppotus.make_problem(topo, spec.net, spec.placement),
        "init_state": lambda: pqueues.init_state(topo, W, np.asarray(spec.arrivals)[: W + 1]),
        "_run_sim_impl": lambda: psim._run_sim_impl(topo, spec.net, spec.placement,
                                                    spec.arrivals, 4, pt.SimConfig()),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[builder]()
    # the CPU is taken when asked for by name
    assert ppotus.make_problem(topo, spec.net, spec.placement,
                               device="cpu").edge_mask.device.type == "cpu"
    assert pqueues.init_state(topo, W, np.asarray(spec.arrivals)[: W + 1],
                              device="cpu").q_in.device.type == "cpu"
