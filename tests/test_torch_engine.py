"""The port's ``simulate(EngineSpec(..., device="cpu"))`` against the
reference facade, and the port facade's guards.

* Dyadic tier (the system of ``tests/test_cohort_fused.py``): every quantity
  is a dyadic rational, so f32 sums are exact in any order, and ``backlog``,
  ``comm_cost``, ``avg_response`` and ``completed_mass`` must match bitwise,
  against the reference with ``use_pallas`` False and True, with and
  without ``chunk=``.
* Paper profile: POTUS and JSQ amplify rounding differences through price
  near-ties (DESIGN.md §8), so only long-run means are compared, with the
  chaos-floor bounds of ``tests/test_cohort_fused.py``
  (``TestPotusPaperSystem``).
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro_torch.core import cohort_fused as pcf

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T_DYADIC = 120


def _dyadic(mod):
    C = mod.Component
    apps = [
        [C("src", 0, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
         C("left", 0, False, 2, 4.0, successors=(3,)),
         C("right", 0, False, 4, 4.0, successors=(3,)),
         C("sink", 0, False, 2, 8.0)],
        [C("src", 1, True, 2, successors=(1,)),
         C("mid", 1, False, 4, 4.0, successors=(2,)),
         C("sink", 1, False, 2, 4.0)],
    ]
    topo = mod.build_topology(apps, gamma=64.0)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    placement = mod.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                      max_per_container=4)
    return topo, net, placement


def _pow2_arrivals(topo, T, seed):
    rng = np.random.default_rng(seed)
    unit = rc.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T, *unit.shape))).astype(np.float32)
    arr *= rng.random((T, *unit.shape)) < 0.8
    return (arr * (unit > 0)).astype(np.float32)


def _paper(mod, seed=0):
    rng = np.random.default_rng(seed)
    topo = mod.build_topology(mod.random_apps(rng, n_apps=5), gamma=24.0)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    rates = mod.feasible_rates(topo, utilization=0.7)
    placement = mod.t_heron_placement(topo, net, rates, max_per_container=8)
    return topo, net, placement, mod.poisson_arrivals(np.random.default_rng(7), rates, 256)


def _both(ref_sys, port_sys, arr, T, use_pallas=False, **kw):
    ref = rc.simulate(rc.EngineSpec(topo=ref_sys[0], net=ref_sys[1], placement=ref_sys[2],
                                    arrivals=arr, T=T, use_pallas=use_pallas, **kw))
    port = pt.simulate(pt.EngineSpec(topo=port_sys[0], net=port_sys[1], placement=port_sys[2],
                                     arrivals=arr, T=T, device="cpu", **kw))
    return ref, port


@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_dyadic_tier_bitwise(scheduler, use_pallas, chunk):
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    arr = _pow2_arrivals(ref_sys[0], T_DYADIC + 16, seed=3)
    ref, port = _both(ref_sys, port_sys, arr, T_DYADIC, use_pallas=use_pallas,
                      scheduler=scheduler, V=2.0, beta=0.5, window=2, chunk=chunk)
    # exact in f32 on the dyadic tier: bitwise
    np.testing.assert_array_equal(port.backlog, ref.backlog)
    np.testing.assert_array_equal(port.comm_cost, ref.comm_cost)
    assert port.avg_response == ref.avg_response
    assert port.completed_mass == ref.completed_mass
    assert port.n_cohorts == ref.n_cohorts
    assert port.saturated_frac == ref.saturated_frac


def test_dyadic_tier_slots_per_launch_and_prediction():
    """K-slot launches and a distinct prediction stream change nothing."""
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    arr = _pow2_arrivals(ref_sys[0], T_DYADIC + 16, seed=3)
    pred = _pow2_arrivals(ref_sys[0], T_DYADIC + 16, seed=9)
    ref, port = _both(ref_sys, port_sys, arr, T_DYADIC, scheduler="potus", V=2.0, beta=0.5,
                      window=2, predicted=pred, slots_per_launch=8)
    np.testing.assert_array_equal(port.backlog, ref.backlog)
    np.testing.assert_array_equal(port.comm_cost, ref.comm_cost)
    assert port.avg_response == ref.avg_response
    assert port.p95_response == ref.p95_response


@pytest.mark.parametrize("scheduler", ["potus", "jsq"])
def test_paper_profile_means_within_chaos_floor(scheduler):
    ref, port = _both(_paper(rc), _paper(pt), _paper(rc)[3], 240, scheduler=scheduler,
                      V=1.0, window=2)
    # the chaos-floor bounds of tests/test_cohort_fused.py::TestPotusPaperSystem
    assert port.avg_response == pytest.approx(ref.avg_response, rel=0.10)
    assert port.avg_backlog == pytest.approx(ref.avg_backlog, rel=0.10)
    assert port.avg_cost == pytest.approx(ref.avg_cost, rel=0.02)
    assert port.n_cohorts == ref.n_cohorts


def test_saturation_warning_fires_where_the_reference_does():
    ref_sys, port_sys = _paper(rc), _paper(pt)
    for age_cap, warns in ((16, True), (256, False)):
        got = {}
        for name, sim, spec, sys_ in (("ref", rc.simulate, rc.EngineSpec, ref_sys),
                                      ("port", pt.simulate, pt.EngineSpec, port_sys)):
            kw = {} if name == "ref" else {"device": "cpu"}
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                sim(spec(topo=sys_[0], net=sys_[1], placement=sys_[2], arrivals=ref_sys[3],
                         T=240, V=10.0, window=1, age_cap=age_cap, **kw))
            got[name] = [str(w.message) for w in rec
                         if type(w.message).__name__ == "AgeCapSaturationWarning"]
        assert bool(got["ref"]) == bool(got["port"]) == warns
        if warns:
            assert "age_cap=16" in got["port"][0] and "age_cap=32" in got["port"][0]
            assert issubclass(pt.AgeCapSaturationWarning, UserWarning)


def _spec(**kw):
    topo, net, placement = _dyadic(pt)
    arr = _pow2_arrivals(topo, 40, seed=3)
    return pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=20, **kw)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    assert pt.EngineSpec.__dataclass_fields__["device"].default == "cuda"

    def ran(*a, **k):
        raise AssertionError("simulate ran although CUDA was asked for and absent")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pcf, "_run_cohort_fused_impl", ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.simulate(_spec())


@pytest.mark.parametrize("engine", ["jax", "sharded", "cohort"])
def test_unported_engines_raise(engine):
    # every engine is ported whole, its metric streams included; engine="sharded"
    # on a world of one equals engine="jax" bitwise, its payload stream 0
    res = pt.simulate(_spec(engine=engine, device="cpu", metrics=True))
    assert res.metrics.n_slots == 20 and np.isfinite(res.backlog).all()
    assert tuple(res.metrics.streams) == pt.engine.check_metrics_spec(engine, True).streams
    np.testing.assert_array_equal(res.metrics.streams["backlog"][:, 0], res.backlog)
    if engine == "sharded":
        plain = pt.simulate(_spec(engine="jax", device="cpu", metrics=True))
        np.testing.assert_array_equal(res.backlog, plain.backlog)
        np.testing.assert_array_equal(res.comm_cost, plain.comm_cost)
        for name, rows in plain.metrics.streams.items():
            np.testing.assert_array_equal(res.metrics.streams[name], rows)


# sharded=True on cohort-fused runs the sharded scan: on a world of one it
# equals the dense engine bitwise, metric streams included
@pytest.mark.parametrize("option", [{"metrics": True, "sharded": True}, {"sharded": True}])
def test_unported_options_raise(option):
    res = pt.simulate(_spec(device="cpu", **option))
    dense = pt.simulate(_spec(device="cpu", **dict(option, sharded=False)))
    np.testing.assert_array_equal(res.backlog, dense.backlog)
    np.testing.assert_array_equal(res.comm_cost, dense.comm_cost)
    assert res.completed_mass == dense.completed_mass
    assert (res.metrics is None) == (dense.metrics is None) == ("metrics" not in option)
    if res.metrics is not None:
        for name, rows in dense.metrics.streams.items():
            np.testing.assert_array_equal(res.metrics.streams[name], rows)


def test_reference_option_matrix_still_applies():
    with pytest.raises(pt.UnsupportedEngineOption, match="'mu'"):
        pt.simulate(_spec(device="cpu", mu=np.ones(18)))
    with pytest.raises(ValueError, match="unknown engine"):
        pt.simulate(_spec(engine="nope", device="cpu"))
    # use_pallas validates as in the reference and selects nothing
    a = pt.simulate(_spec(device="cpu", use_pallas=True))
    b = pt.simulate(_spec(device="cpu"))
    np.testing.assert_array_equal(a.backlog, b.backlog)
