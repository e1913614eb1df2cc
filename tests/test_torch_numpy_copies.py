"""The port's numpy copies of the problem builders against the reference:
from the same seed, topology arrays, network costs, T-Heron placement,
every arrival generator, the predictors and ``materialize_arrivals`` must
be ``np.array_equal`` (they are the same numpy code, so exact equality is
the only right tolerance)."""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as pt
from repro.core import placement as rplace
from repro.core import prediction as rpred
from repro.core import simulator as rsim
from repro.core import workload as rwork
from repro_torch.core import prediction as ppred
from repro_torch.core import simulator as psim


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _paper_topos(seed):
    return (rc.build_topology(rc.random_apps(np.random.default_rng(seed), n_apps=5), gamma=24.0),
            pt.build_topology(pt.random_apps(np.random.default_rng(seed), n_apps=5), gamma=24.0))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_topology_equal(seed):
    _assert_dataclass_equal(*_paper_topos(seed))


def test_canonical_apps_equal():
    for mk in ("linear_app", "diamond_app"):
        args = (3,) if mk == "linear_app" else ()
        a = rc.build_topology([getattr(rc, mk)(*args)], gamma=6.0)
        b = pt.build_topology([getattr(pt, mk)(*args)], gamma=6.0)
        _assert_dataclass_equal(a, b)


@pytest.mark.parametrize("fabric", ["fat-tree", "jellyfish"])
@pytest.mark.parametrize("per_server", [2, 8])
def test_network_costs_equal(fabric, per_server):
    if fabric == "fat-tree":
        sd_r, sw_r = rc.fat_tree(4)
        sd_p, sw_p = pt.fat_tree(4)
    else:
        sd_r, sw_r = rc.jellyfish(np.random.default_rng(1), 24, 16)
        sd_p, sw_p = pt.jellyfish(np.random.default_rng(1), 24, 16)
    np.testing.assert_array_equal(sw_r, sw_p)
    _assert_dataclass_equal(rc.container_costs(fabric, sd_r, per_server),
                            pt.container_costs(fabric, sd_p, per_server))


def test_t_heron_placement_equal():
    topo_r, topo_p = _paper_topos(0)
    sd, _ = rc.fat_tree(4)
    net_r, net_p = rc.container_costs("ft", sd), pt.container_costs("ft", sd)
    rates_r = rc.feasible_rates(topo_r, utilization=0.7)
    rates_p = pt.feasible_rates(topo_p, utilization=0.7)
    np.testing.assert_array_equal(rates_r, rates_p)
    np.testing.assert_array_equal(
        rc.t_heron_placement(topo_r, net_r, rates_r, max_per_container=8),
        pt.t_heron_placement(topo_p, net_p, rates_p, max_per_container=8))
    np.testing.assert_array_equal(
        rplace.random_placement(np.random.default_rng(4), topo_r, net_r),
        pt.random_placement(np.random.default_rng(4), topo_p, net_p))


@pytest.mark.parametrize("kind", sorted(rwork.GENERATORS))
def test_every_arrival_generator_equal(kind):
    topo_r, topo_p = _paper_topos(0)
    params = {}
    if kind == "trace-replay":
        params = {"trace": np.random.default_rng(2).poisson(1.0, (5, topo_r.n_instances,
                                                                   topo_r.n_components))}
    a = rwork.ArrivalSpec(kind=kind, seed=11, utilization=0.6, params=params).generate(topo_r, 60)
    b = pt.ArrivalSpec(kind=kind, seed=11, utilization=0.6, params=params).generate(topo_p, 60)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    # the same through materialize_arrivals, and arrays pass through unchanged
    np.testing.assert_array_equal(
        rsim.materialize_arrivals(rwork.ArrivalSpec(kind=kind, seed=3, params=params), topo_r, 40),
        psim.materialize_arrivals(pt.ArrivalSpec(kind=kind, seed=3, params=params), topo_p, 40))
    np.testing.assert_array_equal(psim.materialize_arrivals(b, topo_p, 60), b)


def test_pad_arrivals_equal():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(rsim.pad_arrivals(x, 5), psim.pad_arrivals(x, 5))
    assert psim.pad_arrivals(x, 1) is x


@pytest.mark.parametrize("name", sorted(rpred.PREDICTORS))
def test_predictors_equal(name):
    arr = rc.poisson_arrivals(np.random.default_rng(5), np.full((2, 3), 1.5), 50)
    np.testing.assert_array_equal(
        rpred.predict_series(name, arr, np.random.default_rng(9)),
        ppred.predict_series(name, arr, np.random.default_rng(9)))


def _traces(mod, topo, placement, T):
    """Every canned scenario generator, compiled."""
    return {
        "identity": mod.identity_trace(topo, T),
        "rolling": mod.rolling_restart(topo, start=3, down_slots=4, stagger=2,
                                       instances=[0, 5, 9]).compile(topo, T),
        "rolling-all": mod.rolling_restart(topo, start=1, down_slots=2).compile(topo, T),
        "straggler": mod.flash_straggler(topo, start=5, duration=9, factor=0.25,
                                         rng=np.random.default_rng(2)).compile(topo, T),
        "k-failures": mod.k_failures(topo, k=5, start=4, duration=7,
                                     rng=np.random.default_rng(3)).compile(topo, T),
        "k-failures-spouts": mod.k_failures(topo, k=3, start=0, duration=50, bolts_only=False,
                                            rng=np.random.default_rng(4)).compile(topo, T),
        "diurnal": mod.diurnal_autoscale(topo, T, period=20, min_alive_frac=0.5).compile(topo, T),
        "chaos": mod.random_chaos(topo, T, np.random.default_rng(5), n_events=12,
                                  placement=placement).compile(topo, T, placement=placement),
        "declared": mod.FleetScenario((
            mod.FleetEvent("outage", 2, 9, container=int(placement[0])),
            mod.FleetEvent("throttle", 0, 30, component=1, factor=0.5),
            mod.FleetEvent("straggler", 10, 20, instances=(3, 4), factor=0.3),
            mod.FleetEvent("scale_down", 15, 25, component=2),
        ), name="declared").compile(topo, T, placement=placement),
    }


@pytest.mark.parametrize("T", [35, 60])
def test_every_event_trace_equal(T):
    topo_r, topo_p = _paper_topos(0)
    sd, _ = rc.fat_tree(4)
    net = rc.container_costs("ft", sd)
    placement = rc.t_heron_placement(topo_r, net, rc.feasible_rates(topo_r, utilization=0.7),
                                     max_per_container=8)
    ref, port = _traces(rc, topo_r, placement, T), _traces(pt, topo_p, placement, T)
    assert ref.keys() == port.keys()
    for name in ref:
        a, b = ref[name], port[name]
        assert (a.name, a.T, a.n_instances) == (b.name, b.T, b.n_instances), name
        assert a.is_identity(topo_r) == b.is_identity(topo_p), name
        for size in (T, T + 7, T - 9):  # as compiled, held, truncated
            pa, pb = a.prepared(size), b.prepared(size)
            for field in ("mu_t", "gamma_t", "alive_t"):
                x, y = getattr(pa, field), getattr(pb, field)
                assert x.dtype == y.dtype, (name, field)
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{field}")
    assert not ref["chaos"].is_identity(topo_r)


def test_event_validation_equal():
    for kwargs in (dict(kind="nope", start=0, end=1), dict(kind="failure", start=3, end=1),
                   dict(kind="outage", start=0, end=1),
                   dict(kind="straggler", start=0, end=1, factor=-1.0)):
        with pytest.raises(ValueError) as ref_err:
            rc.FleetEvent(**kwargs)
        with pytest.raises(ValueError) as port_err:
            pt.FleetEvent(**kwargs)
        assert str(ref_err.value) == str(port_err.value)


def _oracle_problem(seed):
    """A tie-heavy integer problem (the grids of
    ``tests/test_fastpath.py::test_adversarial_ties``) with mandatory arrivals."""
    rng = np.random.default_rng(seed)
    I, C, K = 12, 4, 3
    inst_comp = rng.integers(0, C, I).astype(np.int32)
    edge_mask = (rng.random((I, I)) < 0.35) & (inst_comp[:, None] != inst_comp[None, :])
    comp_count = np.maximum(np.bincount(inst_comp, minlength=C), 1).astype(np.float32)
    gamma = rng.integers(1, 8, I).astype(np.float32)
    placement = rng.integers(0, K, I).astype(np.int32)
    U = rng.integers(0, 3, (K, K)).astype(np.float32)
    q_in = rng.integers(0, 4, I).astype(np.float32)
    q_out = rng.integers(0, 6, (I, C)).astype(np.float32)
    must = (rng.integers(0, 3, (I, C)) * (rng.random((I, C)) < 0.3)).astype(np.float32)
    return edge_mask, inst_comp, placement, comp_count, gamma, U, q_in, q_out, must


@pytest.mark.parametrize("beta", [1.0, 0.5, 0.2])
@pytest.mark.parametrize("seed", range(4))
def test_reference_oracle_equal(seed, beta):
    from repro.core import reference as rref
    from repro_torch.core import reference as pref

    em, comp, cont, count, gamma, U, q_in, q_out, must = _oracle_problem(seed)
    np.testing.assert_array_equal(
        pref.prices_reference(em, comp, cont, U, q_in, q_out, 2.0, beta),
        rref.prices_reference(em, comp, cont, U, q_in, q_out, 2.0, beta))
    np.testing.assert_array_equal(
        pref.potus_schedule_reference(em, comp, cont, count, gamma, U, q_in, q_out, must, 2.0,
                                      beta),
        rref.potus_schedule_reference(em, comp, cont, count, gamma, U, q_in, q_out, must, 2.0,
                                      beta))
    # the brute-force LP (15) on the first rows, where it stays tiny
    rows = np.zeros_like(em)
    rows[:3] = em[:3]
    l = rref.prices_reference(rows, comp, cont, U, q_in, q_out, 2.0, beta)
    obj_p, x_p = pref.solve_lp_bruteforce(rows, comp, gamma, q_out, l, max_units=3)
    obj_r, x_r = rref.solve_lp_bruteforce(rows, comp, gamma, q_out, l, max_units=3)
    assert obj_p == obj_r
    np.testing.assert_array_equal(x_p, x_r)
