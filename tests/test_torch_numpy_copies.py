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
