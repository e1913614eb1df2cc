"""The port's discrete-event oracle (``repro_torch.core.run_event_sim``)
against the port's scan engine and the reference's ``repro.core.run_event_sim``.

* Fluid service and aligned landings on the dyadic system of
  ``tests/test_eventsim_differential.py`` (T=96): the event timeline collapses
  onto slot boundaries, so every per-slot series equals the port's scan
  engine (``engine="jax"``) bitwise — for potus, potus-loop, shuffle and jsq,
  with power-of-two counts, constant traffic and an ``ArrivalSpec``.
* Tuple service and landing jitter (``integral=True, jitter=0.5, seed=7``)
  on Poisson, MMPP and Pareto traffic (T=100): the heap, the equal-time
  order and the seeded draws are the reference's, so ``backlog``,
  ``served_total``, ``n_events`` and the rest equal the reference's bitwise,
  and the burstier the traffic the larger the slot-versus-event gap.
* Mass conservation, the four guards, and ``device="cuda"`` by default
  with no fallback. The card against the CPU, with one launch of kernel 2
  or 3 a slot, is held by the ``cuda``-marked cases of
  ``tests/test_torch_kernel_cuda.py``, which import no JAX.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro_torch.core import cohort as pco
from repro_torch.core import eventsim as pev

torch.set_num_threads(1)

T = 96
GAP_T = 100
SERIES = ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total")
BURSTS = (("poisson", {}), ("mmpp", {"rate_ratio": 10.0}), ("pareto", {"alpha": 1.3}))


def _system(mod, gamma=64.0):
    """``tests/test_eventsim_differential.py``'s dyadic system in ``mod``."""
    topo = mod.build_topology(
        [mod.linear_app(3, parallelism=2, mu=8.0), mod.diamond_app(parallelism=2, mu=8.0)],
        gamma=gamma)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    rates = mod.spout_rate_matrix(topo, 2.0)
    placement = mod.t_heron_placement(topo, net, rates, max_per_container=8)
    return topo, net, placement


def _pow2_arrivals(topo, n, seed=0, hi=5):
    """Even integer counts on every spout stream (the reference test's)."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((n, topo.n_instances, topo.n_components), np.float64)
    is_spout = topo.comp_is_spout[topo.inst_comp]
    for i in range(topo.n_instances):
        if not is_spout[i]:
            continue
        for c2 in topo.successors_of_comp(int(topo.inst_comp[i])):
            arr[:, i, int(c2)] = rng.integers(0, hi, n) * 2.0
    return arr


def _scan(sys_, arrivals, n_slots, cfg):
    topo, net, placement = sys_
    return pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement,
                                     arrivals=arrivals, T=n_slots, engine="jax",
                                     scheduler=cfg.scheduler, V=cfg.V, beta=cfg.beta,
                                     window=cfg.window, device="cpu"))


def _assert_series_equal(ev, scan):
    for name in SERIES:
        got = getattr(ev, name)
        assert got.dtype == np.float64, name
        np.testing.assert_array_equal(got, np.asarray(getattr(scan, name), np.float64),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# fluid + aligned: the event oracle is the slot engine, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["potus", "potus-loop", "shuffle", "jsq"])
def test_fluid_aligned_equals_scan_engine(scheduler):
    sys_ = _system(pt)
    cfg = pt.SimConfig(window=2, scheduler=scheduler)
    arr = _pow2_arrivals(sys_[0], T + cfg.window + 1, seed=3)
    ev = pt.run_event_sim(*sys_, arr, T, cfg, device="cpu")
    _assert_series_equal(ev, _scan(sys_, arr, T, cfg))
    assert ev.completed_mass > 0 and ev.n_events > 0


def test_fluid_aligned_constant_traffic():
    sys_ = _system(pt)
    topo = sys_[0]
    cfg = pt.SimConfig(window=2, scheduler="shuffle")
    arr = np.zeros((T + 3, topo.n_instances, topo.n_components))
    arr += 4.0 * (pt.spout_rate_matrix(topo, 1.0) > 0)
    ev = pt.run_event_sim(*sys_, arr, T, cfg, device="cpu")
    _assert_series_equal(ev, _scan(sys_, arr, T, cfg))


def test_fluid_aligned_arrival_spec():
    """An ``ArrivalSpec`` materializes identically in both engines."""
    sys_ = _system(pt)
    cfg = pt.SimConfig(window=1, scheduler="jsq")
    spec = pt.ArrivalSpec(kind="poisson", seed=11, rate_per_stream=2.0)
    ev = pt.run_event_sim(*sys_, spec, 48, cfg, device="cpu")
    _assert_series_equal(ev, _scan(sys_, spec, 48, cfg))


# ---------------------------------------------------------------------------
# tuple service + jitter: the reference's events, bitwise
# ---------------------------------------------------------------------------

def _gap_pair(kind, params, scheduler="shuffle", integral=True, jitter=0.5):
    out = {}
    for name, mod, kw in (("ref", rc, {}), ("port", pt, {"device": "cpu"})):
        sys_ = _system(mod)
        cfg = mod.SimConfig(window=2, scheduler=scheduler)
        spec = mod.ArrivalSpec(kind=kind, seed=5, rate_per_stream=2.0, params=params)
        arr = np.round(spec.generate(sys_[0], GAP_T + cfg.window + 1))
        out[name] = (arr, mod.run_event_sim(*sys_, arr, GAP_T, cfg, integral=integral,
                                            jitter=jitter, seed=7, **kw))
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    return out["ref"][1], out["port"][1], out["port"][0]


@pytest.mark.parametrize("scheduler", ["shuffle", "potus"])
@pytest.mark.parametrize("kind,params", BURSTS, ids=[k for k, _ in BURSTS])
def test_integral_jitter_equals_reference(kind, params, scheduler):
    ref, port, _ = _gap_pair(kind, params, scheduler)
    for name in SERIES:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port.n_events == ref.n_events > 0
    assert port.completed_mass == ref.completed_mass


@pytest.mark.parametrize("integral,jitter", [(False, 0.3), (False, 0.9), (True, 0.0)])
def test_other_fidelity_knobs_equal_reference(integral, jitter):
    ref, port, _ = _gap_pair("poisson", {}, "jsq", integral, jitter)
    for name in SERIES:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port.n_events == ref.n_events


def test_gap_grows_with_burstiness():
    """``workload.py``'s event-gap rows on the port: the mean |backlog| gap
    to the port's scan engine, smooth below bursty (the reference's bounds)."""
    gaps = {}
    for kind, params in BURSTS:
        _, ev, arr = _gap_pair(kind, params)
        scan = _scan(_system(pt), arr, GAP_T, pt.SimConfig(window=2, scheduler="shuffle"))
        gaps[kind] = float(np.abs(np.asarray(scan.backlog, np.float64) - ev.backlog).mean())
    assert gaps["poisson"] < 0.5
    assert gaps["mmpp"] > 2 * gaps["poisson"] and gaps["pareto"] > 2 * gaps["poisson"]
    assert gaps["mmpp"] < 6.0 and gaps["pareto"] < 6.0


def test_mass_is_conserved_at_event_granularity():
    sys_ = _system(pt)
    arr = _pow2_arrivals(sys_[0], 123, seed=9)
    ev = pt.run_event_sim(*sys_, arr, 120, pt.SimConfig(window=2, scheduler="shuffle"),
                          integral=True, device="cpu")
    assert 0 < ev.completed_mass <= arr[:120].sum() + 1e-6
    assert (ev.served_total >= -1e-9).all()


def test_largest_remainder_equals_reference():
    from repro.core import eventsim as rev

    rng = np.random.default_rng(0)
    for _ in range(50):
        amounts = rng.random(rng.integers(1, 9)) + 1e-3
        k = int(rng.integers(0, 40))
        np.testing.assert_array_equal(pev._largest_remainder(amounts, k),
                                      rev._largest_remainder(amounts, k))
    np.testing.assert_array_equal(pev._largest_remainder(np.array([1.0, 1.0, 1.0]), 2),
                                  [1, 1, 0])  # ties toward the lower index


# ---------------------------------------------------------------------------
# guards and defaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guard", ["events", "jitter", "sharded", "integral"])
def test_guards_raise_as_the_reference(guard):
    sys_ = _system(pt)
    arr = _pow2_arrivals(sys_[0], 20, seed=0)
    cfg = pt.SimConfig(window=1, sharded=guard == "sharded")
    kw = {"events": dict(events=object()), "jitter": dict(jitter=1.5),
          "sharded": {}, "integral": dict(integral=True)}[guard]
    if guard == "integral":
        arr = arr + 0.25
    match = {"events": "disruption", "jitter": "jitter", "sharded": "sharded",
             "integral": "integer arrival counts"}[guard]
    with pytest.raises(ValueError, match=match):
        pt.run_event_sim(*sys_, arr, 16, cfg, device="cpu", **kw)


def test_defaults_to_cuda_and_never_falls_back(monkeypatch):
    import inspect

    assert inspect.signature(pt.run_event_sim).parameters["device"].default == "cuda"

    def ran(*a, **k):
        raise AssertionError("the event simulator ran although CUDA was asked for and absent")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pco._SlotScheduler, "__call__", ran)
    sys_ = _system(pt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.run_event_sim(*sys_, _pow2_arrivals(sys_[0], 20), 16, pt.SimConfig(window=1))


def test_exports_match_reference():
    assert pt.EventSimResult.__name__ == rc.EventSimResult.__name__
    assert [f for f in pt.EventSimResult.__dataclass_fields__] == [
        f for f in rc.EventSimResult.__dataclass_fields__]
    assert {"run_event_sim", "EventSimResult"} <= set(pt.__all__)
