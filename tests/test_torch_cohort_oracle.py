"""The port's cohort event loop (``engine="cohort"``, ``repro_torch.core.cohort``)
against the reference's ``repro.core.cohort`` on the same numpy inputs.

* Dyadic tier (the system of ``tests/test_cohort_fused.py``, T=96): every
  quantity is a dyadic rational, so the schedulers' f32 and the loop's f64
  arithmetic are exact and ``backlog``, ``comm_cost``, ``avg_response``,
  ``p95_response``, ``n_cohorts``, ``completed_frac`` and ``completed_mass``
  equal the reference's bitwise — for potus, potus-loop, shuffle and jsq at
  W in {0, 2}, with a mis-predicted stream, under a k-failure and a rolling
  restart of the parallelism-2 components (the even split stays exact), and
  with ``metrics=`` (every stream the engine serves), whose frame is equal
  too.
* Paper profile (``benchmarks/common.py``'s system, T=100): Shuffle within
  the reference's rtol 1e-5 / atol 1e-3 (responses rel 1e-3), POTUS within
  the chaos floor of ``tests/test_cohort_fused.py::TestPotusPaperSystem``.
* The port's ``cohort-fused`` against the port's ``cohort``, at the
  reference's own bounds (``tests/test_cohort_fused.py:91-123``).
* ``run_sweep(engine="cohort")``: each scenario equals its own ``simulate``
  and the reference's sweep, one partition a scenario; its guards raise as
  the reference's do.
* The defaults: ``engine="cohort"`` runs on the card unless asked for the
  CPU, and raises without one. The card against the CPU, with one launch of
  kernel 2 (``potus``) or kernel 3 (``potus-loop``) a slot, is held by the
  ``cuda``-marked cases of ``tests/test_torch_kernel_cuda.py``, which import
  no JAX (the machine with the card has none).
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro_torch.core import cohort as pco

from test_torch_cohort_events import _trace
from test_torch_engine import _dyadic, _paper, _pow2_arrivals

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T = 96
KW = dict(V=2.0, beta=0.5, warmup=16, drain_margin=24)
SCHEDULERS = ("potus", "potus-loop", "shuffle", "jsq")
#: every stream the cohort event loop serves
STREAMS = ("backlog", "queue_depth", "price", "dispatch", "transit", "backlog_comp", "held",
           "window")


def _spec(mod, sys_, arr, n_slots=T, **kw):
    return mod.EngineSpec(topo=sys_[0], net=sys_[1], placement=sys_[2], arrivals=arr,
                          T=n_slots, **kw)


def _both(arr, predicted=None, events=None, n_slots=T, **kw):
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    kw = dict(KW, engine="cohort", **kw)
    ref = rc.simulate(_spec(rc, ref_sys, arr, n_slots, predicted=predicted,
                            events=None if events is None else _trace(rc, ref_sys[0], events,
                                                                      n_slots), **kw))
    port = pt.simulate(_spec(pt, port_sys, arr, n_slots, predicted=predicted, device="cpu",
                             events=None if events is None else _trace(pt, port_sys[0],
                                                                       events, n_slots), **kw))
    return ref, port


def _same(x, y) -> bool:
    return x == y or (np.isnan(x) and np.isnan(y))


def assert_bitwise(port, ref):
    np.testing.assert_array_equal(port.backlog, ref.backlog)
    np.testing.assert_array_equal(port.comm_cost, ref.comm_cost)
    for f in ("avg_response", "p95_response", "completed_frac", "completed_mass",
              "avg_backlog", "avg_cost", "saturated_frac"):
        assert _same(getattr(port, f), getattr(ref, f)), f
    assert port.n_cohorts == ref.n_cohorts


def assert_frames_bitwise(port, ref):
    assert list(port.streams) == list(ref.streams)
    for name, want in ref.streams.items():
        assert port.columns[name] == ref.columns[name], name
        assert port.streams[name].dtype == want.dtype, name
        np.testing.assert_array_equal(port.streams[name], want, err_msg=name)


@pytest.fixture(scope="module")
def arrivals():
    """The streams of ``tests/test_cohort_fused.py``'s dyadic tests (drawn for
    300 + 16 slots, so their first slots are the same), actual and predicted."""
    topo = _dyadic(rc)[0]
    return _pow2_arrivals(topo, 300 + 16, seed=3), _pow2_arrivals(topo, 300 + 16, seed=9)


# ---------------------------------------------------------------------------
# dyadic tier: the port's event loop equals the reference's bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_bitwise(arrivals, scheduler, window):
    ref, port = _both(arrivals[0], scheduler=scheduler, window=window)
    assert_bitwise(port, ref)
    assert port.completed_mass > 0 and np.isfinite(port.avg_response) and port.n_cohorts > 0
    assert port.metrics is None and port.saturated_frac == 0.0


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_mispredicted_bitwise(arrivals, scheduler):
    """TP/FP/TN reconciliation, phantom pre-serves and admission backlog."""
    arr, pred = arrivals
    ref, port = _both(arr, predicted=pred, scheduler=scheduler, window=2)
    assert_bitwise(port, ref)
    perfect = pt.simulate(_spec(pt, _dyadic(pt), arr, scheduler=scheduler, window=2,
                                engine="cohort", device="cpu", **KW))
    assert not np.array_equal(port.backlog, perfect.backlog)  # the mis-prediction bites


@pytest.mark.parametrize("kind", ["k_failures", "rolling_restart"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_events_bitwise(arrivals, scheduler, kind):
    """Dead instances priced out by the caps, bolts served at the trace's mu,
    mandatory arrivals of dead sources held; the splits stay dyadic."""
    ref, port = _both(arrivals[0], events=kind, scheduler=scheduler, window=2)
    assert_bitwise(port, ref)
    none = pt.simulate(_spec(pt, _dyadic(pt), arrivals[0], scheduler=scheduler, window=2,
                             engine="cohort", device="cpu", **KW))
    assert not np.array_equal(port.backlog, none.backlog)  # the disruption bites


@pytest.mark.parametrize("case", ["plain", "mispredicted", "k_failures"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_dyadic_metrics_frame_bitwise(arrivals, scheduler, case):
    """``metrics=`` with every cohort stream: the frame equals the
    reference's bitwise (``q_in`` f32, the component backlog f64, as there)
    and the trajectories equal a run without streams."""
    arr, pred = arrivals
    kw = dict(scheduler=scheduler, window=2,
              predicted=pred if case == "mispredicted" else None,
              events="k_failures" if case == "k_failures" else None)
    ref, port = _both(arr, metrics=STREAMS, **kw)
    assert_bitwise(port, ref)
    assert_frames_bitwise(port.metrics, ref.metrics)
    assert port.metrics.n_slots == T and set(port.metrics.streams) == set(STREAMS)
    off = _both(arr, **kw)[1]
    assert_bitwise(port, off)
    np.testing.assert_array_equal(port.metrics.streams["backlog"][:, 0], port.backlog)


# ---------------------------------------------------------------------------
# paper profile: Shuffle at the reference's tolerances, POTUS at the chaos floor
# ---------------------------------------------------------------------------

PAPER_T = 100
PAPER_KW = dict(engine="cohort", V=1.0, warmup=20, drain_margin=30)


@pytest.fixture(scope="module")
def paper():
    return _paper(rc), _paper(pt)


def _paper_both(paper, scheduler, window, predicted=None):
    ref_sys, port_sys = paper
    arr = ref_sys[3]
    kw = dict(PAPER_KW, scheduler=scheduler, window=window, predicted=predicted)
    ref = rc.simulate(_spec(rc, ref_sys, arr, PAPER_T, **kw))
    port = pt.simulate(_spec(pt, port_sys, arr, PAPER_T, device="cpu", **kw))
    return ref, port


@pytest.mark.parametrize("mispredicted", [False, True])
@pytest.mark.parametrize("window", [0, 2])
def test_paper_shuffle_within_reference_tolerance(paper, window, mispredicted):
    arr = paper[0][3]
    pred = np.maximum(arr - 1, 0.0).astype(np.float32) if mispredicted else None
    ref, port = _paper_both(paper, "shuffle", window, pred)
    np.testing.assert_allclose(port.backlog, ref.backlog, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(port.comm_cost, ref.comm_cost, rtol=1e-5, atol=1e-3)
    assert port.avg_response == pytest.approx(ref.avg_response, rel=1e-3)
    assert port.p95_response == pytest.approx(ref.p95_response, rel=1e-3)
    assert port.n_cohorts == ref.n_cohorts


@pytest.mark.parametrize("scheduler", ["potus", "potus-loop"])
@pytest.mark.parametrize("window", [0, 2])
def test_paper_potus_within_chaos_floor(paper, scheduler, window):
    ref, port = _paper_both(paper, scheduler, window)
    # the chaos-floor bounds of tests/test_cohort_fused.py::TestPotusPaperSystem
    assert port.avg_response == pytest.approx(ref.avg_response, rel=0.10)
    assert port.p95_response == pytest.approx(ref.p95_response, rel=0.25)
    assert port.avg_backlog == pytest.approx(ref.avg_backlog, rel=0.10)
    assert port.avg_cost == pytest.approx(ref.avg_cost, rel=0.02)
    assert port.n_cohorts == ref.n_cohorts


# ---------------------------------------------------------------------------
# the port's fused engine against the port's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 2])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_fused_against_oracle_dyadic(arrivals, scheduler, window):
    """``tests/test_cohort_fused.py:91-103``: bitwise trajectories, POTUS
    within atol 1e-4 (its proportional split is the one non-dyadic value)."""
    sys_ = _dyadic(pt)
    kw = dict(KW, scheduler=scheduler, window=window, device="cpu")
    py = pt.simulate(_spec(pt, sys_, arrivals[0], engine="cohort", **kw))
    fu = pt.simulate(_spec(pt, sys_, arrivals[0], engine="cohort-fused", **kw))
    atol = 1e-4 if scheduler == "potus" else 0.0
    np.testing.assert_allclose(fu.backlog, py.backlog, rtol=0, atol=atol)
    np.testing.assert_allclose(fu.comm_cost, py.comm_cost, rtol=0, atol=atol)
    assert fu.avg_response == pytest.approx(py.avg_response, rel=0.02, abs=0.05)
    assert fu.n_cohorts == py.n_cohorts


@pytest.mark.parametrize("window", [0, 2])
def test_fused_against_oracle_mispredicted(arrivals, window):
    """``tests/test_cohort_fused.py:105-123``: Shuffle with a distinct
    prediction stream, trajectories bitwise."""
    arr, pred = arrivals
    sys_ = _dyadic(pt)
    kw = dict(KW, scheduler="shuffle", window=window, predicted=pred, device="cpu")
    py = pt.simulate(_spec(pt, sys_, arr, engine="cohort", **kw))
    fu = pt.simulate(_spec(pt, sys_, arr, engine="cohort-fused", **kw))
    np.testing.assert_array_equal(fu.backlog, py.backlog)
    np.testing.assert_array_equal(fu.comm_cost, py.comm_cost)
    assert fu.avg_response == pytest.approx(py.avg_response, rel=0.05, abs=0.05)
    assert fu.p95_response == pytest.approx(py.p95_response, rel=0.10, abs=0.2)


# ---------------------------------------------------------------------------
# run_sweep(engine="cohort")
# ---------------------------------------------------------------------------

SWEEP_T = 48
SWEEP_OPTS = dict(warmup=8, drain_margin=16)


def _sweeps(arrivals, spec, events=None, **opts):
    arr, pred = arrivals
    amap = {"a": arr, "mis": (arr, pred)}
    out = {}
    for name, mod, kw in (("ref", rc, {}), ("port", pt, {"device": "cpu"})):
        topo, net, placement = _dyadic(mod)
        ev = None if events is None else {"kfail": _trace(mod, topo, events, SWEEP_T)}
        out[name] = mod.run_sweep(topo, net, placement, amap, SWEEP_T, spec, engine="cohort",
                                  engine_opts=dict(SWEEP_OPTS, **opts), events=ev, **kw)
    return out["ref"], out["port"]


def test_sweep_equals_simulate_and_reference(arrivals):
    spec = pt.SweepSpec(V=(1.0, 2.0), beta=0.5, window=(0, 2), scheduler=("potus", "shuffle"),
                        arrival=("a", "mis"), events=("none", "kfail"))
    # the fused engine's options are dropped on the event loop, as in the reference
    ref, port = _sweeps(arrivals, spec, events="k_failures", age_cap=16, slots_per_launch=1)
    assert len(port) == len(ref) == spec.n_scenarios == 32
    assert port.n_batches == ref.n_batches == 32  # one partition a scenario
    assert [s.index for s in port.scenarios] == list(range(32))
    sys_ = _dyadic(pt)
    trace = _trace(pt, sys_[0], "k_failures", SWEEP_T)
    arr, pred = arrivals
    for (scn, p), (rscn, r) in zip(port, ref):
        assert _same_scenario(scn, rscn)
        assert_bitwise(p, r)
        one = pt.simulate(_spec(pt, sys_, arr, SWEEP_T, engine="cohort", device="cpu",
                                scheduler=scn.scheduler, V=scn.V, beta=scn.beta,
                                window=scn.window,
                                predicted=pred if scn.arrival == "mis" else None,
                                events=trace if scn.events == "kfail" else None,
                                **SWEEP_OPTS))
        assert_bitwise(p, one)


def _same_scenario(a, b) -> bool:
    return (a.index, a.V, a.beta, a.window, a.scheduler, a.arrival, a.events) == (
        b.index, b.V, b.beta, b.window, b.scheduler, b.arrival, b.events)


def test_sweep_metrics_frames_equal_reference(arrivals):
    spec = pt.SweepSpec(V=(1.0, 2.0), beta=0.5, window=(0, 2), scheduler="jsq", arrival="mis")
    ref, port = _sweeps(arrivals, spec, metrics=STREAMS)
    for (_, p), (_, r) in zip(port, ref):
        assert_bitwise(p, r)
        assert_frames_bitwise(p.metrics, r.metrics)


@pytest.mark.parametrize("opt", [{"service": 2.0}, {"chunk": 8}, {"slots_per_launch": 4},
                                 "sharded", "mu"])
def test_sweep_guards_raise_as_the_reference(arrivals, opt):
    """The fused engine's options and ``mu`` raise the normalized error on
    the event loop, and ``sharded`` the reference's own refusal — not
    "not ported yet"."""
    arr = arrivals[0]
    errors = []
    for mod, kw in ((rc, {}), (pt, {"device": "cpu"})):
        topo, net, placement = _dyadic(mod)
        spec = mod.SweepSpec(sharded=opt == "sharded")
        if opt == "mu":
            kw["mu"] = topo.inst_mu
        opts = opt if isinstance(opt, dict) else {}
        with pytest.raises(mod.UnsupportedEngineOption) as exc:
            mod.run_sweep(topo, net, placement, arr, 8, spec, engine="cohort",
                          engine_opts=opts, **kw)
        errors.append(exc.value)
    ref_err, port_err = errors
    assert (port_err.engine, port_err.option) == (ref_err.engine, ref_err.option)
    assert "not ported yet" not in str(port_err)
    assert port_err.nearest == ref_err.nearest


# ---------------------------------------------------------------------------
# the facade: defaults, options, no fallback
# ---------------------------------------------------------------------------

def test_cohort_defaults_to_cuda_and_never_falls_back(arrivals, monkeypatch):
    assert pt.EngineSpec.__dataclass_fields__["device"].default == "cuda"
    assert "cohort" in pt.PORTED_ENGINES

    def ran(*a, **k):
        raise AssertionError("the event loop ran although CUDA was asked for and absent")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pco._SlotScheduler, "__call__", ran)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.simulate(_spec(pt, _dyadic(pt), arrivals[0], engine="cohort"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pco._run_cohort_sim_impl(*_dyadic(pt), arrivals[0], None, 8, pt.SimConfig())
    topo, net, placement = _dyadic(pt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.run_sweep(topo, net, placement, arrivals[0], 8, pt.SweepSpec(), engine="cohort")


@pytest.mark.parametrize("option", [{"age_cap": 32}, {"chunk": 8}, {"service": 2.0},
                                    {"slots_per_launch": 2}, {"sharded": True},
                                    {"mu": "ones"}])
def test_cohort_options_raise_as_the_reference(arrivals, option):
    out = []
    for mod, kw in ((rc, {}), (pt, {"device": "cpu"})):
        sys_ = _dyadic(mod)
        opt = ({"mu": np.ones(sys_[0].n_instances, np.float32)} if "mu" in option
               else option)
        with pytest.raises(mod.UnsupportedEngineOption) as exc:
            mod.simulate(_spec(mod, sys_, arrivals[0], 8, engine="cohort", **opt, **kw))
        out.append(exc.value)
    assert (out[1].engine, out[1].option, out[1].nearest) == (
        out[0].engine, out[0].option, out[0].nearest)
    assert "not ported yet" not in str(out[1])


def test_use_pallas_is_accepted(arrivals):
    """The option matrix takes ``use_pallas`` on the event loop; it selects
    nothing (the device decides the kernels' route)."""
    sys_ = _dyadic(pt)
    kw = dict(KW, engine="cohort", scheduler="potus", window=2, device="cpu")
    a = pt.simulate(_spec(pt, sys_, arrivals[0], **kw))
    b = pt.simulate(_spec(pt, sys_, arrivals[0], use_pallas=True, **kw))
    assert_bitwise(a, b)
