"""``events=`` on the port's fused cohort engine against the reference, on both
of its routes: the compact step with the caps fold (``potus``, ``shuffle``,
``jsq``) and the dense ``_fused_step`` (``potus-loop``). The traces compile
from the port's own ``core/events.py`` and from the reference's.

* Dyadic tier (the system of ``tests/test_cohort_fused.py``, T=120, W=2):
  - an identity trace changes nothing — the result equals the run without
    events bitwise — and equals the reference's bitwise;
  - a ``rolling_restart`` of the parallelism-2 components' instances, and a
    ``k_failures`` whose two picks (``rng`` seed 1) fall in a parallelism-2
    component: while an instance is down its component has 1 alive, so the
    even split of eq. (4) stays exact and ``backlog``, ``comm_cost``,
    ``avg_response`` and ``completed_mass`` equal the reference's bitwise,
    against both of its routes (``use_pallas`` False and True), with and
    without ``chunk=`` (each chunk gets its slice of the trace).
* Paper profile with a 20%-of-bolts ``k_failures``: POTUS amplifies rounding
  differences through price near-ties (DESIGN.md §8), so long-run means are
  compared with the chaos-floor bounds of
  ``tests/test_cohort_fused.py::TestPotusPaperSystem``.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt

from test_torch_engine import _dyadic, _paper, _pow2_arrivals

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T = 120
KW = dict(V=2.0, beta=0.5, window=2, age_cap=32, warmup=10, drain_margin=30)
SCHEDULERS = ("potus", "shuffle", "jsq", "potus-loop")


def _trace(mod, topo, kind, n_slots=T):
    if kind == "identity":
        return mod.identity_trace(topo, n_slots)
    if kind == "rolling_restart":
        pairs = [int(i) for i in range(topo.n_instances)
                 if topo.comp_parallelism[topo.inst_comp[i]] == 2]
        return mod.rolling_restart(topo, start=10, down_slots=6, stagger=3,
                                   instances=pairs).compile(topo, n_slots)
    k = 2 if kind == "k_failures" else max(1, len(topo.bolt_instances) // 5)
    return mod.k_failures(topo, k, start=20, duration=30,
                          rng=np.random.default_rng(1)).compile(topo, n_slots)


def _spec(mod, sys_, arr, n_slots, **kw):
    return mod.EngineSpec(topo=sys_[0], net=sys_[1], placement=sys_[2], arrivals=arr,
                          T=n_slots, **kw)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.backlog, b.backlog)
    np.testing.assert_array_equal(a.comm_cost, b.comm_cost)
    assert a.avg_response == b.avg_response
    assert a.completed_mass == b.completed_mass
    assert a.n_cohorts == b.n_cohorts


@pytest.mark.parametrize("chunk", [None, 48])
@pytest.mark.parametrize("kind", ["identity", "rolling_restart", "k_failures"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_events_dyadic_bitwise(scheduler, kind, chunk):
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    arr = _pow2_arrivals(ref_sys[0], T + 16, seed=3)
    kw = dict(KW, scheduler=scheduler, chunk=chunk)
    port = pt.simulate(_spec(pt, port_sys, arr, T, device="cpu",
                             events=_trace(pt, port_sys[0], kind), **kw))
    assert np.isfinite(port.avg_response) and port.completed_mass > 0
    for use_pallas in (False, True):
        ref = rc.simulate(_spec(rc, ref_sys, arr, T, use_pallas=use_pallas,
                                events=_trace(rc, ref_sys[0], kind), **kw))
        _assert_bitwise(port, ref)
    none = pt.simulate(_spec(pt, port_sys, arr, T, device="cpu", **kw))
    if kind == "identity":
        _assert_bitwise(port, none)  # the identity trace is bit-transparent
    else:
        assert not np.array_equal(port.backlog, none.backlog)  # the disruption bites


@pytest.mark.parametrize("scheduler", ["potus", "potus-loop"])
def test_paper_profile_k_failures_within_chaos_floor(scheduler):
    ref_sys, port_sys = _paper(rc), _paper(pt)
    arr = ref_sys[3]
    kw = dict(scheduler=scheduler, V=1.0, window=2)
    ref = rc.simulate(_spec(rc, ref_sys, arr, 240, events=_trace(rc, ref_sys[0], "k20", 240),
                            **kw))
    port = pt.simulate(_spec(pt, port_sys, arr, 240, device="cpu",
                             events=_trace(pt, port_sys[0], "k20", 240), **kw))
    # the chaos-floor bounds of tests/test_cohort_fused.py::TestPotusPaperSystem
    assert port.avg_response == pytest.approx(ref.avg_response, rel=0.10)
    assert port.avg_backlog == pytest.approx(ref.avg_backlog, rel=0.10)
    assert port.avg_cost == pytest.approx(ref.avg_cost, rel=0.02)
    assert port.n_cohorts == ref.n_cohorts
