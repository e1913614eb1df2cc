"""The fused cohort engine's dense route — ``scheduler="potus-loop"``,
``_fused_step`` with the drain and split of ``kernels.ops.cohort_drain_split``
— against the reference, and the engine's routing, on the CPU.

* Dyadic tier (the system and draw of
  ``tests/test_cohort_fused.py::TestPallasDrain``: powers-of-two arrivals,
  T=40, W=1, age_cap 16): ``backlog``, ``comm_cost``, ``avg_response`` and
  ``completed_mass`` match the reference bitwise, against both of its
  routes (``use_pallas`` False: one product per DAG edge; True: the Pallas
  drain kernel in interpret mode), with and without ``chunk=``, with and
  without a non-trivial ``service=``. The split ratio ``X / shipped`` need
  not be exact in general (the reference holds its own two routes to rtol
  1e-5 / atol 1e-3 for that reason), but on this system every ratio is a
  multiple of 1/64 — the greedy gives one target a component's whole
  budget and the even split divides by a parallelism of 2 or 4 — so every
  product and sum is exact, and the match is bitwise. The test checks that
  premise on every slot's ratios.
* Routing: which of ``kernels.ops``'s wrappers each route calls, counted
  through ``ops=``; and ``_run_cohort_fused_impl`` asks for CUDA unless
  the caller names the CPU.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro_torch.core import cohort_fused as pcf
from repro_torch.kernels import ops as pkops

from test_torch_engine import _dyadic, _pow2_arrivals

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T = 40
DENSE_KW = dict(scheduler="potus-loop", V=2.0, window=1, age_cap=16, warmup=4, drain_margin=8)
# a token-length service axis: half the instances take 2 units per tuple, half 0.5
SERVICE = np.where(np.arange(18) % 2, 2.0, 0.5).astype(np.float32)


def _case():
    ref_sys, port_sys = _dyadic(rc), _dyadic(pt)
    return ref_sys, port_sys, _pow2_arrivals(ref_sys[0], T + 8, seed=5)


def _spec(mod, sys_, arr, **kw):
    return mod.EngineSpec(topo=sys_[0], net=sys_[1], placement=sys_[2], arrivals=arr, T=T,
                          **kw)


@pytest.mark.parametrize("service", [None, SERVICE], ids=["service=None", "service=2|0.5"])
@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_route_dyadic_bitwise(use_pallas, chunk, service):
    ref_sys, port_sys, arr = _case()
    kw = dict(DENSE_KW, chunk=chunk, service=service)
    ref = rc.simulate(_spec(rc, ref_sys, arr, use_pallas=use_pallas, **kw))
    port = pt.simulate(_spec(pt, port_sys, arr, device="cpu", **kw))
    np.testing.assert_array_equal(port.backlog, ref.backlog)
    np.testing.assert_array_equal(port.comm_cost, ref.comm_cost)
    assert np.isfinite(port.avg_response) and port.avg_response == ref.avg_response
    assert port.completed_mass == ref.completed_mass > 0
    assert port.n_cohorts == ref.n_cohorts


def test_dense_route_split_ratios_are_exact_on_the_dyadic_system():
    """The premise of the bitwise tier above: every slot's split ratios are
    multiples of 1/64, and some are neither 0 nor 1."""
    _, port_sys, arr = _case()
    seen = []

    def drain_split(src, ship, ratio, comp, age_bucket):
        seen.append(ratio.clone())
        return pkops.cohort_drain_split(src, ship, ratio, comp, age_bucket)

    ops = SimpleNamespace(**vars(pkops.plain))
    ops.cohort_drain_split = drain_split
    pcf._run_cohort_fused_impl(port_sys[0], port_sys[1], port_sys[2], arr, None, T,
                               pt.SimConfig(V=2.0, window=1, scheduler="potus-loop"),
                               age_cap=16, device="cpu", ops=ops)
    assert len(seen) == T
    ratios = torch.stack(seen)
    assert torch.equal(ratios * 64, torch.round(ratios * 64))
    assert bool(((ratios > 0) & (ratios < 1)).any())


def _counting_ops():
    counts = {name: 0 for name in vars(pkops.plain)}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    ops = SimpleNamespace(**{name: counted(name, fn) for name, fn in vars(pkops.plain).items()})
    return ops, counts


@pytest.mark.parametrize("scheduler, events, expect", [
    ("potus", False, {"potus_slot_step": T}),
    ("shuffle", True, {}),  # the caps fold: compact_slot_step, no slot-kernel wrapper
    ("potus-loop", False, {"potus_price": T, "cohort_drain_split": T}),
    ("potus-loop", True, {"potus_price": T, "cohort_drain_split": T}),
])
def test_each_route_calls_its_wrappers(scheduler, events, expect):
    _, port_sys, arr = _case()
    ops, counts = _counting_ops()
    trace = pt.identity_trace(port_sys[0], T) if events else None
    res = pcf._run_cohort_fused_impl(port_sys[0], port_sys[1], port_sys[2], arr, None, T,
                                     pt.SimConfig(V=2.0, window=1, scheduler=scheduler),
                                     age_cap=16, events=trace, device="cpu", ops=ops)
    assert counts == {name: expect.get(name, 0) for name in counts}
    assert res.backlog.shape == (T,) and np.isfinite(res.backlog).all()


def test_run_cohort_fused_impl_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """A caller that names no device asks for the card: without one the run
    raises instead of building CPU tensors that would take the plain
    versions."""
    _, port_sys, arr = _case()
    args = (port_sys[0], port_sys[1], port_sys[2], arr, None, 8, pt.SimConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcf._run_cohort_fused_impl(*args)
    # the CPU is taken when asked for by name
    assert pcf._run_cohort_fused_impl(*args, device="cpu").backlog.shape == (8,)
