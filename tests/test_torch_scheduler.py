"""The port's schedulers and the plain versions of its two schedule kernels
against the reference, on the CPU.

* ``potus_schedule`` (sort and loop) against the reference's own sort and
  loop paths on random DAG systems and on tie-heavy synthetic problems (the
  pattern of ``tests/test_fastpath.py``), with and without a disruption
  slot. Queues and capacities are integral and every price is an integer,
  so the allocations are exact in f32 in any order: ``assert_array_equal``.
  The loop is also held against the port's copy of the f64 oracle
  ``core/reference.py``, at a dyadic ``beta`` only: at a non-dyadic
  ``beta`` the reference's own f32 paths differ from that oracle at
  near-ties.
* The plain version of the fused schedule kernel against the reference's
  Pallas kernel in interpret mode (``potus_schedule_call``), at the shapes
  of ``tests/test_kernels.py::TestPotusFusedSchedule``, and the plain price
  matrix against ``kernels/ref.py::potus_price_reference`` and the Pallas
  price kernel at the shapes of ``tests/test_kernels.py::TestPotusPrice``:
  ``rtol/atol 1e-5`` on finite entries (the Pallas kernels form their
  gathers as f32 one-hot matmuls and their water-fill as a rank sum), +inf
  in the same places.
* Shuffle and JSQ, and the disruption fold (``apply_caps``,
  ``hold_mask_for``) under one ``rolling_restart`` slot: equal.
* The CUDA wrappers raise on CPU tensors; ``kernels.ops`` routes CPU
  tensors to the plain versions.
"""
import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as pt
from repro.core import potus as rpotus
from repro.kernels import ref as rref
from repro.kernels.potus_price import potus_price_call as ref_price_call
from repro.kernels.potus_schedule import potus_schedule_call as ref_schedule_call
from repro_torch import convert
from repro_torch.core import baselines as pbase
from repro_torch.core import potus as ppotus
from repro_torch.kernels import ops as pkops
from repro_torch.kernels import potus_price as pprice
from repro_torch.kernels import potus_schedule as psched

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)


@lru_cache(maxsize=None)
def _random_system(seed: int, n_apps: int = 3):
    """``tests/test_fastpath.py::_random_system`` for both packages."""
    out = []
    for mod in (rc, pt):
        rng = np.random.default_rng(seed)
        topo = mod.build_topology(mod.random_apps(rng, n_apps=n_apps),
                                  gamma=float(rng.integers(4, 32)))
        sd, _ = mod.fat_tree(4)
        net = mod.container_costs("ft", sd)
        rates = mod.feasible_rates(topo, utilization=0.7)
        out.append((topo, net, mod.t_heron_placement(topo, net, rates, max_per_container=8)))
    return tuple(out)


def _integral_inputs(topo, rng, q_scale=10.0):
    """``tests/test_fastpath.py::_integral_inputs``: integral queues and
    spout-only mandatory arrivals."""
    I, C = topo.n_instances, topo.n_components
    q_in = np.round(rng.uniform(0, q_scale, I)).astype(np.float32)
    q_in[topo.comp_is_spout[topo.inst_comp]] = 0.0
    succ_mask = topo.adj[topo.inst_comp]
    q_out = np.round(rng.uniform(0, q_scale, (I, C))).astype(np.float32) * succ_mask
    spout = topo.comp_is_spout[topo.inst_comp]
    must = np.minimum(q_out, np.round(rng.uniform(0, 3, (I, C)))).astype(np.float32)
    must *= succ_mask * spout[:, None]
    return q_in, q_out, must


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _caps_pair(alive, mu, gamma):
    """The same disruption slot for both packages."""
    ref = rpotus.caps_for_slot(jnp.asarray(mu), jnp.asarray(gamma), jnp.asarray(alive))
    port = ppotus.caps_for_slot(_t(mu), _t(gamma), _t(alive))
    return ref, port


def _both_schedules(ref_prob, U, q_in, q_out, must, V, beta, method, caps=(None, None),
                    ref_fn=rpotus.potus_schedule, port_fn=None):
    port_prob = convert.sched_problem_from_numpy(ref_prob)
    kw = {} if ref_fn is not rpotus.potus_schedule else {"method": method}
    want = np.asarray(ref_fn(ref_prob, jnp.asarray(U), jnp.asarray(q_in), jnp.asarray(q_out),
                             jnp.asarray(must), V, beta, caps=caps[0], **kw))
    port_fn = port_fn or ppotus.potus_schedule
    got = port_fn(port_prob, _t(U), _t(q_in), _t(q_out), _t(must), V, beta, caps=caps[1], **kw)
    return got.numpy(), want


@pytest.mark.parametrize("method", ["sort", "loop"])
@pytest.mark.parametrize("seed", range(6))
def test_potus_schedule_random_dags_equal(seed, method):
    (topo, net, placement), _ = _random_system(seed)
    q_in, q_out, must = _integral_inputs(topo, np.random.default_rng(seed + 1000))
    prob = rc.make_problem(topo, net, placement)
    got, want = _both_schedules(prob, net.U, q_in, q_out, must, 2.0, 1.0, method)
    np.testing.assert_array_equal(got, want)


def _tie_problem(seed):
    """``tests/test_fastpath.py::test_adversarial_ties``: tiny integer grids."""
    rng = np.random.default_rng(seed)
    I, C, K = 40, 6, 4
    inst_comp = rng.integers(0, C, I).astype(np.int32)
    edge_mask = (rng.random((I, I)) < 0.35) & (inst_comp[:, None] != inst_comp[None, :])
    comp_count = np.maximum(np.bincount(inst_comp, minlength=C), 1).astype(np.float32)
    gamma = rng.integers(1, 8, I).astype(np.float32)
    placement = rng.integers(0, K, I).astype(np.int32)
    U = rng.integers(0, 3, (K, K)).astype(np.float32)
    q_in = rng.integers(0, 4, I).astype(np.float32)
    q_out = rng.integers(0, 6, (I, C)).astype(np.float32)
    must = (rng.integers(0, 3, (I, C)) * (rng.random((I, C)) < 0.3)).astype(np.float32)
    prob = rpotus.SchedProblem(
        edge_mask=jnp.asarray(edge_mask), inst_comp=jnp.asarray(inst_comp),
        inst_container=jnp.asarray(placement), gamma=jnp.asarray(gamma),
        comp_count=jnp.asarray(comp_count), is_spout=jnp.zeros((I,), bool),
        max_succ=I, n_components=C)
    return prob, U, q_in, q_out, must


@pytest.mark.parametrize("method", ["sort", "loop"])
@pytest.mark.parametrize("seed", range(6))
def test_potus_schedule_adversarial_ties_equal(seed, method):
    prob, U, q_in, q_out, must = _tie_problem(seed)
    got, want = _both_schedules(prob, U, q_in, q_out, must, 2.0, 1.0, method)
    np.testing.assert_array_equal(got, want)


def _alive(I, seed):
    rng = np.random.default_rng(seed)
    alive = (rng.random(I) > 0.25).astype(np.float32)
    return alive, rng


@pytest.mark.parametrize("beta", [1.0, 0.5])
@pytest.mark.parametrize("problem", ["random_dag", "ties"])
@pytest.mark.parametrize("seed", range(4))
def test_loop_matches_the_integer_oracle(seed, problem, beta):
    """The port's ``method="loop"`` against its own copy of the f64 oracle
    ``core/reference.py``, on integral problems at a dyadic ``beta``: every
    price is exact in f32, so the greedy picks the same targets, and X
    agrees within the bounds of ``tests/test_fastpath.py`` (the even split
    may divide by 3). At a non-dyadic ``beta`` the reference's own f32 paths
    leave the oracle at near-ties, so none is held there."""
    from repro_torch.core.reference import potus_schedule_reference

    if problem == "random_dag":
        _, (topo, net, placement) = _random_system(seed)
        q_in, q_out, must = _integral_inputs(topo, np.random.default_rng(seed + 1000))
        port_prob = ppotus.make_problem(topo, net, placement, device="cpu")
        U = net.U
        oracle_args = (topo.edge_mask_instances(), topo.inst_comp, placement,
                       topo.comp_parallelism, topo.inst_gamma)
    else:
        ref_prob, U, q_in, q_out, must = _tie_problem(seed)
        # the oracle splits a shortfall over a row's edge targets, the batched
        # paths over comp_count: they agree only where a row reaches every
        # instance of a component, as on a topology, not on this random mask
        must = np.zeros_like(must)
        port_prob = convert.sched_problem_from_numpy(ref_prob)
        oracle_args = tuple(np.asarray(getattr(ref_prob, f)) for f in (
            "edge_mask", "inst_comp", "inst_container", "comp_count", "gamma"))
    got = ppotus.potus_schedule(port_prob, _t(U), _t(q_in), _t(q_out), _t(must), 2.0, beta,
                                method="loop").numpy()
    want = potus_schedule_reference(*oracle_args, U, q_in, q_out, must, 2.0, beta)
    assert want.sum() > 0  # something shipped: the check is not vacuous
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("scheduler", ["sort", "loop", "shuffle", "jsq"])
@pytest.mark.parametrize("seed", range(3))
def test_schedulers_under_caps_equal(seed, scheduler):
    """A random liveness slot with degraded capacities: both packages fold it
    into the same allocation on every scheduler."""
    (topo, net, placement), _ = _random_system(seed)
    q_in, q_out, must = _integral_inputs(topo, np.random.default_rng(seed + 2000))
    alive, rng = _alive(topo.n_instances, seed)
    gamma = topo.inst_gamma * alive * rng.integers(1, 3, topo.n_instances)
    mu = topo.inst_mu * alive
    caps = _caps_pair(alive, mu, gamma.astype(np.float32))
    prob = rc.make_problem(topo, net, placement)
    fns = {"shuffle": (rc.shuffle_schedule, pbase.shuffle_schedule),
           "jsq": (rc.jsq_schedule, pbase.jsq_schedule)}
    ref_fn, port_fn = fns.get(scheduler, (rpotus.potus_schedule, None))
    got, want = _both_schedules(prob, net.U, q_in, q_out, must, 2.0, 1.0, scheduler, caps,
                                ref_fn=ref_fn, port_fn=port_fn)
    np.testing.assert_array_equal(got, want)
    dead = alive == 0.0
    assert np.abs(got[dead, :]).max(initial=0.0) == 0.0
    assert np.abs(got[:, dead]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("scheduler", ["shuffle", "jsq"])
@pytest.mark.parametrize("seed", range(4))
def test_baselines_equal(seed, scheduler):
    (topo, net, placement), _ = _random_system(seed)
    rng = np.random.default_rng(seed + 3000)
    q_in, q_out, must = _integral_inputs(topo, rng)
    q_in = q_in + rng.uniform(0, 1, q_in.shape).astype(np.float32)  # non-integral: same ops
    prob = rc.make_problem(topo, net, placement)
    ref_fn = {"shuffle": rc.shuffle_schedule, "jsq": rc.jsq_schedule}[scheduler]
    port_fn = {"shuffle": pt.shuffle_schedule, "jsq": pt.jsq_schedule}[scheduler]
    got, want = _both_schedules(prob, net.U, q_in, q_out, must, 2.0, 1.0, None,
                                ref_fn=ref_fn, port_fn=port_fn)
    np.testing.assert_array_equal(got, want)


def test_caps_fold_under_rolling_restart_slot_equal():
    (topo_r, net, placement), (topo_p, _, _) = _random_system(1)
    T, slot = 30, 12
    tr_r = rc.rolling_restart(topo_r, start=4, down_slots=3, stagger=2).compile(topo_r, T)
    tr_p = pt.rolling_restart(topo_p, start=4, down_slots=3, stagger=2).compile(topo_p, T)
    np.testing.assert_array_equal(tr_r.alive_t, tr_p.alive_t)
    assert (tr_r.alive_t[slot] == 0.0).any()
    caps_r, caps_p = _caps_pair(tr_r.alive_t[slot], tr_r.mu_t[slot], tr_r.gamma_t[slot])
    prob_r = rc.make_problem(topo_r, net, placement)
    prob_p = pt.make_problem(topo_p, net, placement, device="cpu")
    must = _integral_inputs(topo_r, np.random.default_rng(8))[2]
    folded_r, must_r = rpotus.apply_caps(prob_r, jnp.asarray(must), caps_r)
    folded_p, must_p = ppotus.apply_caps(prob_p, _t(must), caps_p)
    np.testing.assert_array_equal(must_p.numpy(), np.asarray(must_r))
    for f in dataclasses.fields(folded_p):
        a, b = getattr(folded_p, f.name), getattr(folded_r, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(ppotus.hold_mask_for(prob_p, caps_p).numpy(),
                                  np.asarray(rpotus.hold_mask_for(prob_r, caps_r)))


@pytest.mark.parametrize("I,K,C", [(60, 8, 6), (128, 16, 10), (96, 4, 3), (250, 32, 24)])
def test_plain_schedule_alloc_matches_pallas_kernel(I, K, C):
    """``tests/test_kernels.py::TestPotusFusedSchedule`` inputs."""
    rng = np.random.default_rng(0)
    inst_comp = rng.integers(0, C, I).astype(np.int32)
    mask = (rng.random((I, I)) < 0.25) & (inst_comp[:, None] != inst_comp[None, :])
    U = rng.integers(0, 5, (K, K)).astype(np.float32)
    q_in = rng.integers(0, 8, I).astype(np.float32)
    q_out = rng.integers(0, 8, (I, C)).astype(np.float32)
    gamma = rng.integers(1, 12, I).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    want = np.asarray(ref_schedule_call(jnp.asarray(U), jnp.asarray(q_in), jnp.asarray(q_out),
                                        jnp.asarray(kc), jnp.asarray(inst_comp),
                                        jnp.asarray(mask), jnp.asarray(gamma), V=2.0,
                                        beta=1.0))
    args = (_t(U), _t(q_in), _t(q_out), _t(kc, torch.int32), _t(inst_comp, torch.int32),
            _t(mask, torch.bool), _t(gamma), 2.0, 1.0)
    got = psched.potus_schedule_alloc_plain(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pkops.potus_schedule_alloc(*args).numpy(), got)


@pytest.mark.parametrize("I,K,C", [(60, 8, 12), (128, 32, 16), (256, 16, 24)])
def test_plain_price_matches_reference_and_pallas_kernel(I, K, C):
    """``tests/test_kernels.py::TestPotusPrice`` inputs."""
    rng = np.random.default_rng(0)
    U = rng.uniform(0, 6, (K, K)).astype(np.float32)
    q_in = rng.uniform(0, 20, I).astype(np.float32)
    q_out = rng.uniform(0, 20, (I, C)).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    comp = rng.integers(0, C, I).astype(np.int32)
    mask = rng.random((I, I)) < 0.2
    jargs = tuple(jnp.asarray(x) for x in (U, q_in, q_out, kc, comp, mask))
    args = (_t(U), _t(q_in), _t(q_out), _t(kc, torch.int32), _t(comp, torch.int32),
            _t(mask, torch.bool), 3.0, 1.0)
    got = pprice.potus_price_plain(*args).numpy()
    for want in (np.asarray(rref.potus_price_reference(*jargs, 3.0, 1.0)),
                 np.asarray(ref_price_call(*jargs, V=3.0, beta=1.0))):
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert (got[~fin] == np.inf).all()
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pkops.potus_price(*args).numpy(), got)


def test_cuda_wrappers_refuse_cpu_tensors():
    prob, U, q_in, q_out, _ = _tie_problem(0)
    p = convert.sched_problem_from_numpy(prob)
    base = (_t(U), _t(q_in), _t(q_out), p.inst_container, p.inst_comp, p.edge_mask)
    pprice.launches.reset()
    psched.launches.reset()
    with pytest.raises(ValueError, match="CUDA kernel"):
        pprice.potus_price_call(*base, 2.0, 1.0)
    with pytest.raises(ValueError, match="CUDA kernel"):
        psched.potus_schedule_call(*base, p.gamma, 2.0, 1.0)
    assert pprice.launches.n == psched.launches.n == 0
