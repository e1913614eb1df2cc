"""The port's compact slot step — the plain version of the CUDA slot kernel —
against the reference, on the dyadic system of ``tests/test_potus_slot.py``.

Both sides start from the same numbers: the reference builds its
``StepConsts``, state and arrival streams, and ``repro_torch.convert``
carries them across. The port runs in both fill variants (``kernel_safe``
False: sort water-fill; True: precedence-rank water-fill, what the kernel
computes) and is held against three reference routes: the compact XLA step
(``kernel_safe`` False and True) and the Pallas slot kernel in interpret
mode (``repro.kernels.ops.potus_slot_step``).

Tolerances: on the dyadic tier every quantity is a dyadic rational, so f32
sums are exact in any order and the match is bitwise (``assert_array_equal``).
In f64 the reference runs under the scoped ``jax.enable_x64(True)`` and the
bounds are the ones ``tests/test_potus_slot.py`` states for its f64 tier
(metrics rtol 1e-12 / atol 1e-9, state rtol 1e-10 / atol 1e-9), which catch
any silent f32 truncation.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    Component,
    SimConfig,
    build_topology,
    container_costs,
    fat_tree,
    spout_rate_matrix,
    t_heron_placement,
)
from repro.core import cohort_fused as rcf
from repro.core import compact as rcm
from repro.core.potus import _fill_components as ref_fill_components
from repro.core.potus import make_problem
from repro.core.simulator import materialize_arrivals
from repro.kernels import ops as rkops
from repro_torch import convert
from repro_torch.core import compact as pcm
from repro_torch.core.potus import _fill_components
from repro_torch.kernels import ops as pkops
from repro_torch.kernels import potus_slot as pps

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

T = 40
AGE_CAP = 16
W = 2
SCHEDULERS = ("potus", "shuffle", "jsq")


@lru_cache(maxsize=None)
def _system():
    apps = [
        [
            Component("src", 0, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
            Component("left", 0, False, 2, 4.0, successors=(3,)),
            Component("right", 0, False, 4, 4.0, successors=(3,)),
            Component("sink", 0, False, 2, 8.0),
        ],
        [
            Component("src", 1, True, 2, successors=(1,)),
            Component("mid", 1, False, 4, 4.0, successors=(2,)),
            Component("sink", 1, False, 2, 4.0),
        ],
    ]
    topo = build_topology(apps, gamma=64.0)
    sd, _ = fat_tree(4)
    net = container_costs("fat-tree", sd)
    placement = t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                  max_per_container=4)
    rng = np.random.default_rng(3)
    unit = spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + W + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + W + 1, *unit.shape)) < 0.8
    return topo, net, placement, (arr * (unit > 0)).astype(np.float32)


def _ref_setup(dtype):
    """Reference StepConsts, initial state and streams in ``dtype`` (the
    recipe of tests/test_potus_slot.py)."""
    topo, net, placement, arr = _system()
    cfg = SimConfig(V=2.0, beta=0.5, window=W)
    actual = materialize_arrivals(arr, topo, T + W + 1)
    prob = make_problem(topo, net, placement)
    cpt = rcf._compact(topo)
    act, pred, nxt, q_rem0 = rcf._prep_streams(actual, None, T, W, cpt, rcf._stream_mask(topo))
    dev = rcf._device_inputs(topo, net, cpt)
    I, C = topo.n_instances, topo.n_components
    Sc, W1 = q_rem0.shape[1:]
    Atot = AGE_CAP + W1
    state0 = (
        jnp.asarray(q_rem0, dtype), jnp.zeros((I, Sc), dtype), jnp.zeros((I, Atot), dtype),
        jnp.zeros((I, Sc, Atot), dtype), jnp.zeros((I, Atot), dtype),
        jnp.zeros((C, T + Atot), dtype), jnp.zeros((C, T + Atot), dtype),
    )
    xs = (jnp.asarray(act, dtype), jnp.asarray(pred, dtype), jnp.asarray(nxt, dtype))
    dev = {k: (v if v.dtype == jnp.int32 else v.astype(dtype)) for k, v in dev.items()}
    consts = rcm.StepConsts(
        U=dev["U"], mu=dev["mu"], inv_service=dev["inv_service"], sel_cmp=dev["sel_cmp"],
        stream_cmp=dev["stream_cmp"], valid_cmp=dev["valid_cmp"], succ_map=dev["succ_map"],
        term_f=dev["term_f"], comp_onehot=jax.nn.one_hot(prob.inst_comp, C, dtype=dtype),
        inst_comp=prob.inst_comp, inst_cont=prob.inst_container,
        gamma=prob.gamma.astype(dtype), comp_count=prob.comp_count.astype(dtype),
        spout_f=prob.is_spout.astype(dtype), adj_rows=dev["adj_rows"],
        V=jnp.asarray(cfg.V, dtype), beta=jnp.asarray(cfg.beta, dtype),
    )
    return consts, state0, xs


def _numpy(tree):
    return tuple(np.asarray(x) for x in tree)


@lru_cache(maxsize=None)
def _ref_run(scheduler: str, route: str, x64: bool):
    """(final state, (4, T) metrics) of one reference route, as numpy."""
    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        consts, state, (act, pred, nxt) = _ref_setup(dtype)
        if route == "pallas-interpret":
            mets = []
            for t0 in range(0, T, 4):
                state, m = rkops.potus_slot_step(
                    consts, state, act[t0:t0 + 4], pred[t0:t0 + 4], nxt[t0:t0 + 4],
                    jnp.int32(t0), scheduler=scheduler, age_cap=AGE_CAP, n_slots=4)
                mets.append(np.stack(_numpy(m)))
            return _numpy(state), np.concatenate(mets, axis=1)
        step = partial(rcm.compact_slot_step, consts, scheduler=scheduler, age_cap=AGE_CAP,
                       kernel_safe=route == "xla-kernel-safe")
        final, ys = jax.lax.scan(step, state, (act, pred, nxt, jnp.arange(T)))
        return _numpy(final), np.stack(_numpy(ys))


def _port_inputs(x64: bool):
    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        consts, state, xs = _ref_setup(dtype)
        consts_np = {k: np.asarray(v) for k, v in consts._asdict().items()}
        state_np, xs_np = _numpy(state), _numpy(xs)
    tdt = torch.float64 if x64 else torch.float32
    return (convert.step_consts_from_numpy(consts_np, dtype=tdt),
            convert.state_from_numpy(state_np, dtype=tdt),
            tuple(torch.as_tensor(np.array(x), dtype=tdt) for x in xs_np))


def _port_run(scheduler: str, kernel_safe: bool, x64: bool = False):
    consts, state, (act, pred, nxt) = _port_inputs(x64)
    mets = []
    for t in range(T):
        state, m = pcm.compact_slot_step(consts, state, (act[t], pred[t], nxt[t], t),
                                         scheduler=scheduler, age_cap=AGE_CAP,
                                         kernel_safe=kernel_safe)
        mets.append(torch.stack(m))
    return tuple(x.numpy() for x in state), torch.stack(mets, dim=1).numpy()


def _port_launches(scheduler: str, K: int):
    """The plain slot step through the device-routed wrapper, K slots a call."""
    consts, state, (act, pred, nxt) = _port_inputs(False)
    mets = []
    for t0 in range(0, T, K):
        n = min(K, T - t0)
        state, m = pkops.potus_slot_step(consts, state, act[t0:t0 + n], pred[t0:t0 + n],
                                         nxt[t0:t0 + n], t0, scheduler=scheduler,
                                         age_cap=AGE_CAP, n_slots=n)
        mets.append(torch.stack(m))
    return tuple(x.numpy() for x in state), torch.cat(mets, dim=1).numpy()


@pytest.mark.parametrize("ref_route", ["xla", "xla-kernel-safe", "pallas-interpret"])
@pytest.mark.parametrize("kernel_safe", [False, True])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_f32_bitwise_against_reference(scheduler, kernel_safe, ref_route):
    ref_state, ref_met = _ref_run(scheduler, ref_route, False)
    state, met = _port_run(scheduler, kernel_safe)
    assert met.dtype == np.float32
    # dyadic tier: every sum is exact in f32, so the match is bitwise
    np.testing.assert_array_equal(met, ref_met)
    for x, y in zip(state, ref_state):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ref_route", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_f64_against_reference(scheduler, ref_route):
    ref_state, ref_met = _ref_run(scheduler, ref_route, True)
    assert ref_met.dtype == np.float64  # the scoped x64 switch took effect
    state, met = _port_run(scheduler, kernel_safe=True, x64=True)
    assert state[0].dtype == np.float64  # no silent f32 truncation in the port
    # tolerances of the f64 tier of tests/test_potus_slot.py
    np.testing.assert_allclose(met[:2], ref_met[:2], rtol=1e-12, atol=1e-9)
    for x, y in zip(state, ref_state):
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-9)
    assert not jax.config.jax_enable_x64  # the switch stayed scoped


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_k_slot_call_equals_one_slot_calls(scheduler):
    """K one-slot calls of the plain version equal K-slot calls, bitwise
    (the slot loop changes no arithmetic), and both equal the port's scan."""
    s1, m1 = _port_launches(scheduler, 1)
    s7, m7 = _port_launches(scheduler, 7)
    np.testing.assert_array_equal(m1, m7)
    for x, y in zip(s1, s7):
        np.testing.assert_array_equal(x, y)
    s, m = _port_run(scheduler, kernel_safe=True)
    np.testing.assert_array_equal(m1, m)


def test_fill_components_matches_reference():
    """Sort water-fill on rows with price ties (lowest index wins, exact)."""
    rng = np.random.default_rng(0)
    R, C, I = 64, 6, 50
    m = rng.integers(-4, 0, (R, C)).astype(np.float32)
    m[rng.random((R, C)) < 0.3] = np.inf
    j = np.stack([rng.permutation(I)[:C] for _ in range(R)]).astype(np.int32)
    budget = np.where(np.isfinite(m), rng.integers(0, 5, (R, C)), 0).astype(np.float32)
    gamma = rng.integers(1, 12, R).astype(np.float32)
    fill, j_sorted, perm = _fill_components(torch.as_tensor(m), torch.as_tensor(j),
                                            torch.as_tensor(budget), torch.as_tensor(gamma))
    for r in range(R):
        rf, rj, rp = ref_fill_components(jnp.asarray(m[r]), jnp.asarray(j[r]),
                                         jnp.asarray(budget[r]), jnp.asarray(gamma[r]))
        np.testing.assert_array_equal(fill[r].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(j_sorted[r].numpy(), np.asarray(rj))
        np.testing.assert_array_equal(perm[r].numpy(), np.asarray(rp))


def test_kernel_layout_groups_rows():
    comp_start, cont_rows, cont_start = pcm.kernel_layout(
        np.array([0, 0, 1, 1, 1, 2]), np.array([2, 0, 2, 1, 0, 2]), 3, 3)
    np.testing.assert_array_equal(comp_start, [0, 2, 5, 6])
    np.testing.assert_array_equal(cont_rows, [1, 4, 3, 0, 2, 5])
    np.testing.assert_array_equal(cont_start, [0, 2, 3, 6])
    with pytest.raises(ValueError, match="grouped by component"):
        pcm.kernel_layout(np.array([0, 1, 0]), np.array([0, 0, 0]), 2, 1)


def test_wrapper_routes_by_device_and_cuda_call_refuses_cpu():
    consts, state, (act, pred, nxt) = _port_inputs(False)
    args = (consts, state, act[:2], pred[:2], nxt[:2], 0)
    kw = dict(scheduler="potus", age_cap=AGE_CAP, n_slots=2)
    pps.launches.reset()
    out_state, out_met = pkops.potus_slot_step(*args, **kw)
    ref_state, ref_met = pps.potus_slot_step_plain(*args, **kw)
    for x, y in zip(out_state + out_met, ref_state + ref_met):
        assert torch.equal(x, y)
    assert pps.launches.n == 0  # the plain version is no kernel launch
    with pytest.raises(ValueError, match="CUDA"):
        pps.potus_slot_call(*args, **kw)
    with pytest.raises(ValueError, match="accumulator"):
        pps.potus_slot_step_plain(consts, state, act[:2], pred[:2], nxt[:2], T + 1, **kw)
