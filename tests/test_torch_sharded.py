"""The port's instance-sharded engines (DESIGN.md §7, §13) against the
reference: ``EngineSpec(engine="cohort-fused", sharded=True)``,
``engine="sharded"``, ``sharded_schedule``/``sharded_schedule_batch``,
sharded sweeps and ``DispatcherConfig(sharded=True)``.

* A world of one, in this process (no process group: every collective is
  the identity): the counterparts of ``tests/test_sharded_cohort.py`` —
  ``sharded=True`` equals the port's dense engine bitwise on any input, and
  the reference's ``sharded=True`` on its one-device mesh bitwise on the
  dyadic tier (potus, shuffle, jsq, with and without a rolling restart;
  chunks; the slot-kernel route under ``use_pallas``; a sweep); the raises;
  ``engine="sharded"`` against the reference's on one device; the
  schedules against the reference's ``potus_schedule``.
* One four-rank gloo world (``distributed.world.spawn_world``), started
  once for the module with a timeout of its own, on the system of
  ``tests/test_distributed.py:142-210`` (I=16, T=30): each case equals the
  reference's dense ``cohort-fused`` run (``engine="sharded"``: the
  reference's ``engine="jax"``) bitwise on the dyadic tier, every rank's
  result is the same, the metric streams equal the dense streams, and the
  counted payload equals ``cohort_slot_payload_floats`` and ``2I + 5``.
* One three-rank world: the mesh takes 2 ranks, and the idle third rank
  returns the same result.

The dyadic tier needs every split to stay a power of two: the rolling
restart here takes down instances of two-instance components. The
reference test's own restart (instances 1, 5, 9) leaves "mid" with 3 alive
instances, so its even splits divide by 3 and the ranks' partial sums
re-associate: held within rel 1e-6 here (the reference's 4-device run parts
from its dense run there too, on ``shuffle`` with that trace).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import potus as rpotus
from repro.core import sharded as rsh
import repro_torch.core as pt
from repro_torch.core import cohort_fused as pcf
from repro_torch.core import sharded as psh
from repro_torch.distributed import PAYLOAD, Axis, spawn_world
from repro_torch.distributed.world import call_each

torch.set_num_threads(1)

T = 30
#: the restart of the dyadic tier (each instance in a two-instance component)
#: and the reference test's (``tests/test_distributed.py``: "mid" falls to 3)
RESTARTS = {"dyadic": (1, 7, 11), "thirds": (1, 5, 9)}
WORLD_TIMEOUT_S = 120


def _system(mod):
    """``tests/test_sharded_cohort.py``'s dyadic system (I=16) in ``mod``."""
    C = mod.Component
    apps = [
        [C("src", 0, True, 2, successors=(1,)),
         C("mid", 0, False, 4, 4.0, successors=(2,)),
         C("sink", 0, False, 2, 4.0)],
        [C("src", 1, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
         C("a", 1, False, 2, 4.0, successors=(3,)),
         C("b", 1, False, 2, 4.0, successors=(3,)),
         C("sink", 1, False, 2, 8.0)],
    ]
    topo = mod.build_topology(apps, gamma=64.0)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    placement = mod.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                      max_per_container=4)
    return topo, net, placement


def _arrivals():
    topo = _system(rc)[0]
    rng = np.random.default_rng(11)
    unit = rc.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + 1, *unit.shape)) < 0.8
    return (arr * (unit > 0)).astype(np.float32)


ARR = _arrivals()


def _trace(mod, restart):
    if restart is None:
        return None
    topo, _, placement = _system(mod)
    return mod.rolling_restart(topo, start=8, down_slots=2,
                               instances=list(RESTARTS[restart])).compile(topo, T, placement)


def _port_spec(restart=None, **kw):
    topo, net, placement = _system(pt)
    kw.setdefault("V", 2.0)
    if kw.get("engine", "cohort-fused") == "cohort-fused":
        kw = dict(dict(warmup=5, age_cap=32), **kw)
    return pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=ARR, T=T,
                         events=_trace(pt, restart), device="cpu", **kw)


_REF: dict = {}


def _ref(restart=None, **kw):
    """The reference's run of the same spec, computed once per module."""
    key = (restart, tuple(sorted(kw.items())))
    if key not in _REF:
        topo, net, placement = _system(rc)
        kw = dict(kw, V=kw.get("V", 2.0))
        if kw.get("engine", "cohort-fused") == "cohort-fused":
            kw = dict(dict(warmup=5, age_cap=32), **kw)
        _REF[key] = rc.simulate(rc.EngineSpec(topo=topo, net=net, placement=placement,
                                              arrivals=ARR, T=T, events=_trace(rc, restart),
                                              **kw))
    return _REF[key]


def _same_cohort(a, b):
    np.testing.assert_array_equal(np.asarray(a.backlog), np.asarray(b.backlog))
    np.testing.assert_array_equal(np.asarray(a.comm_cost), np.asarray(b.comm_cost))
    np.testing.assert_array_equal(np.asarray(a.avg_response, np.float64),
                                  np.asarray(b.avg_response, np.float64))
    assert float(a.completed_mass) == float(b.completed_mass)


def _same_scan(a, b):
    for name in ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))
    for name in ("q_in", "q_rem", "q_out_bolt", "transit"):
        np.testing.assert_array_equal(np.asarray(getattr(a.final_state, name)),
                                      np.asarray(getattr(b.final_state, name)))


def _same_streams(a, b):
    """Every stream but ``payload`` (0 off a mesh) bitwise; the dispatch
    entropy (a log) within rel 1e-6."""
    assert list(a.streams) == list(b.streams)
    for name, want in b.streams.items():
        if name == "payload":
            continue
        got = np.asarray(a.streams[name])
        if name == "dispatch":
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("restart", [None, "restart"])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_world_of_one_equals_dense_and_reference(scheduler, restart):
    # on one rank every collective is the identity: the dense port bitwise on
    # any input, the reference test's restart included
    thirds = "thirds" if restart else None
    _same_cohort(pt.simulate(_port_spec(thirds, scheduler=scheduler, sharded=True)),
                 pt.simulate(_port_spec(thirds, scheduler=scheduler)))
    dyadic = "dyadic" if restart else None
    _same_cohort(pt.simulate(_port_spec(dyadic, scheduler=scheduler, sharded=True)),
                 _ref(dyadic, scheduler=scheduler, sharded=True))


@pytest.mark.parametrize("chunk", [7, 15, 64])
def test_world_of_one_chunks(chunk):
    chk = pt.simulate(_port_spec("dyadic", scheduler="potus", sharded=True, chunk=chunk))
    _same_cohort(chk, pt.simulate(_port_spec("dyadic", scheduler="potus", sharded=True)))
    _same_cohort(chk, _ref("dyadic", scheduler="potus", sharded=True))


def test_world_of_one_routes():
    """``use_pallas`` with potus, no events and no streams takes the slot
    kernel (its plain version on the CPU) on a one-rank mesh; metric streams
    take the compact step, as in the reference. Both equal the dense run."""
    # the rows of the five queue tensors are split, the two accumulators whole
    assert psh.cohort_state_specs() == (1, 1, 1, 1, 1, None, None)
    psh.ROUTES.clear()
    kernel = pt.simulate(_port_spec(scheduler="potus", sharded=True, use_pallas=True,
                                    slots_per_launch=4, chunk=16))
    assert dict(psh.ROUTES) == {"kernel": 2}
    compact = pt.simulate(_port_spec(scheduler="potus", sharded=True, use_pallas=True,
                                     metrics=True))
    assert dict(psh.ROUTES) == {"kernel": 2, "compact": 1}
    dense = pt.simulate(_port_spec(scheduler="potus", metrics=True))
    _same_cohort(kernel, dense)
    _same_cohort(compact, dense)
    _same_streams(compact.metrics, dense.metrics)
    assert not compact.metrics.streams["payload"].any()
    _same_cohort(kernel, _ref(scheduler="potus", sharded=True))


def test_world_of_one_sweep():
    topo, net, placement = _system(pt)
    rtopo, rnet, rplacement = _system(rc)
    opts = {"age_cap": 32, "warmup": 5}
    spec = dict(V=(1.0, 4.0), scheduler=("potus", "shuffle"), sharded=True)
    shard = pt.run_sweep(topo, net, placement, ARR, T, pt.SweepSpec(**spec),
                         engine="cohort-fused", engine_opts=opts, device="cpu")
    ref = rc.run_sweep(rtopo, rnet, rplacement, ARR, T, rc.SweepSpec(**spec),
                       engine="cohort-fused", engine_opts=opts)
    assert shard.n_batches == ref.n_batches == 2
    for (sp, rp), (sr, rr) in zip(shard, ref):
        assert (sp.V, sp.scheduler) == (sr.V, sr.scheduler)
        _same_cohort(rp, rr)


@pytest.mark.parametrize("what", ["potus-loop", "potus-loop sweep", "cohort sweep",
                                  "indivisible", "kernel_safe"])
def test_sharded_raises(what):
    topo, net, placement = _system(pt)
    if what == "potus-loop":
        with pytest.raises(pt.UnsupportedEngineOption, match="potus-loop"):
            pt.simulate(_port_spec(scheduler="potus-loop", sharded=True))
    elif what == "potus-loop sweep":
        with pytest.raises(pt.UnsupportedEngineOption, match="potus-loop"):
            pt.run_sweep(topo, net, placement, ARR, T,
                         pt.SweepSpec(V=(2.0,), scheduler=("potus", "potus-loop"), sharded=True),
                         engine="cohort-fused", engine_opts={"age_cap": 32}, device="cpu")
    elif what == "cohort sweep":
        with pytest.raises(pt.UnsupportedEngineOption, match="sharded"):
            pt.run_sweep(topo, net, placement, ARR, T, pt.SweepSpec(V=(2.0,), sharded=True),
                         engine="cohort", device="cpu")
    elif what == "indivisible":
        assert psh.instance_mesh(topo.n_instances).shape == {"b": 1, "i": 1}
        three = psh.Mesh(i=Axis(None, 3, 0))
        with pytest.raises(ValueError, match="does not divide I=16"):
            pcf._run_cohort_fused_impl(topo, net, placement, ARR, None, T, pt.SimConfig(V=2.0),
                                       age_cap=32, device="cpu", mesh=three)
        with pytest.raises(ValueError, match="does not divide I=16"):
            psh.run_sim_sharded(topo, net, placement, ARR, T, pt.SimConfig(V=2.0),
                                mesh=three, device="cpu")
    else:
        with pytest.raises(ValueError, match="mutually exclusive"):
            pt.compact_decide("potus", None, None, None, None, None, 2.0, 1.0,
                              kernel_safe=True, axis=Axis())


@pytest.mark.parametrize("restart", [None, "dyadic"])
@pytest.mark.parametrize("scheduler", ["potus", "potus-loop"])
def test_engine_sharded_world_of_one(scheduler, restart):
    port = pt.simulate(_port_spec(restart, engine="sharded", scheduler=scheduler, metrics=True))
    ref = _ref(restart, engine="sharded", scheduler=scheduler, metrics=True)
    _same_scan(port, ref)
    _same_streams(port.metrics, ref.metrics)
    _same_scan(port, pt.simulate(_port_spec(restart, engine="jax", scheduler=scheduler)))


def _schedule_inputs(seed, B, I, C):
    rng = np.random.default_rng(seed)
    q_in = (2.0 ** rng.integers(-2, 4, (B, I))).astype(np.float32)
    q_out = (2.0 ** rng.integers(-2, 4, (B, I, C))).astype(np.float32)
    must = (q_out * (rng.random((B, I, C)) < 0.5)).astype(np.float32)
    alive = np.ones((B, I), np.float32)
    alive[:, [2, 7]] = 0.0
    mu = (4.0 * alive).astype(np.float32)
    gamma = (64.0 * alive).astype(np.float32)
    return q_in, q_out, must, (mu, gamma, alive)


def _schedule_cases():
    """(name, args) of the schedule calls a world runs: the I=16 system, two
    batch entries with caps (sort), one slot without (sort, loop)."""
    topo, net, placement = _system(pt)
    prob = pt.make_problem(topo, net, placement, "cpu")
    q_in, q_out, must, caps = (torch.as_tensor(x) if not isinstance(x, tuple) else
                               tuple(torch.as_tensor(c) for c in x)
                               for x in _schedule_inputs(3, 2, topo.n_instances,
                                                         topo.n_components))
    U = torch.as_tensor(net.U)
    return [
        ("batch caps", psh.sharded_schedule_batch,
         (None, prob, U, q_in, q_out, must, 2.0, 0.5), {"caps": caps}),
        ("sort", psh.sharded_schedule, (None, prob, U, q_in[0], q_out[0], must[0], 2.0, 0.5), {}),
        ("loop", psh.sharded_schedule, (None, prob, U, q_in[1], q_out[1], must[1], 2.0, 0.5),
         {"method": "loop"}),
    ]


def _reference_schedules():
    """The reference's ``potus_schedule`` for each of :func:`_schedule_cases`."""
    topo, net, placement = _system(rc)
    prob = rpotus.make_problem(topo, net, placement)
    q_in, q_out, must, caps = _schedule_inputs(3, 2, topo.n_instances, topo.n_components)
    U = jnp.asarray(net.U)

    def one(b, method, with_caps):
        sc = rpotus.caps_for_slot(*(jnp.asarray(c[b]) for c in caps)) if with_caps else None
        return np.asarray(rpotus.potus_schedule(prob, U, jnp.asarray(q_in[b]),
                                                jnp.asarray(q_out[b]), jnp.asarray(must[b]),
                                                2.0, 0.5, method=method, caps=sc))
    return {"batch caps": np.stack([one(0, "sort", True), one(1, "sort", True)]),
            "sort": one(0, "sort", False), "loop": one(1, "loop", False)}


def test_schedules_world_of_one():
    want = _reference_schedules()
    for name, fn, args, kw in _schedule_cases():
        np.testing.assert_array_equal(fn(*args, **kw).numpy(), want[name], err_msg=name)
    # and the reference's own sharded batch on its one-device fleet mesh
    topo, net, placement = _system(rc)
    q_in, q_out, must, caps = _schedule_inputs(3, 2, topo.n_instances, topo.n_components)
    got = rsh.sharded_schedule_batch(
        rsh.fleet_mesh(topo.n_instances, 2), rpotus.make_problem(topo, net, placement),
        jnp.asarray(net.U), jnp.asarray(q_in), jnp.asarray(q_out), jnp.asarray(must), 2.0, 0.5,
        caps=tuple(jnp.asarray(c) for c in caps))
    np.testing.assert_array_equal(np.asarray(got), want["batch caps"])


# ---------------------------------------------------------------------------
# a four-rank and a three-rank gloo world
# ---------------------------------------------------------------------------

def _world_cases():
    """(name, spec) of the engine runs every rank of a world makes."""
    cases = []
    for scheduler in ("potus", "shuffle", "jsq"):
        for restart in (None, "dyadic"):
            cases.append((f"{scheduler} {restart}", _port_spec(
                restart, scheduler=scheduler, sharded=True, metrics=True)))
    for chunk in (7, 15):
        cases.append((f"chunk {chunk}", _port_spec(scheduler="potus", sharded=True,
                                                   chunk=chunk)))
    cases.append(("use_pallas", _port_spec(scheduler="potus", sharded=True, use_pallas=True)))
    cases.append(("potus thirds", _port_spec("thirds", scheduler="potus", sharded=True)))
    for restart in (None, "dyadic"):
        cases.append((f"engine sharded {restart}", _port_spec(
            restart, engine="sharded", scheduler="potus", metrics=True)))
    cases.append(("engine sharded loop", _port_spec(engine="sharded", scheduler="potus-loop")))
    return cases


def _run_world(n_ranks, cases):
    """Every rank runs ``cases`` then the schedule calls, and reports its
    routes and payload counts; returns one dict per rank."""
    calls = [(pt.simulate, (spec,), {}) for _, spec in cases]
    calls += [(fn, args, kw) for _, fn, args, kw in _schedule_cases()]
    calls += [(psh.route_counts, (), {})]
    outs = spawn_world(call_each, n_ranks, "gloo", WORLD_TIMEOUT_S, (calls,))
    names = [name for name, _ in cases] + [name for name, *_ in _schedule_cases()] + ["routes"]
    return [dict(zip(names, out)) for out in outs]


@pytest.fixture(scope="module")
def world4():
    return _run_world(4, _world_cases())


def _same_result(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a == b
    if hasattr(a, "final_state"):
        _same_scan(a, b)
    else:
        _same_cohort(a, b)
    if a.metrics is not None:
        _same_streams(a.metrics, b.metrics)
        np.testing.assert_array_equal(a.metrics.streams["payload"], b.metrics.streams["payload"])
    return True


def test_world4_every_rank_returns_the_same(world4):
    assert len(world4) == 4
    for rank in world4[1:]:
        for name, got in rank.items():
            assert _same_result(got, world4[0][name]), name


@pytest.mark.parametrize("restart", [None, "dyadic"])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_world4_equals_reference_dense(world4, scheduler, restart):
    got = world4[0][f"{scheduler} {restart}"]
    _same_cohort(got, _ref(restart, scheduler=scheduler))
    # the streams equal the dense port's (the reference's with the same spec)
    dense = pt.simulate(_port_spec(restart, scheduler=scheduler, metrics=True))
    _same_cohort(dense, got)
    _same_streams(got.metrics, dense.metrics)


@pytest.mark.parametrize("case", ["chunk 7", "chunk 15", "use_pallas"])
def test_world4_chunks_and_use_pallas(world4, case):
    _same_cohort(world4[0][case], _ref(scheduler="potus"))


def test_world4_thirds_within_rounding(world4):
    """Off the dyadic tier (a split by 3) the ranks' sums re-associate."""
    got, want = world4[0]["potus thirds"], _ref("thirds", scheduler="potus")
    np.testing.assert_allclose(got.backlog, want.backlog, rtol=1e-6)
    np.testing.assert_allclose(got.comm_cost, want.comm_cost, rtol=1e-6)


def test_world4_routes_and_payload(world4):
    # every sharded cohort-fused chunk of a four-rank world takes the compact step
    n_chunks = 6 + 5 + 2 + 1 + 1  # six runs, T=30 in chunks of 7 and of 15, pallas, thirds
    assert world4[0]["routes"] == {"compact": n_chunks}
    topo, net, _ = _system(pt)
    I, C, K, atot = topo.n_instances, topo.n_components, net.U.shape[0], 32 + 1
    full = psh.cohort_slot_payload_floats(I, C, K, atot, 4)
    assert full == 1895
    # with events the alive counts fold too: the formula exactly
    assert (world4[0]["potus dyadic"].metrics.streams["payload"] == full).all()
    assert (world4[0]["potus None"].metrics.streams["payload"] == full - C).all()
    for restart in (None, "dyadic"):
        assert (world4[0][f"engine sharded {restart}"].metrics.streams["payload"]
                == 2 * I + 5).all()
    assert psh.cohort_slot_payload_floats(I, C, K, atot, 1) == 0


@pytest.mark.parametrize("restart", [None, "dyadic"])
def test_world4_engine_sharded_equals_reference_jax(world4, restart):
    got = world4[0][f"engine sharded {restart}"]
    ref = _ref(restart, engine="jax", scheduler="potus", metrics=True)
    _same_scan(got, ref)
    _same_streams(got.metrics, ref.metrics)
    _same_scan(world4[0]["engine sharded loop"], _ref(engine="jax", scheduler="potus-loop"))


def test_world4_schedules_equal_reference(world4):
    want = _reference_schedules()
    for name in want:
        np.testing.assert_array_equal(world4[0][name].numpy(), want[name], err_msg=name)


def test_world3_idle_rank_returns_the_same():
    """I=16 on three ranks: the mesh takes two, the third takes no rows and
    receives the result by one broadcast."""
    cases = [("potus dyadic", _port_spec("dyadic", scheduler="potus", sharded=True,
                                         metrics=True)),
             ("engine sharded", _port_spec(engine="sharded", scheduler="potus", metrics=True))]
    outs = _run_world(3, cases)
    for rank in outs[1:]:
        for name, got in rank.items():
            if name != "routes":
                assert _same_result(got, outs[0][name]), name
    assert outs[0]["routes"] == outs[1]["routes"] == {"compact": 1}
    assert outs[2]["routes"] == {}  # the idle rank ran no chunk
    _same_cohort(outs[2]["potus dyadic"], _ref("dyadic", scheduler="potus"))
    _same_scan(outs[2]["engine sharded"], _ref(engine="jax", scheduler="potus"))
    topo, net, _ = _system(pt)
    assert (outs[2]["potus dyadic"].metrics.streams["payload"]
            == psh.cohort_slot_payload_floats(16, topo.n_components, net.U.shape[0], 33, 2)).all()
    want = _reference_schedules()
    for name in want:
        np.testing.assert_array_equal(outs[2][name].numpy(), want[name], err_msg=name)


def test_payload_counter_counts_nothing_on_one_rank():
    PAYLOAD.reset()
    pt.simulate(_port_spec("dyadic", scheduler="potus", sharded=True, metrics=True))
    assert PAYLOAD.elements == {} and PAYLOAD.calls == 0


def test_item_5b_raises_across_ranks():
    """What the multi-rank model half still lacks raises across ranks, naming
    item 5b: tensor-parallel training (a ``"model"`` axis of more than one
    rank) of an SSM config; an MoE config's step, by the
    expert-parallel route, builds on the same mesh (its tensor-parallel
    training: ``tests/test_torch_moe_tp_train.py``; on an ``(n, 1)`` mesh:
    ``tests/test_torch_moe_train.py``; the MoE block across ranks runs the
    expert-parallel dispatch under a mesh: ``tests/test_torch_moe_ep.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import Axis, set_mesh
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.training import train_loop as ptl

    set_mesh(ModelMesh((("data", Axis(None, 2, 0)), ("model", Axis(None, 2, 0)))))
    try:
        with pytest.raises(NotImplementedError, match="module item 5b"):
            ptl.make_train_step(get_config("mamba2_1_3b").reduced(), ptl.TrainConfig())
        cfg = get_config("granite_moe_1b").reduced().with_(moe_ep_shardmap=True)
        assert callable(ptl.make_train_step(cfg, ptl.TrainConfig()))
    finally:
        set_mesh(None)
