"""The port's metric streams (``repro_torch.obs.metrics``, DESIGN.md §14)
against the reference's ``repro.obs``.

* the stream tables and ``MetricsSpec`` equal the reference's, with the same
  outcome for every ``coerce`` input and validation case;
* ``compute_scan_streams`` (torch) and ``compute_host_streams`` (numpy) equal
  the reference's on seeded contexts with ties, an idle slot and n=1 —
  bitwise, the entropy within rel 1e-6 (it takes a log);
* transparency: metrics on and off give bitwise the same trajectories for
  potus/shuffle/jsq/potus-loop on both ported engines, with and without
  ``chunk=`` and a k-failure trace (the port alone);
* the streams equal the reference's ``simulate(metrics=...)`` on the
  dyadic system of ``tests/test_obs_metrics.py`` (every sum exact), and
  ``run_sweep``'s per-scenario frames the reference's sweep frames;
* the unsupported streams and the engines not ported yet raise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.obs as ro
import repro_torch.core as pt
import repro_torch.obs as po
from repro.obs import metrics as rom
from repro_torch.obs import metrics as pom

torch.set_num_threads(1)

T = 24
W = 1


def _system(mod):
    """``tests/test_obs_metrics.py``'s dyadic system in ``mod`` (the reference's
    ``repro.core`` or the port's): pow-2 parallelism and arrival masses."""
    C = mod.Component
    apps = [[C("src", 0, True, 2, successors=(1,)),
             C("mid", 0, False, 4, 4.0, successors=(2,)),
             C("sink", 0, False, 2, 4.0)]]
    topo = mod.build_topology(apps, gamma=64.0)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    rates = np.ones((topo.n_instances, topo.n_components))
    placement = mod.t_heron_placement(topo, net, rates, max_per_container=4)
    return topo, net, placement


@pytest.fixture(scope="module")
def arrivals():
    topo = _system(rc)[0]
    rng = np.random.default_rng(7)
    unit = rc.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + W + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + W + 1, *unit.shape)) < 0.8
    return (arr * (unit > 0)).astype(np.float32)


def _kfail(mod, topo, seed=3):
    """``tests/test_obs_metrics.py``'s k=2 failure. Seed 3 takes one "mid" and
    one "sink" instance, leaving 3 of 4 mids: their even split is not dyadic,
    so the two packages agree there to rounding only (ROADMAP.md, section 3).
    Seed 1 takes two mids: every split stays dyadic, for the bitwise checks
    against the reference."""
    return mod.k_failures(topo, k=2, start=T // 3, duration=4,
                          rng=np.random.default_rng(seed)).compile(topo, T)


def _port(arrivals, engine, events=False, **kw):
    topo, net, placement = _system(pt)
    if engine == "cohort-fused":
        kw.setdefault("warmup", 5)
    ev = None if not events else _kfail(pt, topo, 3 if events is True else events)
    return pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement,
                                     arrivals=arrivals, T=T, V=2.0, window=W, engine=engine,
                                     events=ev, device="cpu", **kw))


def _ref(arrivals, engine, events=False, **kw):
    topo, net, placement = _system(rc)
    if engine == "cohort-fused":
        kw.setdefault("warmup", 5)
    ev = None if not events else _kfail(rc, topo, 3 if events is True else events)
    return rc.simulate(rc.EngineSpec(topo=topo, net=net, placement=placement,
                                     arrivals=arrivals, T=T, V=2.0, window=W, engine=engine,
                                     events=ev, **kw))


def _all_streams(engine):
    return tuple(sorted(po.ENGINE_STREAMS[engine]))


def assert_frames_equal(port, ref):
    """Bitwise, except the dispatch entropy (a log): rel 1e-6."""
    assert port.spec == pom.MetricsSpec(streams=ref.spec.streams)
    assert list(port.streams) == list(ref.streams)
    for name, want in ref.streams.items():
        got = port.streams[name]
        assert port.columns[name] == ref.columns[name], name
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "dispatch":
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# tables and MetricsSpec
# ---------------------------------------------------------------------------

def test_tables_equal_the_reference():
    assert po.STREAMS == ro.STREAMS
    assert po.DEFAULT_STREAMS == ro.DEFAULT_STREAMS
    assert po.ENGINE_STREAMS == ro.ENGINE_STREAMS
    assert pom.OBS_JSON_SCHEMA == rom.OBS_JSON_SCHEMA == "repro-obs/v1"
    assert po.__all__ == ro.__all__
    for engine in po.ENGINE_STREAMS:
        for spec in (po.MetricsSpec(), po.MetricsSpec(streams=tuple(sorted(po.STREAMS)))):
            ref_spec = ro.MetricsSpec(streams=spec.streams)
            assert po.unsupported_streams(engine, spec) == ro.unsupported_streams(engine,
                                                                                  ref_spec)
            assert po.scan_stream_names(spec) == ro.scan_stream_names(ref_spec)
    for name in po.STREAMS:
        assert po.stream_engines(name) == ro.stream_engines(name)
    for p in (0.0, 0.5, 0.95, 1.0):
        for n in (1, 2, 3, 8, 20, 16384):
            assert pom._rank_index(p, n) == rom._rank_index(p, n)


COERCE_CASES = {
    "none": None,
    "true": True,
    "name": "backlog",
    "tuple": ("backlog", "price"),
    "list": ["queue_depth", "saturation"],
    "generator": "gen",
    "all": tuple(sorted(rom.STREAMS)),
    "unknown": ("backlog", "nope"),
    "duplicate": ("backlog", "backlog"),
    "int": 3,
    "false": False,
}


def _outcome(mod, arg):
    if arg == "gen":
        arg = (s for s in ("dispatch", "transit"))
    try:
        spec = mod.MetricsSpec.coerce(arg)
    except (TypeError, ValueError) as exc:
        return "raises", type(exc).__name__, str(exc)
    return "spec", None if spec is None else spec.streams


@pytest.mark.parametrize("case", list(COERCE_CASES))
def test_metrics_spec_coerce_and_validation_match_reference(case):
    arg = COERCE_CASES[case]
    got = _outcome(pom, arg)
    assert got == _outcome(rom, arg)
    if got[0] == "spec" and got[1] is not None:  # an existing spec passes through, hashable
        spec = pom.MetricsSpec(streams=got[1])
        assert pom.MetricsSpec.coerce(spec) is spec
        assert hash(spec) == hash(pom.MetricsSpec(streams=got[1]))


# ---------------------------------------------------------------------------
# the stream computers
# ---------------------------------------------------------------------------

def _ctx(kind, seed):
    """A slot's raw quantities as numpy: ``ties`` (integer-valued queues with
    repeats), ``random`` (f32 noise), ``idle`` (nothing landed), ``n1`` (one
    instance)."""
    rng = np.random.default_rng(seed)
    n = 1 if kind == "n1" else 37
    if kind == "random":
        q_in = rng.random(n).astype(np.float32) * 10
        landed = rng.random(n).astype(np.float32) * (rng.random(n) < 0.7)
    else:
        q_in = rng.integers(0, 4, n).astype(np.float32)
        landed = rng.integers(0, 3, n).astype(np.float32)
    if kind == "idle":
        landed = np.zeros(n, np.float32)
    price = (np.float32(2.0) * rng.integers(0, 3, n).astype(np.float32) + q_in
             if kind != "random" else rng.random(n).astype(np.float32))
    f = np.float32
    return {
        "h": f(q_in.sum() * 1.5), "q_in": q_in, "price": price.astype(np.float32),
        "landed": landed.astype(np.float32), "transit_total": f(landed.sum()),
        "comp_backlog": rng.random(5).astype(np.float32),
        "held": f(rng.random()), "dropped": f(rng.random()), "tp": f(3.0), "fp": f(0.5),
        "tn": f(1.25), "capped": f(rng.random()), "served": f(4.0),
    }


CTX_KINDS = ["ties", "random", "idle", "n1"]
SCAN_NAMES = tuple(n for n in rom.STREAMS if n != "payload")


@pytest.mark.parametrize("kind", CTX_KINDS)
def test_compute_scan_streams_match_reference(kind):
    for seed in range(3):
        ctx = _ctx(kind, seed)
        want = rom.compute_scan_streams(SCAN_NAMES, {k: jnp.asarray(v) for k, v in ctx.items()})
        got = pom.compute_scan_streams(SCAN_NAMES, {k: torch.as_tensor(v)
                                                    for k, v in ctx.items()})
        for name, g, w in zip(SCAN_NAMES, got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, name
            if name == "dispatch":
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_allclose(g[1], w[1], rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{kind} {name}")
        if kind == "idle":
            assert got[SCAN_NAMES.index("dispatch")].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("kind", CTX_KINDS)
def test_compute_host_streams_match_reference(kind):
    ctx = _ctx(kind, 0)
    for g, w in zip(pom.compute_host_streams(SCAN_NAMES, ctx),
                    rom.compute_host_streams(SCAN_NAMES, ctx)):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE_CASES = [("jax", {}), ("jax", {"chunk": 8}), ("cohort-fused", {}),
                ("cohort-fused", {"chunk": 8})]


@pytest.mark.parametrize("events", [False, True], ids=["plain", "kfail"])
@pytest.mark.parametrize("engine,opts", ENGINE_CASES,
                         ids=[f"{e}-{'-'.join(o) or 'plain'}" for e, o in ENGINE_CASES])
@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq", "potus-loop"])
def test_bitwise_transparent(arrivals, scheduler, engine, opts, events):
    off = _port(arrivals, engine, events, scheduler=scheduler, **opts)
    on = _port(arrivals, engine, events, scheduler=scheduler, metrics=_all_streams(engine),
               **opts)
    np.testing.assert_array_equal(on.backlog, off.backlog)
    np.testing.assert_array_equal(on.comm_cost, off.comm_cost)
    if engine == "jax":
        for name in ("q_in_total", "q_out_total", "served_total"):
            np.testing.assert_array_equal(getattr(on, name), getattr(off, name))
        for f in dataclasses.fields(off.final_state):
            np.testing.assert_array_equal(getattr(on.final_state, f.name),
                                          getattr(off.final_state, f.name))
    else:
        assert on.avg_response == off.avg_response or np.isnan(off.avg_response)
        assert on.completed_mass == off.completed_mass
        assert on.saturated_frac == off.saturated_frac
    assert off.metrics is None
    assert on.metrics.n_slots == T and set(on.metrics.streams) == set(_all_streams(engine))
    for arr in on.metrics.streams.values():
        assert np.isfinite(arr).all()


DYADIC_KFAIL = 1  # the k-failure seed that keeps every split dyadic (see _kfail)
REF_CASES = [("jax", "potus", False), ("jax", "shuffle", False), ("jax", "jsq", False),
             ("jax", "potus", DYADIC_KFAIL), ("cohort-fused", "potus", False),
             ("cohort-fused", "shuffle", False), ("cohort-fused", "jsq", False),
             ("cohort-fused", "potus-loop", False), ("cohort-fused", "potus", DYADIC_KFAIL)]


@pytest.mark.parametrize("engine,scheduler,events", REF_CASES,
                         ids=[f"{e}-{s}-{'kfail' if v else 'plain'}" for e, s, v in REF_CASES])
def test_streams_match_reference(arrivals, engine, scheduler, events):
    metrics = _all_streams(engine)
    ref = _ref(arrivals, engine, events, scheduler=scheduler, metrics=metrics)
    port = _port(arrivals, engine, events, scheduler=scheduler, metrics=metrics)
    np.testing.assert_array_equal(port.backlog, np.asarray(ref.backlog))
    assert_frames_equal(port.metrics, ref.metrics)


@pytest.mark.parametrize("engine", ["jax", "cohort-fused"])
def test_backlog_stream_is_the_result_backlog(arrivals, engine):
    res = _port(arrivals, engine, events=True, metrics=("backlog",))
    assert list(res.metrics.streams) == ["backlog"]
    np.testing.assert_array_equal(res.metrics.streams["backlog"][:, 0], res.backlog)


@pytest.mark.parametrize("engine", ["jax", "cohort-fused"])
def test_sweep_frames_match_reference(arrivals, engine):
    """A 2x2 (V x W) grid with ``engine_opts={"metrics": ...}``: each
    scenario's frame equals the reference sweep's."""
    metrics = _all_streams(engine)
    opts = {"metrics": metrics} if engine == "jax" else {"metrics": metrics, "warmup": 5}
    out = {}
    for name, mod, kw in (("ref", rc, {}), ("port", pt, {"device": "cpu"})):
        topo, net, placement = _system(mod)
        out[name] = mod.run_sweep(topo, net, placement, arrivals, T,
                                  mod.SweepSpec(V=(1.0, 2.0), window=(0, 1)), engine=engine,
                                  engine_opts=dict(opts), **kw)
    assert out["port"].n_batches == out["ref"].n_batches
    for (_, r), (_, p) in zip(out["ref"], out["port"]):
        np.testing.assert_array_equal(p.backlog, np.asarray(r.backlog))
        assert_frames_equal(p.metrics, r.metrics)


def test_cohort_fused_compact_metrics_take_the_compact_step(arrivals, monkeypatch):
    """The route rule: a compact scheduler with metrics never calls the slot
    step of ``kernels.ops`` (on the card, the slot kernel); without them the
    same run does."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.potus_slot_step

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "potus_slot_step", counted)
    _port(arrivals, "cohort-fused", metrics=True)
    assert calls == []
    _port(arrivals, "cohort-fused")
    assert len(calls) == T


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_saturation_on_jax_names_cohort_fused(arrivals):
    with pytest.raises(pt.UnsupportedEngineOption, match="saturation") as exc:
        _port(arrivals, "jax", metrics=("backlog", "saturation"))
    assert exc.value.nearest == "cohort-fused"
    assert "engine='cohort-fused'" in str(exc.value)
    with pytest.raises(pt.UnsupportedEngineOption, match="held"):
        _port(arrivals, "jax", metrics=("held",))
    topo, net, placement = _system(pt)
    with pytest.raises(pt.UnsupportedEngineOption, match="saturation"):
        pt.run_sweep(topo, net, placement, arrivals, T, pt.SweepSpec(), engine="jax",
                     engine_opts={"metrics": ("saturation",)}, device="cpu")
    with pytest.raises(ValueError, match="unknown metric stream"):
        _port(arrivals, "cohort-fused", metrics=("nope",))


@pytest.mark.parametrize("engine", ["cohort", "sharded"])
def test_unported_engines_with_metrics_raise(arrivals, engine):
    with pytest.raises(pt.UnsupportedEngineOption, match="not ported yet"):
        _port(arrivals, engine, metrics=True)
    topo, net, placement = _system(pt)
    kw = (dict(engine="cohort") if engine == "cohort"
          else dict(engine="jax", spec=pt.SweepSpec(sharded=True)))
    spec = kw.pop("spec", pt.SweepSpec())
    with pytest.raises(pt.UnsupportedEngineOption, match="not ported yet"):
        pt.run_sweep(topo, net, placement, arrivals, T, spec,
                     engine_opts={"metrics": True}, device="cpu", **kw)
