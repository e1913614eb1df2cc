"""The port's observability tooling (DESIGN.md §14) against the reference's:
the flight recorder, the ``repro-obs/v1`` frame across the two packages,
``tools/obs_report.py`` on a port dump, the span tracer and the span names
an engine emits, the serving layer's recorder rows, and
``benchmarks/torch_figures.py``'s metrics dump.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.obs as ro
import repro_torch.core as pt
import repro_torch.obs as po
from repro.core import events as rev
from repro.serving import dispatcher as rd
from repro.serving import fleet as rf
from repro_torch.core import events as pev
from repro_torch.serving import dispatcher as pd
from repro_torch.serving import fleet as pf

ROOT = Path(__file__).resolve().parents[1]
# the dashboards are scripts, not a package: import them by path, as
# tests/test_obs_metrics.py does
sys.path.insert(0, str(ROOT / "tools"))
import obs_report  # noqa: E402

torch.set_num_threads(1)

T = 24
W = 1


def _system(mod):
    """``tests/test_obs_metrics.py``'s dyadic system in ``mod``."""
    C = mod.Component
    apps = [[C("src", 0, True, 2, successors=(1,)),
             C("mid", 0, False, 4, 4.0, successors=(2,)),
             C("sink", 0, False, 2, 4.0)]]
    topo = mod.build_topology(apps, gamma=64.0)
    sd, _ = mod.fat_tree(4)
    net = mod.container_costs("fat-tree", sd)
    placement = mod.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                      max_per_container=4)
    rng = np.random.default_rng(7)
    unit = mod.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + W + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + W + 1, *unit.shape)) < 0.8
    return topo, net, placement, (arr * (unit > 0)).astype(np.float32)


def _simulate(mod, engine, **kw):
    topo, net, placement, arr = _system(mod)
    if mod is pt:
        kw["device"] = "cpu"
    if engine == "cohort-fused":
        kw.setdefault("warmup", 5)
    return mod.simulate(mod.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                       T=T, V=2.0, window=W, engine=engine, **kw))


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_flight_recorder_ring_matches_reference():
    recs = {"ref": ro.FlightRecorder(capacity=4), "port": po.FlightRecorder(capacity=4)}
    for t in range(10):
        recs["ref"].record(slot=t, h=np.float32(t) / 4, v=np.arange(2) * t)
        recs["port"].record(slot=t, h=torch.tensor(t / 4.0), v=torch.arange(2) * t)
    assert len(recs["port"]) == 4 and recs["port"].dropped == 6
    rows = recs["port"].rows()
    assert [r["slot"] for r in rows] == [6, 7, 8, 9]
    assert isinstance(rows[0]["h"], float)  # a 0-d tensor lands as a JSON-able float
    assert recs["port"].dump() == recs["ref"].dump()
    recs["port"].clear()
    assert len(recs["port"]) == 0 and recs["port"].dropped == 0


def test_flight_recorder_fields_filter_and_save(tmp_path):
    rec = po.FlightRecorder(capacity=8, fields=("slot", "h"))
    rec.record(slot=0, h=1.0, secret=42.0)
    assert "secret" not in rec.rows()[0]
    path = tmp_path / "rec.json"
    rec.save(str(path))
    payload = json.loads(path.read_text())
    assert payload["schema"] == "repro-bench/v2"
    assert payload["rows"] == [{"slot": 0, "h": 1.0}]
    with pytest.raises(ValueError, match="capacity"):
        po.FlightRecorder(capacity=0)


# ---------------------------------------------------------------------------
# the frame and obs_report
# ---------------------------------------------------------------------------

def test_frame_json_round_trip_across_packages(tmp_path):
    port = _simulate(pt, "cohort-fused", metrics=sorted(po.ENGINE_STREAMS["cohort-fused"]))
    path = tmp_path / "port.json"
    port.metrics.save(str(path))
    for mod in (ro, po):
        loaded = mod.MetricsFrame.load(str(path))
        assert loaded.spec.streams == port.metrics.spec.streams
        assert loaded.n_slots == T
        for name, arr in port.metrics.streams.items():
            assert loaded.columns[name] == port.metrics.columns[name]
            np.testing.assert_allclose(loaded.streams[name], arr, rtol=0, atol=1e-6)
    # a reference frame loads in the port as the reference loads it
    ref = ro.build_frame(ro.MetricsSpec(streams=("backlog", "backlog_comp", "payload")),
                         [np.arange(6, dtype=np.float32).reshape(3, 2)[:, :1],
                          np.ones((3, 3), np.float32)], n_slots=3, payload_floats=5)
    path = tmp_path / "ref.json"
    ref.save(str(path))
    a, b = po.MetricsFrame.load(str(path)), ro.MetricsFrame.load(str(path))
    assert a.to_json() == b.to_json() == ref.to_json()
    assert a.columns["backlog_comp"] == ("c0", "c1", "c2")
    with pytest.raises(ValueError, match="schema"):
        po.MetricsFrame.from_json({"schema": "repro-bench/v2", "streams": {}})
    with pytest.raises(ValueError, match="expected 2 stream arrays"):
        po.build_frame(po.MetricsSpec(streams=("backlog", "price")), [np.zeros((3, 1))],
                       n_slots=3)


def test_obs_report_reads_a_port_dump(tmp_path, capsys):
    res = _simulate(pt, "cohort-fused", metrics=True,
                    events=pt.k_failures(_system(pt)[0], k=2, start=T // 3, duration=4,
                                         rng=np.random.default_rng(3)).compile(_system(pt)[0],
                                                                                T))
    path = tmp_path / "obs.json"
    res.metrics.save(str(path))
    assert obs_report.main([str(path), "--stream", "backlog", "--recovery"]) == 0
    out = capsys.readouterr().out
    assert "stream 'backlog'" in out and "recovery story" in out
    story = obs_report.recovery_story(list(res.metrics.streams["backlog"][:, 0]), 1.1)
    assert story["peak_backlog_slot"] == int(np.argmax(res.backlog))
    from benchmarks.torch_figures import recovery_story

    assert recovery_story(res.backlog) == (story["peak_backlog_slot"], story["recovery_slot"])
    assert obs_report.main([str(path), "--stream", "nope"]) == 1


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

def test_span_noop_when_disabled():
    tracer = po.SpanTracer()
    with tracer.span("potus/test/stage"):
        pass
    assert len(tracer) == 0


def test_span_capture_and_chrome_export(tmp_path):
    tracer = po.SpanTracer(capacity=4)
    tracer.enabled = True
    for t in range(6):  # overflow the ring: the oldest spans go
        with tracer.span("potus/test/stage", t=t):
            with tracer.span("potus/test/inner"):
                pass
    assert len(tracer) == 4
    ev = tracer.chrome_trace()["traceEvents"][-1]
    assert ev["name"] == "potus/test/stage" and ev["ph"] == "X"
    assert ev["args"]["t"] == "5" and ev["dur"] >= 0
    path = tmp_path / "trace.json"
    tracer.export_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"][0]["name"] == "potus/test/inner"


def test_global_tracer_toggles_and_profiler_ranges():
    tracer = po.enable_tracing(capacity=64)
    tracer.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with po.span("potus/test/global"):
                torch.ones(4).sum()
        assert len(po.get_tracer()) == 1 and po.get_tracer().capacity == 64
        assert po.chrome_trace()["traceEvents"][0]["name"] == "potus/test/global"
    finally:
        po.disable_tracing()
    # an enabled span opens a record_function range of its name
    assert "potus/test/global" in {e.key for e in prof.key_averages()}
    with po.span("potus/test/after"):
        pass
    assert len(po.get_tracer()) == 1  # disabled again: no new events


@pytest.mark.parametrize("engine", ["jax", "cohort-fused"])
def test_span_names_match_reference(engine):
    """A ``simulate`` with ``chunk=`` emits the reference's span names, in
    the reference's order."""
    names = {}
    for key, mod, obs in (("ref", rc, ro), ("port", pt, po)):
        tracer = obs.enable_tracing()
        tracer.clear()
        try:
            _simulate(mod, engine, chunk=8, metrics=True)
        finally:
            obs.disable_tracing()
        names[key] = [e["name"] for e in tracer.chrome_trace()["traceEvents"]]
    prefix = "potus/jax/" if engine == "jax" else "potus/cohort-fused/"
    assert names["port"] == names["ref"]
    assert names["port"].count(prefix + "chunk") == T // 8


# ---------------------------------------------------------------------------
# the serving layer's recorders
# ---------------------------------------------------------------------------

TPR = 4.0
RATES_TOK = np.array([8.0, 8.0, 4.0, 4.0], np.float32)


def _scenario(pkg):
    return pkg.FleetScenario(
        (pkg.FleetEvent("failure", 10, 22, instances=(1, 3)),
         pkg.FleetEvent("straggler", 26, 34, instances=(2,), factor=0.25)),
        name="k2+straggler")


def _drive(disp_mod, fleet_mod, scheduler, events, **kw):
    """``tests/test_torch_serving.py``'s dispatcher over a SimReplica fleet,
    both with a recorder: returns the two recorders and the dispatcher."""
    R = len(RATES_TOK)
    host_costs = np.ones((1 + R, 1 + R), np.float32) - np.eye(1 + R, dtype=np.float32)
    rec_d, rec_f = (ro.FlightRecorder(64), ro.FlightRecorder(64)) if disp_mod is rd else (
        po.FlightRecorder(64), po.FlightRecorder(64))
    disp = disp_mod.PotusDispatcher(
        n_frontends=1, replica_hosts=np.arange(1, 1 + R), frontend_hosts=np.array([0]),
        host_costs=host_costs, replica_rates=RATES_TOK,
        cfg=disp_mod.DispatcherConfig(V=0.5, gamma=64.0, window=2 if events else 0,
                                      tokens_per_request=TPR, scheduler=scheduler),
        recorder=rec_d, **kw)
    fleet = fleet_mod.ReplicaFleet([fleet_mod.SimReplica(float(r), max_batch=1 << 20)
                                    for r in RATES_TOK], recorder=rec_f)
    trace = None
    if events:
        trace = _scenario(rev if disp_mod is rd else pev).compile(disp.topo, 40)
        disp.observe_prediction(np.array([[1.0, 2.0, 0.0]], np.float32))
    arrivals = np.random.default_rng(12).integers(0, 8, size=(40, 1)).astype(np.float32)
    for t in range(len(arrivals)):
        ev_row = mu_row = alive_row = None
        if trace is not None:
            ev_row = (trace.mu_t[t], trace.gamma_t[t], trace.alive_t[t])
            mu_row, alive_row = trace.mu_t[t][1:], trace.alive_t[t][1:]
        assign = disp.route(arrivals[t], fleet.backlog_tokens, events_row=ev_row)
        for r in range(len(fleet)):
            mass = float(assign[:, r].sum())
            if mass > 0.0:
                fleet.dispatch(r, fleet_mod.FleetRequest(rid=t * 10 + r, tokens=mass * TPR,
                                                         submitted=t))
        fleet.step(t, mu_row=mu_row, alive_row=alive_row)
    return rec_d, rec_f, disp


@pytest.mark.parametrize("events", [False, True], ids=["plain", "k2+straggler"])
@pytest.mark.parametrize("scheduler", ["potus", "jsq"])
def test_serving_recorder_rows_match_reference(scheduler, events):
    ref_d, ref_f, _ = _drive(rd, rf, scheduler, events)
    port_d, port_f, disp = _drive(pd, pf, scheduler, events, device="cpu")
    assert port_d.rows() == ref_d.rows() and len(port_d) == 40
    assert port_f.rows() == ref_f.rows() and len(port_f) == 40
    assert [r["h"] for r in port_d.rows()] == disp.h_history
    assert set(port_d.rows()[0]) == {"slot", "h", "shipped", "pending", "window",
                                     "comm_cost_total"}
    assert set(port_f.rows()[0]) == {"slot", "backlog_tokens", "backlog_max", "inflight",
                                     "completed", "tokens_served"}


def test_dispatcher_scheduler_call_span():
    tracer = po.enable_tracing()
    tracer.clear()
    try:
        _drive(pd, pf, "potus", False, device="cpu")
    finally:
        po.disable_tracing()
    events = tracer.chrome_trace()["traceEvents"]
    assert [e["name"] for e in events] == ["potus/serving/scheduler-call"] * 40
    assert events[0]["args"] == {"sharded": "False"}


# ---------------------------------------------------------------------------
# benchmarks/torch_figures.py's metrics dump, and the package's imports
# ---------------------------------------------------------------------------

def test_figures_obs_dump_gives_a_recovery_story(tmp_path):
    obs, trace = tmp_path / "obs.json", tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               REPRO_BENCH_SMOKE="1", OMP_NUM_THREADS="1",
               REPRO_TORCH_OBS_DISRUPTION_JSON=str(obs), REPRO_TORCH_OBS_TRACE_JSON=str(trace))
    proc = subprocess.run([sys.executable, "-m", "benchmarks.torch_figures", "obs", "--device",
                           "cpu"], capture_output=True, text=True, env=env, cwd=tmp_path,
                          check=True)
    row = proc.stdout.strip().splitlines()[-1]
    assert row.startswith("disruption/obs/potus,")
    derived = dict(kv.split("=") for kv in row.split(",", 2)[2].split(";"))
    payload = json.loads(obs.read_text())
    assert payload["schema"] == "repro-obs/v1" and derived["streams"] == "10"
    assert set(payload["streams"]) == set(po.ENGINE_STREAMS["cohort-fused"])
    spans = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert spans and set(spans) == {"potus/cohort-fused/chunk"}
    report = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_report.py"), str(obs),
                             "--recovery"], capture_output=True, text=True, check=True).stdout
    story = dict(line.split() for line in report.split("recovery story")[1].splitlines()[1:]
                 if line.strip())
    assert story["peak_backlog_slot"] == derived["peak_backlog_slot"]
    assert story["recovery_slot"] == derived["recovery_slot"]


def test_obs_imports_no_core():
    code = ("import sys; import repro_torch.obs; "
            "print(sorted(m for m in sys.modules if m.startswith(('repro_torch.core', 'jax')) "
            "or m.split('.')[0] == 'repro'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         check=True).stdout.strip()
    assert got == "[]"
