"""MoE training across ranks (``training.train_loop`` under an ``(n, 1)``
model mesh with an MoE config) on four gloo ranks on the CPU, by the
reference's two routes.

* The reference side runs once for the module in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (jax fixes its
  device count at start-up), as ``tests/test_torch_moe_ep.py`` does: one
  jitted train step of ``granite_moe_1b.reduced()`` with 8 experts and
  ``d_ff`` 256 from the weights of key 1 on the global batch of seed 0, on
  one device for route (a) and under a 4x1 mesh with ``moe_ep_shardmap``
  for route (b), the reference's expert-parallel step.
* The port side is one four-rank gloo world (``spawn_world`` +
  ``call_each``: one start-up) that runs every case through
  ``examples/torch_train_dp.py``'s ``train_rank`` from the reference's
  weights (``convert``):

  - route (a), the global-batch router (``moe_ffn`` with the rows' axis):
    the ``topk`` and ``potus`` routers (``potus`` from the state
    ``arange(E) * 0.5``), capacity factor 4.0 and 0.5 (drops), ZeRO-1 and
    ``grad_specs`` on (and once both off), ``microbatches=2``,
    ``remat="full"``, a batch of 6 that does not split, a 2x1 mesh with
    two ranks off it; against the reference's one-device step;
  - route (b), the expert-parallel route (``moe_ffn_ep`` on the rank's
    rows, E/4 experts a rank): ``topk`` at 4.0 and 0.5, ``potus`` at 0.5;
    against the reference's 4x1 expert-parallel step;
  - a route (b) state saved on four ranks, restored onto a 2x1 mesh and
    onto one rank.

  Each step: loss, ce, ``moe_aux`` and grad norm within rel 1e-5, ``ntok``
  and the router state equal, the parameters within ``_param_bound``
  (``tests/test_torch_training.py``), each rank's moment blocks (its
  layout, ``state_shardings``) within the gradient check's bound of the
  reference's, every rank's replicated parameters the same bitwise. The
  forward before the step (``moe_probe``) is held against the port's
  one-rank forward, which ``tests/test_torch_moe.py`` holds to the
  reference's selections exactly: each layer's loads, ``dropped_frac`` and
  router state equal, the ranks' selections and keep masks in rank order
  equal (route (b), which routes each rank's tokens on their own, only
  under ``topk``, whose selections do not depend on the other tokens, and
  where its drops differ from the global ones only in the first layer).

In this process: a 1x1 mesh is the meshless step bitwise for both routes;
``state_shardings``' layouts; route (b) refuses a batch that does not split.
"""
import filecmp
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import Axis, call_each, set_mesh, spawn_world
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import ModelMesh, make_host_mesh
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl
from test_torch_training import _param_bound, _rel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_train_dp as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

S, E = 32, 8
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
WORLD, WORLD_TIMEOUT_S = 4, 240
# reference step: (router, capacity factor, TrainConfig fields, global batch, expert-parallel)
REFS = {
    "topk-4": ("topk", 4.0, {}, 8, False),
    "topk-0.5": ("topk", 0.5, {}, 8, False),
    "potus-0.5": ("potus", 0.5, {}, 8, False),
    "potus-0.5-micro2": ("potus", 0.5, {"microbatches": 2}, 8, False),
    "topk-0.5-B6": ("topk", 0.5, {}, 6, False),
    "ep-topk-4": ("topk", 4.0, {}, 8, True),
    "ep-topk-0.5": ("topk", 0.5, {}, 8, True),
    "ep-potus-0.5": ("potus", 0.5, {}, 8, True),
}
# case: (reference, the port's extra TrainConfig fields, mesh, zero_sharding, grad_specs)
CASES = {
    "a-topk-cf4": ("topk-4", {}, (4, 1), True, True),
    "a-topk-cf0.5": ("topk-0.5", {}, (4, 1), True, True),
    "a-topk-cf0.5-replicated": ("topk-0.5", {}, (4, 1), False, False),
    "a-potus-cf0.5": ("potus-0.5", {}, (4, 1), True, True),
    "a-potus-cf0.5-microbatches2": ("potus-0.5-micro2", {}, (4, 1), True, True),
    "a-topk-cf0.5-remat": ("topk-0.5", {"remat": "full"}, (4, 1), True, True),
    "a-topk-cf0.5-B6-unsplit": ("topk-0.5-B6", {}, (4, 1), True, True),
    "a-topk-cf0.5-2x1-two-off": ("topk-0.5", {}, (2, 1), True, True),
    "b-topk-cf4": ("ep-topk-4", {}, (4, 1), True, True),
    "b-topk-cf0.5": ("ep-topk-0.5", {}, (4, 1), True, True),
    "b-potus-cf0.5": ("ep-potus-0.5", {}, (4, 1), True, True),
}

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data.specs import make_batch
from repro.distributed import sharding as shd
from repro.distributed.context import set_mesh
from repro.launch.mesh import make_host_mesh
from repro.training import optimizer as ropt
from repro.training import train_loop as rtl

refs, S, E, opt, path = json.loads(sys.argv[1])
out = {}

def put(prefix, tree):
    for name, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(k.key for k in name)] = np.asarray(leaf)

for key, (router, cf, tkw, B, ep) in refs.items():
    cfg = get_config("granite_moe_1b").reduced().with_(
        n_experts=E, d_ff=256, router=router, capacity_factor=cf, moe_ep_shardmap=ep)
    tcfg = rtl.TrainConfig(opt=ropt.OptConfig(**opt), **tkw)
    state = rtl.init_train_state(jax.random.PRNGKey(1), cfg, tcfg)
    if router == "potus":
        state["router_state"] = jnp.arange(E, dtype=jnp.float32) * 0.5
    out[f"{key}/rs_in"] = np.asarray(state["router_state"])
    put("weights/", state["params"])
    batch = make_batch(np.random.default_rng(0), cfg, B=B, S=S)
    for name, a in batch.items():
        out[f"batch{B}/{name}"] = np.asarray(a)
    if ep:
        mesh = make_host_mesh(4, 1)
        set_mesh(mesh)
        sh = shd.train_state_shardings(cfg, mesh, tcfg)
        bsh = shd.batch_shardings(jax.eval_shape(lambda: batch), mesh)
        with mesh:
            step = jax.jit(rtl.make_train_step(cfg, tcfg), in_shardings=(sh, bsh),
                           out_shardings=(sh, None))
            new, met = step(jax.device_put(state, sh), jax.device_put(batch, bsh))
        set_mesh(None)
    else:
        new, met = jax.jit(rtl.make_train_step(cfg, tcfg))(state, batch)
    for name, v in met.items():
        out[f"{key}/metrics/{name}"] = np.asarray(v)
    out[f"{key}/router_state"] = np.asarray(new["router_state"])
    put(f"{key}/params/", new["params"])
    put(f"{key}/m/", new["opt"]["m"])
np.savez(path, **out)
print("ok")
"""


def _tree(flat: dict, prefix: str) -> dict:
    """The ``prefix``-ed entries of ``flat`` as a nested dict."""
    tree: dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _pcfg(ref_key):
    router, cf, _, _, ep = REFS[ref_key]
    return get_config("granite_moe_1b").reduced().with_(
        n_experts=E, d_ff=256, router=router, capacity_factor=cf, moe_ep_shardmap=ep)


def _ptcfg(name):
    ref_key, extra, _, zero, _ = CASES[name]
    return ptl.TrainConfig(opt=popt.OptConfig(**OPT, zero_sharding=zero),
                           **REFS[ref_key][2], **extra)


def _batch(ref, B):
    return {k[len(f"batch{B}/"):]: v for k, v in ref.items() if k.startswith(f"batch{B}/")}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's subprocess and the port's four-rank world, side by
    side: the reference's arrays, the weights, each case's and the
    checkpoint's results by rank."""
    path = tmp_path_factory.mktemp("moe_train") / "reference.npz"
    arg = json.dumps([REFS, S, E, OPT, str(path)])
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), arg], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
             "HOME": os.environ.get("HOME", "/tmp")})
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr[-3000:]}"
    ref = dict(np.load(path))
    weights = convert.model_params_from_numpy(_pcfg("topk-4"), _tree(ref, "weights/"))

    calls = []
    for name, (ref_key, _, mesh, _, specs) in CASES.items():
        B = REFS[ref_key][3]
        rs = ref[f"{ref_key}/rs_in"] if REFS[ref_key][0] == "potus" else None
        calls.append((ex.train_rank, (_pcfg(ref_key), _ptcfg(name), mesh, weights,
                                      [_batch(ref, B)]),
                      {"grad_specs": specs, "device": "cpu", "router_state": rs, "probe": True}))
    ckpt_dir = tmp_path_factory.mktemp("moe_ckpt")
    calls.append((ex.checkpoint_rank, (_pcfg("ep-topk-0.5"), _ptcfg("b-topk-cf0.5"), (4, 1),
                                       weights, _batch(ref, 8), str(ckpt_dir),
                                       [(2, 1), None]), {"device": "cpu"}))
    world = spawn_world(call_each, WORLD, "gloo", WORLD_TIMEOUT_S, (calls,))
    n = len(CASES)
    return dict(ref=ref, weights=weights,
                cases={name: [w[i] for w in world] for i, name in enumerate(CASES)},
                ckpt=[w[n] for w in world], ckpt_dir=ckpt_dir)


def _mesh(mesh_shape, rank):
    n_data, n_model = mesh_shape
    if rank >= n_data * n_model:
        return ModelMesh()
    return ModelMesh((("data", Axis(None, n_data, rank // n_model)),
                      ("model", Axis(None, n_model, rank % n_model))))


def _one_rank_probe(ran, ref_key):
    """The port's one-rank forward of the case's weights, state and batch."""
    cache = ran.setdefault("probes", {})
    if ref_key not in cache:
        router, cf, tkw, B, _ = REFS[ref_key]
        cfg = _pcfg(ref_key).with_(moe_ep_shardmap=False)
        tcfg = ptl.TrainConfig(opt=popt.OptConfig(**OPT))
        state = ex._state(cfg, tcfg, None, ran["weights"], "cpu")
        if router == "potus":
            state["router_state"] = torch.from_numpy(ran["ref"][f"{ref_key}/rs_in"])
        cache[ref_key] = ex.moe_probe(cfg, state, _batch(ran["ref"], B), None)
    return cache[ref_key]


@pytest.mark.parametrize("name", list(CASES))
def test_moe_step_matches_reference(ran, name):
    ref_key, _, mesh_shape, _, _ = CASES[name]
    ref, pcfg, pt = ran["ref"], _pcfg(ref_key), _ptcfg(name)
    want_params = convert.model_params_from_numpy(pcfg, _tree(ref, f"{ref_key}/params/"))
    want_m = convert.model_params_from_numpy(pcfg, _tree(ref, f"{ref_key}/m/"),
                                             dtype=torch.float32)
    lr = float(ref[f"{ref_key}/metrics/lr"])
    bound = _param_bound({n: m / (1 - pt.opt.b1) for n, m in want_m.items()}, lr)
    ranks = ran["cases"][name]
    members = [r for r, out in enumerate(ranks) if out["member"]]
    assert len(members) == mesh_shape[0] * mesh_shape[1]
    for r in members:
        got = ranks[r]
        met = got["metrics"][0]
        for key in ("loss", "ce", "moe_aux", "grad_norm"):
            want = float(ref[f"{ref_key}/metrics/{key}"])
            assert _rel(met[key], want) <= 1e-5, (r, key, met[key], want)
        assert _rel(met["lr"], lr) <= 1e-6
        assert int(met["ntok"]) == int(ref[f"{ref_key}/metrics/ntok"])
        np.testing.assert_array_equal(got["state"]["router_state"].numpy(),
                                      ref[f"{ref_key}/router_state"])
        sh = ptl.state_shardings(pcfg, _mesh(mesh_shape, r), pt)
        for n, w in want_params.items():
            gap = (got["state"]["params"][n] - sh["params"][n].local(w)).abs()
            assert bool((gap <= sh["params"][n].local(bound[n])).all()), (r, n)
        for n, w in want_m.items():
            blk = sh["opt"]["m"][n].local(w)
            m = got["state"]["m"][n]
            assert m.shape == blk.shape, (r, n)
            assert float((m - blk).abs().max()) / max(float(w.abs().max()), 1e-30) <= 1e-4, n
        assert got["state"]["step"] == 1
        first = ranks[members[0]]["state"]["params"]
        for n, p in got["state"]["params"].items():  # the replicated weights, the same bitwise
            if sh["params"][n].replicated:
                assert torch.equal(p, first[n]), (r, n)
        if REFS[ref_key][3] % mesh_shape[0] == 0:  # the rows split: the router's collectives
            route = "ep" if pcfg.moe_ep_shardmap else "moe"
            assert got["tags"][0].get(route, 0) > 0, got["tags"]
        assert got["tags"][0].get("dp", 0) > 0, got["tags"]


@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_matches_one_rank(ran, name):
    """Each MoE layer of the forward before the step, on the ranks, against
    the port's one-rank forward of the whole batch."""
    ref_key, _, mesh_shape, _, _ = CASES[name]
    router, cf, _, B, ep = REFS[ref_key]
    one = _one_rank_probe(ran, ref_key)
    ranks = [out for out in ran["cases"][name] if out["member"]]
    split = B % mesh_shape[0] == 0
    for i, want in enumerate(one):
        if ep and (router != "topk" or (cf < 1 and i > 0)):
            break  # the routes' drops differ: the layers after the first see other inputs
        for out in ranks:
            got = out["probe"][i]
            assert torch.equal(got["load"], want["load"]), (name, i)
            if not ep:
                assert float(got["dropped_frac"]) == float(want["dropped_frac"]), (name, i)
                if want["router_state"] is not None:
                    assert torch.equal(got["router_state"], want["router_state"]), (name, i)
                assert _rel(got["aux_loss"], want["aux_loss"]) <= 1e-5, (name, i)
        parts = [out["probe"][i] for out in ranks] if split else [ranks[0]["probe"][i]]
        assert torch.equal(torch.cat([p["top_i"] for p in parts]), want["top_i"]), (name, i)
        if not ep:
            assert torch.equal(torch.cat([p["keep"] for p in parts]), want["keep"]), (name, i)
    if cf < 1 and not ep:
        assert any(float(layer["dropped_frac"]) > 0 for layer in one)


def test_ranks_off_the_mesh_keep_their_state(ran):
    ranks = ran["cases"]["a-topk-cf0.5-2x1-two-off"]
    assert [out["member"] for out in ranks] == [True, True, False, False]
    for out in ranks[2:]:
        assert out["metrics"] == ranks[0]["metrics"]
        assert out["state"]["step"] == 0
        for n, w in ran["weights"].items():
            assert torch.equal(out["state"]["params"][n], w), n


def test_expert_parallel_state_restores_across_meshes(ran, tmp_path):
    """A route (b) state saved on four ranks (its experts and their moments
    E/4 a rank), restored onto a 2x1 mesh (ranks 2, 3 off it: the whole
    state) and onto one rank: bitwise the global state's blocks; the files
    byte for byte those of a one-rank checkpoint of it."""
    pcfg, pt = _pcfg("ep-topk-0.5"), _ptcfg("b-topk-cf0.5")
    outs = ran["ckpt"]
    sh4 = [ck.flatten_state(ptl.state_shardings(pcfg, _mesh((4, 1), r), pt)) for r in range(4)]
    full = {}
    for key, leaf in outs[0]["saved"].items():
        cuts = sh4[0][key].cuts() if key in sh4[0] else []
        full[key] = (torch.cat([o["saved"][key] for o in outs], dim=cuts[0][0]) if cuts
                     else leaf)
    assert full["params/blocks.0.moe.w_gate"].shape[0] == E
    assert outs[0]["saved"]["params/blocks.0.moe.w_gate"].shape[0] == E // 4
    for r, out in enumerate(outs):
        one = out["restored"][None]["leaves"]
        assert list(one) == list(full)
        for k, t in full.items():
            assert torch.equal(one[k], t), (r, k)
        two = out["restored"][(2, 1)]["leaves"]
        sh = ck.flatten_state(ptl.state_shardings(pcfg, _mesh((2, 1), r), pt))
        for k, t in full.items():
            assert torch.equal(two[k], sh[k].local(t) if k in sh else t), (r, k)
    ck.save_checkpoint(tmp_path, 1, full, extra=dict(batch_seed=0))
    b = tmp_path / "step_1"
    names = sorted(p.name for p in b.iterdir())
    a = Path(ran["ckpt_dir"]) / "step_1"
    assert sorted(p.name for p in a.iterdir()) == names
    assert all(filecmp.cmp(a / n, b / n, shallow=False) for n in names)


def _small_batch(cfg, B=4):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("ep", [False, True], ids=["global-batch", "expert-parallel"])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_one_by_one_mesh_moe_step_is_the_meshless_step_bitwise(ep, cf):
    cfg = _pcfg("topk-4").with_(router="potus", capacity_factor=cf, moe_ep_shardmap=ep)
    tcfg = ptl.TrainConfig(opt=popt.OptConfig(**OPT))
    batch = _small_batch(cfg)

    def run(mesh):
        set_mesh(mesh)
        try:
            state = ex._state(cfg, tcfg, mesh, None, "cpu")
            state["router_state"] = torch.arange(E, dtype=torch.float32) * 0.5
            specs = None
            if mesh is not None:
                specs = psh.specs_for_template(ex.pz.template(cfg), psh.zero_rules(mesh), mesh)
            step = ptl.make_train_step(cfg, tcfg, specs)
            for _ in range(2):
                state, met = step(state, batch)
        finally:
            set_mesh(None)
        return ck.flatten_state(state), met

    (a, ma), (b, mb) = run(None), run(make_host_mesh(1, 1))
    assert list(a) == list(b)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_state_shardings_layouts():
    """Route (a) holds every parameter whole, its moments by the ZeRO-1
    specs; route (b) holds the experts as blocks of E/n, their moments the
    same blocks."""
    mesh = _mesh((4, 1), 1)
    tcfg = ptl.TrainConfig()
    for ep in (False, True):
        cfg = _pcfg("topk-4").with_(moe_ep_shardmap=ep)
        held = ptl.state_shardings(cfg, mesh, tcfg)
        ref = psh.train_state_shardings(cfg, mesh, tcfg)
        for n in held["params"]:
            expert = n.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") and ".moe." in n \
                and ".shared." not in n
            assert held["params"][n].replicated == (not (ep and expert)), n
            if ep and expert:
                assert held["params"][n].cuts() == [(0, ("data",))], n
                assert held["opt"]["m"][n] == held["params"][n] == held["opt"]["v"][n]
            else:
                assert held["opt"]["m"][n] == ref["opt"]["m"][n], n
            if expert:  # the reference's layout cuts the expert FFN's inner dim over "data"
                assert not ref["params"][n].replicated, n


def test_expert_parallel_route_refuses_a_batch_that_does_not_split():
    cfg = _pcfg("ep-topk-4")
    tcfg = ptl.TrainConfig(opt=popt.OptConfig(**OPT))
    mesh = _mesh((4, 1), 0)
    set_mesh(mesh)
    try:
        state = ex._state(cfg, tcfg, mesh, None, "cpu")
        step = ptl.make_train_step(cfg, tcfg)
        with pytest.raises(ValueError, match="split over the 4 ranks"):
            step(state, _small_batch(cfg, B=6))
    finally:
        set_mesh(None)
