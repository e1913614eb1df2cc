"""Tensor-parallel training of the MoE decoder (``training.train_loop`` under
a model mesh with a ``"model"`` axis above 1 and an MoE config) on four gloo
ranks on the CPU, by the reference's two routes.

* The reference side runs once for the module in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (jax fixes its
  device count at start-up), as ``tests/test_torch_moe_train.py`` does: one
  jitted train step from the weights of key 1 on the global batch of seed 0
  of ``granite_moe_1b.reduced()`` (4 experts, top-2), of
  ``llama4_maverick_400b.reduced()`` (a shared expert, ``moe_interleave=2``,
  top-1) and of the reduced granite with a vocabulary of 513 (which divides
  neither 2 nor 4): on one device, the truth for route (a), and under (1, 4)
  and (2, 2) meshes with ``moe_ep_shardmap``, the reference's
  expert-parallel step, the truth for route (b).
* The port side is one four-rank gloo world (``spawn_world`` +
  ``call_each``: one start-up) that runs every case through
  ``examples/torch_train_dp.py``'s ``train_rank`` from the reference's
  weights (``convert``):

  - route (a), the global-batch router with E/m experts a model rank
    (``moe_ffn``'s ``tp``): ``topk`` at capacity factor 4.0 on (1, 2),
    (1, 4) and (2, 2), with ``microbatches=2`` and with ZeRO-1 and
    ``grad_specs`` off on (2, 2); ``potus`` from the state
    ``arange(E) * 0.5`` at 0.5 (drops) on (2, 2); the whole vocabulary on
    (1, 4); the shared expert on (2, 2);
  - route (b), the expert-parallel route (E/d experts a data rank, each cut
    to its F/m block over "model"): ``topk`` at 4.0 on (1, 4) and (2, 2),
    ``potus`` at 0.5 on (2, 2), the shared expert on (2, 2);
  - a route (b) state saved on (2, 2) and restored onto (4, 1), (1, 4) and
    no mesh, and a route (a) state saved on (2, 2) and restored onto no
    mesh.

  Each step, on every rank: loss, ce, ``moe_aux`` and grad norm within rel
  1e-5, ``ntok`` and the router state equal; the parameters, this rank's
  blocks of them, within ``_param_bound`` (``tests/test_torch_training.py``);
  leaf by leaf this rank's block of the first moment within 1e-4 of the
  reference moment's scale (a gradient scaled by the model axis's size would
  miss by a factor of it); each replicated leaf's gradient (its moment block)
  bitwise the same on the model ranks of a data row, every replicated
  parameter the same on every rank. The forward before the step
  (``moe_probe``) is held against the port's one-rank forward, which
  ``tests/test_torch_moe.py`` holds to the reference's selections exactly:
  each layer's loads and, for route (a), ``dropped_frac``, the router state
  and keep masks equal, the data rows' selections in order equal (route
  (b), which routes each rank's tokens on their own, only under ``topk``).

In this process: ``state_shardings``' layouts of both routes on (2, 2). The
configs that still raise on a ``"model"`` axis are held in
``tests/test_torch_dp_train.py``.
"""
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
from repro_torch.distributed import Axis, call_each, spawn_world
from repro_torch.launch.mesh import ModelMesh
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl
from test_torch_moe_train import _tree
from test_torch_training import _param_bound, _rel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_train_dp as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

S, B = 32, 8
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
WORLD, WORLD_TIMEOUT_S = 4, 240
# model: (arch, config fields over its reduced config)
MODELS = {"granite": ("granite_moe_1b", {}), "llama": ("llama4_maverick_400b", {}),
          "granite-v513": ("granite_moe_1b", {"vocab_size": 513})}
# reference step: (model, router, capacity factor, TrainConfig fields, expert-parallel mesh or
# None: one device)
REFS = {
    "topk-4": ("granite", "topk", 4.0, {}, None),
    "potus-0.5": ("granite", "potus", 0.5, {}, None),
    "topk-4-micro2": ("granite", "topk", 4.0, {"microbatches": 2}, None),
    "v513-topk-4": ("granite-v513", "topk", 4.0, {}, None),
    "llama-topk-4": ("llama", "topk", 4.0, {}, None),
    "ep-topk-4-1x4": ("granite", "topk", 4.0, {}, (1, 4)),
    "ep-topk-4-2x2": ("granite", "topk", 4.0, {}, (2, 2)),
    "ep-potus-0.5-2x2": ("granite", "potus", 0.5, {}, (2, 2)),
    "llama-ep-2x2": ("llama", "topk", 4.0, {}, (2, 2)),
}
# case: (reference, mesh, zero_sharding and grad_specs)
CASES = {
    "a-topk-cf4-1x2": ("topk-4", (1, 2), True),
    "a-topk-cf4-1x4": ("topk-4", (1, 4), True),
    "a-topk-cf4-2x2": ("topk-4", (2, 2), True),
    "a-potus-cf0.5-2x2": ("potus-0.5", (2, 2), True),
    "a-topk-cf4-2x2-microbatches2": ("topk-4-micro2", (2, 2), True),
    "a-topk-cf4-2x2-replicated": ("topk-4", (2, 2), False),
    "a-whole-vocab-1x4": ("v513-topk-4", (1, 4), True),
    "a-shared-expert-2x2": ("llama-topk-4", (2, 2), True),
    "b-topk-cf4-1x4": ("ep-topk-4-1x4", (1, 4), True),
    "b-topk-cf4-2x2": ("ep-topk-4-2x2", (2, 2), True),
    "b-potus-cf0.5-2x2": ("ep-potus-0.5-2x2", (2, 2), True),
    "b-shared-expert-2x2": ("llama-ep-2x2", (2, 2), True),
}
# checkpoints: (case, the meshes the (2, 2) state is restored onto)
CKPTS = {"b": ("b-topk-cf4-2x2", [(4, 1), (1, 4), None]), "a": ("a-topk-cf4-2x2", [None])}

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

models, refs, S, B, opt, path = json.loads(sys.argv[1])
out = {}

def put(prefix, tree):
    for name, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(k.key for k in name)] = np.asarray(leaf)

for key, (model, router, cf, tkw, mesh_shape) in refs.items():
    arch, extra = models[model]
    cfg = get_config(arch).reduced().with_(router=router, capacity_factor=cf,
                                           moe_ep_shardmap=mesh_shape is not None, **extra)
    tcfg = rtl.TrainConfig(opt=ropt.OptConfig(**opt), **tkw)
    state = rtl.init_train_state(jax.random.PRNGKey(1), cfg, tcfg)
    if router == "potus":
        state["router_state"] = jnp.arange(cfg.n_experts, dtype=jnp.float32) * 0.5
    out[f"{key}/rs_in"] = np.asarray(state["router_state"])
    put(f"{model}/weights/", state["params"])
    batch = make_batch(np.random.default_rng(0), cfg, B=B, S=S)
    for name, a in batch.items():
        out[f"{model}/batch/{name}"] = np.asarray(a)
    if mesh_shape is not None:
        mesh = make_host_mesh(*mesh_shape)
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


def _pcfg(ref_key):
    model, router, cf, _, mesh = REFS[ref_key]
    arch, extra = MODELS[model]
    return get_config(arch).reduced().with_(router=router, capacity_factor=cf,
                                            moe_ep_shardmap=mesh is not None, **extra)


def _ptcfg(name):
    ref_key, _, zero = CASES[name]
    return ptl.TrainConfig(opt=popt.OptConfig(**OPT, zero_sharding=zero), **REFS[ref_key][3])


def _batch(ref, model):
    prefix = f"{model}/batch/"
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def _weights(ref, model):
    ref_key = next(k for k, r in REFS.items() if r[0] == model)
    return convert.model_params_from_numpy(_pcfg(ref_key), _tree(ref, f"{model}/weights/"))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's subprocess and the port's four-rank world, side by
    side: the reference's arrays, the weights, each case's and each
    checkpoint's results by rank."""
    path = tmp_path_factory.mktemp("moe_tp_train") / "reference.npz"
    arg = json.dumps([MODELS, REFS, S, B, OPT, str(path)])
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
    weights = {model: _weights(ref, model) for model in MODELS}

    calls = []
    for name, (ref_key, mesh, zero) in CASES.items():
        model, router = REFS[ref_key][:2]
        rs = ref[f"{ref_key}/rs_in"] if router == "potus" else None
        calls.append((ex.train_rank, (_pcfg(ref_key), _ptcfg(name), mesh, weights[model],
                                      [_batch(ref, model)]),
                      {"grad_specs": zero, "device": "cpu", "router_state": rs, "probe": True}))
    ckpt_dirs = {}
    for route, (name, restore) in CKPTS.items():
        ref_key, mesh, _ = CASES[name]
        model = REFS[ref_key][0]
        ckpt_dirs[route] = tmp_path_factory.mktemp(f"moe_tp_ckpt_{route}")
        calls.append((ex.checkpoint_rank, (_pcfg(ref_key), _ptcfg(name), mesh, weights[model],
                                           _batch(ref, model), str(ckpt_dirs[route]), restore),
                      {"device": "cpu"}))
    world = spawn_world(call_each, WORLD, "gloo", WORLD_TIMEOUT_S, (calls,))
    n = len(CASES)
    return dict(ref=ref, weights=weights,
                cases={name: [w[i] for w in world] for i, name in enumerate(CASES)},
                ckpt={route: [w[n + i] for w in world] for i, route in enumerate(CKPTS)})


def _mesh_of(shape, rank) -> ModelMesh:
    """Rank ``rank``'s view of a ``shape`` mesh, without a process group
    (to cut blocks with; None: no mesh)."""
    if shape is None or rank >= shape[0] * shape[1]:
        return ModelMesh()
    n_data, n_model = shape
    return ModelMesh((("data", Axis(None, n_data, rank // n_model)),
                      ("model", Axis(None, n_model, rank % n_model))))


def _held(pcfg, pt, shape, rank) -> dict:
    """``state_shardings`` of rank ``rank`` on a ``shape`` mesh, flattened
    as ``checkpoint.flatten_state`` keys."""
    return ck.flatten_state(ptl.state_shardings(pcfg, _mesh_of(shape, rank), pt))


def _cut_over_model(sh) -> bool:
    return any("model" in names for _, names in sh.cuts())


@pytest.mark.parametrize("name", list(CASES))
def test_moe_tp_step_matches_reference(ran, name):
    ref_key, mesh, _ = CASES[name]
    ref, pcfg, pt = ran["ref"], _pcfg(ref_key), _ptcfg(name)
    want_params = convert.model_params_from_numpy(pcfg, _tree(ref, f"{ref_key}/params/"))
    want_m = convert.model_params_from_numpy(pcfg, _tree(ref, f"{ref_key}/m/"),
                                             dtype=torch.float32)
    lr = float(ref[f"{ref_key}/metrics/lr"])
    # the first moment is (1 - b1) * the clipped gradient: the bound is invariant to the scale
    bound = _param_bound({n: m / (1 - pt.opt.b1) for n, m in want_m.items()}, lr)
    ranks = ran["cases"][name]
    members = [r for r, out in enumerate(ranks) if out["member"]]
    assert members == list(range(mesh[0] * mesh[1]))
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
        sh = _held(pcfg, pt, mesh, r)
        for n, w in want_params.items():
            held = sh[f"params/{n}"]
            p = got["state"]["params"][n]
            assert p.shape == held.local(w).shape, (r, n)
            gap = (p - held.local(w)).abs()
            assert bool((gap <= held.local(bound[n])).all()), (r, n)
        for n, w in want_m.items():
            blk = sh[f"opt/m/{n}"].local(w)
            m = got["state"]["m"][n]
            assert m.shape == blk.shape, (r, n)
            assert float((m - blk).abs().max()) / max(float(w.abs().max()), 1e-30) <= 1e-4, (r, n)
        assert got["state"]["step"] == 1
        assert got["tags"][0].get("tp", 0) > 0, got["tags"]
        if pcfg.moe_ep_shardmap:
            assert got["tags"][0].get("ep", 0) > 0, got["tags"]


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_agree_across_model_ranks(ran, name):
    """A leaf that "model" does not cut (the router, the norms, a vocabulary
    that does not divide) has the same gradient on every model rank of a data
    row (its moment block, where "model" does not cut that, bitwise) and the
    same parameter on every rank; the blocks of a model-cut leaf (the
    experts among them) differ."""
    ref_key, mesh, _ = CASES[name]
    pcfg, pt = _pcfg(ref_key), _ptcfg(name)
    ranks = ran["cases"][name]
    sh = _held(pcfg, pt, mesh, 0)
    n_model = mesh[1]
    params = ranks[0]["state"]["params"]
    replicated = [n for n in params if not _cut_over_model(sh[f"params/{n}"])]
    cut = [n for n in params if _cut_over_model(sh[f"params/{n}"])]
    assert replicated and any(n.endswith(".moe.w_up") for n in cut)
    assert not any(n.endswith(".moe.router") for n in cut)
    if pcfg.vocab_size % n_model:
        assert "embed" in replicated and "lm_head.weight" in replicated
    for row in range(mesh[0]):
        first = ranks[row * n_model]
        for r in range(row * n_model + 1, (row + 1) * n_model):
            for n in replicated:
                if not _cut_over_model(sh[f"opt/m/{n}"]):
                    assert torch.equal(ranks[r]["state"]["m"][n], first["state"]["m"][n]), (r, n)
            for n in cut:
                assert not torch.equal(ranks[r]["state"]["params"][n],
                                       first["state"]["params"][n]), (r, n)
    for r in range(1, mesh[0] * n_model):
        for n in replicated:
            assert torch.equal(ranks[r]["state"]["params"][n], params[n]), (r, n)


def _one_rank_probe(ran, ref_key):
    """The port's one-rank forward of the case's weights, state and batch."""
    cache = ran.setdefault("probes", {})
    if ref_key not in cache:
        model, router = REFS[ref_key][:2]
        cfg = _pcfg(ref_key).with_(moe_ep_shardmap=False)
        tcfg = ptl.TrainConfig(opt=popt.OptConfig(**OPT))
        state = ex._state(cfg, tcfg, None, ran["weights"][model], "cpu")
        if router == "potus":
            state["router_state"] = torch.from_numpy(ran["ref"][f"{ref_key}/rs_in"])
        cache[ref_key] = ex.moe_probe(cfg, state, _batch(ran["ref"], model), None)
    return cache[ref_key]


@pytest.mark.parametrize("name", list(CASES))
def test_moe_tp_forward_matches_one_rank(ran, name):
    """Each MoE layer of the forward before the step, on every rank, against
    the port's one-rank forward of the whole batch: the model ranks of a data
    row route the same rows, the data rows' selections in order are the
    whole batch's."""
    ref_key, (n_data, n_model), _ = CASES[name]
    router, ep = REFS[ref_key][1], REFS[ref_key][4] is not None
    one = _one_rank_probe(ran, ref_key)
    ranks = ran["cases"][name][:n_data * n_model]
    assert one
    for i, want in enumerate(one):
        if ep and router != "topk":
            break  # the routes' prices differ: each data rank routes its tokens on its own
        for out in ranks:
            got = out["probe"][i]
            assert torch.equal(got["load"], want["load"]), (name, i)
            if not ep:
                assert float(got["dropped_frac"]) == float(want["dropped_frac"]), (name, i)
                if want["router_state"] is not None:
                    assert torch.equal(got["router_state"], want["router_state"]), (name, i)
                assert _rel(got["aux_loss"], want["aux_loss"]) <= 1e-5, (name, i)
        for d in range(n_data):
            row = [ranks[d * n_model + j]["probe"][i] for j in range(n_model)]
            for p in row[1:]:
                assert torch.equal(p["top_i"], row[0]["top_i"]), (name, i, d)
                assert torch.equal(p["keep"], row[0]["keep"]), (name, i, d)
        parts = [ranks[d * n_model]["probe"][i] for d in range(n_data)]
        assert torch.equal(torch.cat([p["top_i"] for p in parts]), want["top_i"]), (name, i)
        if not ep:
            assert torch.equal(torch.cat([p["keep"] for p in parts]), want["keep"]), (name, i)
    if REFS[ref_key][2] < 1 and not ep:
        assert any(float(layer["dropped_frac"]) > 0 for layer in one)


@pytest.mark.parametrize("route", list(CKPTS))
def test_state_restores_across_meshes(ran, route):
    """Saved on (2, 2) (route (b): the experts E/2 a data rank and F/2 a
    model rank; route (a): E/2 experts a model rank; the moments over both
    axes), restored onto the meshes of ``CKPTS`` (None: no mesh, the whole
    state): each rank's blocks bitwise those of the global state in the
    files, whose (2, 2) blocks are what the ranks saved."""
    name, restore = CKPTS[route]
    ref_key, mesh, _ = CASES[name]
    pcfg, pt = _pcfg(ref_key), _ptcfg(name)
    outs = ran["ckpt"][route]
    full = outs[0]["restored"][None]["leaves"]
    experts = _held(pcfg, pt, mesh, 0)["params/blocks.0.moe.w_gate"]
    assert experts.cuts() == ([(0, ("data",)), (2, ("model",))] if route == "b"
                              else [(0, ("model",))])
    assert full["params/blocks.0.moe.w_gate"].shape[0] == pcfg.n_experts
    for r, out in enumerate(outs):
        assert out["restored"][None]["extra"] == dict(batch_seed=0)
        for k, t in out["restored"][None]["leaves"].items():
            assert torch.equal(t, full[k]), (r, k)
        for shape in (mesh, *restore[:-1]):
            sh = _held(pcfg, pt, shape, r)
            got = out["saved"] if shape == mesh else out["restored"][shape]["leaves"]
            assert list(got) == list(full)
            for k, t in full.items():
                want = sh[k].local(t) if k in sh else t
                assert torch.equal(got[k], want), (shape, r, k)


def test_state_shardings_layouts():
    """On (2, 2): route (a) holds each rank's E/2 experts with F whole, their
    moments the ZeRO-1 blocks within; route (b) holds the blocks
    ``moe_ep.place_`` cuts (E/2 by "data", F/2 by "model"), their moments the
    same blocks; both hold the router whole and cut the attention and the
    shared expert's d_ff over "model" as the reference's rules do."""
    mesh = _mesh_of((2, 2), 1)
    tcfg = ptl.TrainConfig()
    cfg = get_config("llama4_maverick_400b").reduced()
    for ep in (False, True):
        held = ptl.state_shardings(cfg.with_(moe_ep_shardmap=ep), mesh, tcfg)
        p, m = held["params"], held["opt"]["m"]
        for leaf in ("w_gate", "w_up", "w_down"):
            n = f"blocks.1.moe.{leaf}"
            if ep:
                f = 2 if leaf != "w_down" else 1
                assert p[n].cuts() == sorted([(0, ("data",)), (f, ("model",))]), n
                assert m[n] == p[n] == held["opt"]["v"][n], n
            else:
                assert p[n].cuts() == [(0, ("model",))], n
                assert m[n].within(p[n]).cuts() == [(1, ("data",))], n
        assert p["blocks.1.moe.router"].replicated
        assert p["blocks.1.moe.shared.w_gate.weight"].cuts() == [(0, ("model",))]
        assert p["blocks.1.moe.shared.w_out.weight"].cuts() == [(1, ("model",))]
        assert p["blocks.0.mlp.w_up.weight"].cuts() == [(0, ("model",))]
        assert p["blocks.1.attn.wq.weight"].cuts() == [(0, ("model",))]
        assert p["blocks.1.ln2.weight"].replicated
