"""The port's expert-parallel MoE (``models/moe_ep.py``), its model mesh
(``launch/mesh.py``) and the MoE blocks' dispatch under a mesh, against the
reference's ``repro.models.moe_ep`` on a four-device CPU mesh.

* The reference side runs once for the module in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (jax fixes its
  device count at start-up), as ``tests/test_distributed.py`` does, and
  writes its weights, inputs and outputs to an ``.npz``.
* The port side is one four-rank gloo world (``spawn_world`` + ``call_each``)
  that runs every case: ``moe_ffn_ep`` on ``granite_moe_1b.reduced()`` with
  8 experts, top-2, d_ff 256, on meshes 4x1 and 2x2, with the top-k router
  and with POTUS carrying its state over two calls, at capacity factor 4.0
  (no drops) and 0.5 (drops on the send and the receive side), and with a
  shared expert; ``load``, ``dropped_frac`` and ``router_state`` exactly,
  ``aux_loss`` within 1e-6, y within 1e-5 of max |y|, every rank's y the
  same. The reduced MoE model (``moe_ep_shardmap=True``, the reference's
  weights through ``convert``) on the 4x1 mesh: ``forward``, ``prefill``
  and four ``decode_step``s within 1e-4 of the reference's under its own
  mesh (``set_mesh``), and the same world without a mesh runs ``moe_ffn``
  (no ``"ep"`` payload), equal to the port in this process.
* In this process: a 1x1 mesh equals ``moe_ffn``; with no mesh set the MoE
  route is ``moe_ffn``; the ``ValueError`` shapes; the ``"pod"`` guard;
  ``place_``'s blocks; the mesh factories' raises.
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
from repro_torch.distributed import SOLO, Axis, call_each, get_mesh, set_mesh, spawn_world
from repro_torch.launch import mesh as pmesh
from repro_torch.models import model_zoo as pz
from repro_torch.models import moe as pm
from repro_torch.models import moe_ep as pep
from repro_torch.serving.engine import Request, ServingEngine

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_moe_ep as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

# (mesh (n_data, n_model), router, capacity factor, shared experts)
CASES = [(m, r, cf, 0) for m in ((4, 1), (2, 2)) for r in ("topk", "potus") for cf in (4.0, 0.5)]
CASES += [((2, 2), "potus", 0.5, 1), ((4, 1), "topk", 4.0, 1)]
X_SHAPE = (4, 16)  # (B, S): N = 64 rows, 16 or 32 a data rank
MODEL_TOKENS = (4, 16)  # a decode step runs B = 4 rows, one a data rank
MODEL_MAX_LEN, MODEL_STEPS = 24, 4
WORLD_TIMEOUT_S = 180

_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed.context import set_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import model_zoo as rz
from repro.models.common import init_params
from repro.models.moe import moe_template
from repro.models.moe_ep import moe_ffn_ep

cases, x_shape, tok_shape, max_len, steps, path = json.loads(sys.argv[1])
out = {}
base = get_config("granite_moe_1b").reduced().with_(n_experts=8, top_k=2, d_ff=256)
for i, (mesh_shape, router, cf, shared) in enumerate(cases):
    cfg = base.with_(router=router, capacity_factor=cf, n_shared_experts=shared)
    p = init_params(jax.random.PRNGKey(i), moe_template(cfg), jnp.float32)
    for name, leaf in jax.tree_util.tree_leaves_with_path(p):
        out[f"{i}/p/" + "/".join(k.key for k in name)] = np.asarray(leaf)
    mesh = make_host_mesh(*mesh_shape)
    rng = np.random.default_rng(i)
    rs = jnp.arange(cfg.n_experts, dtype=jnp.float32) * 0.5 if router == "potus" else None
    call = jax.jit(lambda p_, x_, rs_, cfg=cfg, mesh=mesh: moe_ffn_ep(p_, x_, cfg, mesh, rs_))
    for c in range(2 if router == "potus" else 1):
        x = rng.standard_normal((*x_shape, cfg.d_model)).astype(np.float32)
        with mesh:
            y, aux = call(p, jnp.asarray(x), rs)
        out[f"{i}/{c}/x"] = x
        out[f"{i}/{c}/y"] = np.asarray(y)
        for key in ("aux_loss", "dropped_frac", "load"):
            out[f"{i}/{c}/{key}"] = np.asarray(aux[key])
        if rs is not None:
            out[f"{i}/{c}/rs_in"] = np.asarray(rs)
            rs = aux["router_state"]
            out[f"{i}/{c}/router_state"] = np.asarray(rs)

cfg = get_config("granite_moe_1b").reduced().with_(moe_ep_shardmap=True, router="potus")
params = rz.init(jax.random.PRNGKey(7), cfg)
for name, leaf in jax.tree_util.tree_leaves_with_path(params):
    out["model/p/" + "/".join(k.key for k in name)] = np.asarray(leaf)
rng = np.random.default_rng(7)
toks = rng.integers(0, cfg.vocab_size, tok_shape).astype(np.int32)
fed = rng.integers(0, cfg.vocab_size, (steps, tok_shape[0], 1)).astype(np.int32)
mesh = make_host_mesh(4, 1)
set_mesh(mesh)
with mesh:
    logits, aux = jax.jit(rz.forward, static_argnums=1)(params, cfg, {"tokens": jnp.asarray(toks)})
    pre, cache = jax.jit(rz.prefill, static_argnums=(1, 3))(
        params, cfg, {"tokens": jnp.asarray(toks)}, max_len)
    decode = jax.jit(rz.decode_step, static_argnums=1)
    pos = jnp.full((tok_shape[0],), tok_shape[1], jnp.int32)
    dec = []
    for s in range(steps):
        lg, cache = decode(params, cfg, jnp.asarray(fed[s]), pos, cache)
        dec.append(np.asarray(lg))
        pos = pos + 1
set_mesh(None)
out.update({"model/tokens": toks, "model/fed": fed, "model/forward": np.asarray(logits),
            "model/router_state": np.asarray(aux["router_state"]),
            "model/prefill": np.asarray(pre), "model/decode": np.stack(dec)})
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


def _pcfg(router, cf, shared):
    return get_config("granite_moe_1b").reduced().with_(
        n_experts=8, top_k=2, d_ff=256, router=router, capacity_factor=cf,
        n_shared_experts=shared)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's subprocess and the port's four-rank world, side by
    side: {"ref": the reference's arrays, "port": each rank's results}."""
    path = tmp_path_factory.mktemp("moe_ep") / "reference.npz"
    arg = json.dumps([CASES, X_SHAPE, MODEL_TOKENS, MODEL_MAX_LEN, MODEL_STEPS, str(path)])
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

    calls = []
    for i, (mesh_shape, router, cf, shared) in enumerate(CASES):
        cfg = _pcfg(router, cf, shared)
        state = convert.moe_params_from_numpy(_tree(ref, f"{i}/p/"))
        n = 2 if router == "potus" else 1
        xs = [torch.from_numpy(ref[f"{i}/{c}/x"]) for c in range(n)]
        rs = torch.from_numpy(ref[f"{i}/0/rs_in"]) if router == "potus" else None
        calls.append((ex.layer_rank, (cfg, mesh_shape, state, xs, rs), {"device": "cpu"}))
    mcfg, state = _model_cfg_state(ref)
    margs = (state, ref["model/tokens"], MODEL_MAX_LEN, list(ref["model/fed"]))
    calls.append((ex.model_rank, (mcfg, (4, 1), *margs), {"device": "cpu"}))
    calls.append((ex.model_rank, (mcfg, None, *margs), {"device": "cpu"}))
    return {"ref": ref, "port": spawn_world(call_each, 4, "gloo", WORLD_TIMEOUT_S, (calls,))}


def _model_cfg_state(ref):
    cfg = get_config("granite_moe_1b").reduced().with_(moe_ep_shardmap=True, router="potus")
    return cfg, convert.model_params_from_numpy(cfg, _tree(ref, "model/p/"))


def _gap(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{m[0]}x{m[1]}-{r}-cf{cf}" + ("-shared" if s else "")
                              for m, r, cf, s in CASES])
def test_moe_ffn_ep_matches_reference(ran, case):
    ref = ran["ref"]
    ranks = [outs[case] for outs in ran["port"]]
    router, cf = CASES[case][1], CASES[case][2]
    for c, got in enumerate(ranks[0]):
        want = lambda key: ref[f"{case}/{c}/{key}"]  # noqa: E731
        np.testing.assert_array_equal(got["load"].numpy(), want("load"))
        assert float(got["dropped_frac"]) == float(want("dropped_frac"))
        if cf < 1:  # drops on both sides: the send side's in dropped_frac, the receive side's
            assert float(got["dropped_frac"]) > 0 and not bool(got["keep_recv"].all())
        if router == "potus":
            np.testing.assert_array_equal(got["router_state"].numpy(), want("router_state"))
        else:
            assert got["router_state"] is None
        np.testing.assert_allclose(float(got["aux_loss"]), float(want("aux_loss")), rtol=0,
                                   atol=1e-6)
        assert _gap(got["y"].numpy(), want("y")) <= 1e-5
        for other in ranks[1:]:  # every rank returns the same global y and aux
            assert torch.equal(other[c]["y"], got["y"])
            assert torch.equal(other[c]["load"], got["load"])
            assert other[c]["elements"] == got["elements"] > 0


def test_model_under_mesh_matches_reference(ran):
    """The reduced MoE model on the 4x1 mesh (``Block.ffn`` runs
    ``moe_ffn_ep``: the ranks move an ``"ep"`` payload) against the
    reference's model under its mesh."""
    ref = ran["ref"]
    for outs in ran["port"]:
        got = outs[len(CASES)]
        for key in ("forward", "prefill", "decode"):
            np.testing.assert_allclose(got[key], ref[f"model/{key}"], rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        np.testing.assert_array_equal(got["router_state"], ref["model/router_state"])
        assert got["elements"] > 0
        for key in ("forward", "prefill", "decode"):
            np.testing.assert_array_equal(got[key], ran["port"][0][len(CASES)][key])


def test_moe_block_across_ranks_without_mesh_runs_moe_ffn(ran):
    """Across four ranks with no mesh set, every rank runs ``moe_ffn`` (no
    collective) and equals the port in this process bitwise."""
    ref = ran["ref"]
    cfg, state = _model_cfg_state(ref)
    here = ex.model_rank(cfg, None, state, ref["model/tokens"], MODEL_MAX_LEN,
                         list(ref["model/fed"]), device="cpu")
    assert here["elements"] == 0
    for outs in ran["port"]:
        got = outs[len(CASES) + 1]
        assert got["elements"] == 0
        for key in ("forward", "prefill", "decode", "router_state"):
            np.testing.assert_array_equal(got[key], here[key], err_msg=key)


def _layer(cfg, seed=0):
    moe = pm.MoE(cfg)
    return pz.fill_(moe, torch.Generator().manual_seed(seed)).requires_grad_(False)


@pytest.mark.parametrize("router", ["topk", "potus"])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_one_by_one_mesh_equals_moe_ffn(router, cf):
    """On a 1x1 mesh the send side keeps every entry at a capacity factor of
    at least 1, and the receive side's order is token-major: selections,
    the kept entries, load, router state and y are ``moe_ffn``'s. The
    reference's ``dropped_frac`` counts the send side only, so at 1.0 it is
    0 where ``moe_ffn`` counts the capacity drops."""
    cfg = _pcfg(router, cf, 0)
    moe = _layer(cfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 32, cfg.d_model))
                         .astype(np.float32))
    rs = torch.arange(cfg.n_experts, dtype=torch.float32) if router == "potus" else None
    mesh = pmesh.make_host_mesh(1, 1)
    y_ep, a_ep = pep.moe_ffn_ep(moe, x, cfg, mesh, rs)
    y, a = pm.moe_ffn(moe, x, cfg, rs)
    nk = x.shape[0] * x.shape[1] * cfg.top_k
    assert torch.equal(a_ep["top_i"], a["top_i"])
    assert a_ep["keep"].all()
    assert torch.equal(a_ep["keep_recv"][:nk], a["keep"]) and not a_ep["keep_recv"][nk:].any()
    assert torch.equal(a_ep["load"], a["load"])
    if router == "potus":
        assert torch.equal(a_ep["router_state"], a["router_state"])
    assert float(a_ep["dropped_frac"]) == 0.0
    if cf < 4:
        assert float(a["dropped_frac"]) > 0
    assert torch.equal(y_ep, y)
    assert abs(float(a_ep["aux_loss"]) - float(a["aux_loss"])) <= 1e-6


def test_no_mesh_routes_moe_ffn_and_mesh_routes_moe_ffn_ep(monkeypatch):
    cfg = get_config("granite_moe_1b").reduced().with_(moe_ep_shardmap=True)
    model = pz.init(cfg, torch.Generator().manual_seed(0), "cpu")
    block = next(b for b in model.blocks if b.moe is not None)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, cfg.d_model))
                         .astype(np.float32))
    seen = []
    monkeypatch.setattr(pz, "moe_ffn_ep", lambda *a: seen.append("ep") or pep.moe_ffn_ep(*a))
    monkeypatch.setattr(pz, "moe_ffn", lambda *a: seen.append("ffn") or pm.moe_ffn(*a))
    assert get_mesh() is None
    out_plain = block.ffn(x, cfg)
    set_mesh(pmesh.make_host_mesh(1, 1))
    try:
        out_ep = block.ffn(x, cfg)
        block.ffn(x, cfg.with_(moe_ep_shardmap=False))
    finally:
        set_mesh(None)
    assert seen == ["ffn", "ep", "ffn"]
    assert torch.equal(out_plain[0], out_ep[0])


def _fake_mesh(n_data, n_model):
    """A mesh whose sizes the checks read (the raises come before any
    collective)."""
    return pmesh.ModelMesh((("data", Axis(None, n_data, 0)), ("model", Axis(None, n_model, 0))))


@pytest.mark.parametrize("mesh, shape, what", [
    ((3, 1), (1, 6), "n_experts"), ((1, 3), (1, 6), "d_ff"), ((2, 1), (1, 3), "token rows")])
def test_shapes_that_do_not_split_raise(mesh, shape, what):
    cfg = _pcfg("topk", 4.0, 0)
    x = torch.zeros((*shape, cfg.d_model))
    with pytest.raises(ValueError, match=what):
        pep.moe_ffn_ep(_layer(cfg), x, cfg, _fake_mesh(*mesh))


def test_unplaced_weights_and_serving_shapes_raise():
    """Unplaced weights raise; so does serving under a 4x1 mesh where a
    prefill's rows (the prompt length) or a decode round's (``max_batch``)
    do not split over the 4 data ranks: the first MoE layer refuses them."""
    cfg = _pcfg("topk", 4.0, 0)
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="place_"):
        pep.moe_ffn_ep(_layer(cfg), x, cfg, _fake_mesh(2, 1))
    mcfg = get_config("granite_moe_1b").reduced().with_(moe_ep_shardmap=True)
    model = pz.init(mcfg, torch.Generator().manual_seed(0), "cpu")
    _, cache = pz.prefill(model, mcfg, {"tokens": torch.zeros((2, 8), dtype=torch.long)}, 12)
    mesh = _fake_mesh(4, 1)
    pep.place_(model, mesh)
    engine = ServingEngine(mcfg, model, max_batch=4, max_len=12)
    engine.submit(Request(0, np.zeros(6, dtype=np.int64), max_new=2))
    set_mesh(mesh)
    try:
        with pytest.raises(ValueError, match="token rows"):
            engine.step()
        with pytest.raises(ValueError, match="token rows"):
            pz.decode_step(model, mcfg, torch.zeros((2, 1), dtype=torch.long),
                           torch.full((2,), 8, dtype=torch.int32), cache)
    finally:
        set_mesh(None)


def test_pod_axis_raises_item_5b():
    cfg = _pcfg("topk", 4.0, 0)
    mesh = pmesh.ModelMesh((("pod", SOLO), ("data", SOLO), ("model", SOLO)))
    assert mesh.axis_names == ("pod", "data", "model")
    with pytest.raises(NotImplementedError, match="module item 5b"):
        pep.moe_ffn_ep(_layer(cfg), torch.zeros((1, 4, cfg.d_model)), cfg, mesh)


def test_mesh_factories():
    assert pmesh.make_mesh_shape() == ((16, 16), ("data", "model"))
    assert pmesh.make_mesh_shape(multi_pod=True) == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="need 256 ranks"):
        pmesh.make_production_mesh()
    with pytest.raises(ValueError, match="need 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="need 4 ranks"):
        pmesh.make_host_mesh(2, 2)
    mesh = pmesh.make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.member


@pytest.mark.parametrize("data_index, model_index", [(0, 0), (1, 1)])
def test_place_cuts_this_ranks_blocks(data_index, model_index):
    cfg = _pcfg("topk", 4.0, 1)
    whole = _layer(cfg)
    mesh = pmesh.ModelMesh((("data", Axis(None, 2, data_index)),
                            ("model", Axis(None, 2, model_index))))
    placed = pep.place_(_layer(cfg), mesh)
    e = slice(4 * data_index, 4 * data_index + 4)
    f = slice(128 * model_index, 128 * model_index + 128)
    assert torch.equal(placed.router, whole.router)
    assert torch.equal(placed.w_gate, whole.w_gate[e, :, f])
    assert torch.equal(placed.w_up, whole.w_up[e, :, f])
    assert torch.equal(placed.w_down, whole.w_down[e, f])
    assert torch.equal(placed.shared.w_gate.weight, whole.shared.w_gate.weight[f])
    assert torch.equal(placed.shared.w_out.weight, whole.shared.w_out.weight[:, f])
