"""Tensor-parallel training of the dense decoder (``training.train_loop``
under a model mesh with a ``"model"`` axis above 1, ``models.common``'s
Megatron layout, ``distributed.copy_to``/``reduce_from``) on four gloo
ranks on the CPU, against the reference's one-device step
(``repro.training``).

The reference's steps run once in this process (jitted, from the weights of
key 1 on the global batch of seed 0, as ``tests/test_torch_dp_train.py``
draws them); one world of four ranks (``spawn_world`` + ``call_each``: one
start-up) runs every case through ``examples/torch_train_dp.py``'s rank
functions:

* one train step of the reduced (float32) stablelm-3b on (1, 2), (1, 4)
  and (2, 2) meshes, of qwen2.5-32b (4 heads, 2 kv heads: on (1, 4) the kv
  heads stay whole on every rank) and of gemma-7b (``tie_embeddings``: one
  vocabulary-cut leaf is both the lookup and the head) on (1, 2), and on
  (2, 2) stablelm-3b with ``remat="full"``, with ``microbatches=2``, and
  with replicated moments (ZeRO-1 off; every other case has ZeRO-1 moments
  and ``grad_specs``). Each member rank against the reference: loss, ce and
  grad norm within rel 1e-5, ``ntok`` equal; the parameters, this rank's
  blocks of them, within ``_param_bound`` (``tests/test_torch_training.py``);
  leaf by leaf, this rank's block of the first moment, which is (1 - b1)
  times the clipped gradient, within 1e-4 of the reference's moment's scale
  (a gradient scaled by the model axis's size would miss by a factor of
  it); each replicated leaf's gradient (its moment block) bitwise the same
  on every model rank of a data row, and every replicated parameter the
  same on every rank; the ``"tp"`` payload counted;
* a ZeRO-1 state saved on a (2, 2) mesh and restored onto (4, 1), (1, 4)
  and no mesh: bitwise the blocks of the global state that the files hold,
  whose (2, 2) blocks are the ranks' own.

In this process: ``state_shardings``' layouts (the whole-kv case among
them); a (1, 1) mesh and the meshless step are held bitwise in
``tests/test_torch_dp_train.py``, the configs that still raise on a
``"model"`` axis there too.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.specs import make_batch as ref_make_batch
from repro.training import optimizer as ropt
from repro.training import train_loop as rtl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import Axis, call_each, spawn_world
from repro_torch.launch.mesh import ModelMesh
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl
from test_torch_training import _param_bound, _rel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_train_dp as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

S, B = 32, 8
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
WORLD, WORLD_TIMEOUT_S = 4, 240
# case: (arch, TrainConfig fields, mesh, zero_sharding and grad_specs)
CASES = {
    "stablelm-1x2": ("stablelm_3b", {}, (1, 2), True),
    "stablelm-1x4": ("stablelm_3b", {}, (1, 4), True),
    "stablelm-2x2": ("stablelm_3b", {}, (2, 2), True),
    "qwen-1x4-whole-kv": ("qwen2_5_32b", {}, (1, 4), True),
    "gemma-1x2-tied": ("gemma_7b", {}, (1, 2), True),
    "stablelm-2x2-remat": ("stablelm_3b", {"remat": "full"}, (2, 2), True),
    "stablelm-2x2-microbatches2": ("stablelm_3b", {"microbatches": 2}, (2, 2), True),
    "stablelm-2x2-replicated-moments": ("stablelm_3b", {}, (2, 2), False),
}
CKPT_MESH, CKPT_RESTORE = (2, 2), [(4, 1), (1, 4), None]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, tkw, zero):
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rt = rtl.TrainConfig(opt=ropt.OptConfig(**OPT), **tkw)
    pt = ptl.TrainConfig(opt=popt.OptConfig(**OPT, zero_sharding=zero), **tkw)
    return rcfg, pcfg, rt, pt


def _reference(arch, tkw):
    """The reference's weights (key 1), batch (seed 0) and one jitted step."""
    rcfg, pcfg, rt, _ = _configs(arch, tkw, True)
    rstate = rtl.init_train_state(jax.random.PRNGKey(1), rcfg, rt)
    batch = ref_make_batch(np.random.default_rng(0), rcfg, B=B, S=S)
    weights = convert.model_params_from_numpy(pcfg, _np(rstate["params"]))
    new, met = jax.jit(rtl.make_train_step(rcfg, rt))(rstate, batch)
    return dict(weights=weights, batch=_np(batch), metrics=met,
                params=convert.model_params_from_numpy(pcfg, _np(new["params"])),
                m=convert.model_params_from_numpy(pcfg, _np(new["opt"]["m"]),
                                                  dtype=torch.float32))


def _key(arch, tkw):
    return arch, tuple(sorted(tkw.items()))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's steps, then one world of four gloo ranks running
    every case and the checkpoint."""
    refs = {}
    for arch, tkw, *_ in CASES.values():
        if _key(arch, tkw) not in refs:
            refs[_key(arch, tkw)] = _reference(arch, tkw)
    calls = []
    for arch, tkw, mesh, zero in CASES.values():
        ref = refs[_key(arch, tkw)]
        _, pcfg, _, pt = _configs(arch, tkw, zero)
        calls.append((ex.train_rank, (pcfg, pt, mesh, ref["weights"], [ref["batch"]]),
                      {"grad_specs": zero, "device": "cpu"}))
    ckpt_dir = tmp_path_factory.mktemp("tp_ckpt")
    ref = refs[_key("stablelm_3b", {})]
    _, pcfg, _, pt = _configs("stablelm_3b", {}, True)
    calls.append((ex.checkpoint_rank, (pcfg, pt, CKPT_MESH, ref["weights"], ref["batch"],
                                       str(ckpt_dir), CKPT_RESTORE), {"device": "cpu"}))
    world = spawn_world(call_each, WORLD, "gloo", WORLD_TIMEOUT_S, (calls,))
    return dict(refs=refs, cases={name: [w[i] for w in world] for i, name in enumerate(CASES)},
                ckpt=[w[len(CASES)] for w in world])


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
def test_tp_step_matches_reference(ran, name):
    arch, tkw, mesh, zero = CASES[name]
    ref = ran["refs"][_key(arch, tkw)]
    _, pcfg, _, pt = _configs(arch, tkw, zero)
    ranks = ran["cases"][name]
    members = [r for r, out in enumerate(ranks) if out["member"]]
    assert members == list(range(mesh[0] * mesh[1]))
    want = ref["metrics"]
    lr = float(want["lr"])
    # the first moment is (1 - b1) * the clipped gradient: the bound is invariant to the scale
    bound = _param_bound({n: m / (1 - pt.opt.b1) for n, m in ref["m"].items()}, lr)
    for r in members:
        out = ranks[r]
        met = out["metrics"][0]
        for key in ("loss", "ce", "grad_norm"):
            assert _rel(met[key], want[key]) <= 1e-5, (r, key, met[key], float(want[key]))
        assert _rel(met["lr"], lr) <= 1e-6
        assert int(met["ntok"]) == int(want["ntok"])
        assert out["tags"][0]["tp"] > 0
        sh = _held(pcfg, pt, mesh, r)
        for n, w in ref["params"].items():
            held = sh[f"params/{n}"]
            got = out["state"]["params"][n]
            assert got.shape == held.local(w).shape, (r, n)
            gap = (got - held.local(w)).abs()
            assert bool((gap <= held.local(bound[n])).all()), (r, n)
            m_sh = sh[f"opt/m/{n}"]
            m = out["state"]["m"][n]
            assert m.shape == m_sh.local(ref["m"][n]).shape, (r, n)
            scale = max(float(ref["m"][n].abs().max()), 1e-30)
            assert float((m - m_sh.local(ref["m"][n])).abs().max()) / scale <= 1e-4, (r, n)
        assert out["state"]["step"] == 1


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_agree_across_model_ranks(ran, name):
    """A leaf that "model" does not cut has the same gradient on every model
    rank (its moment block, bitwise, on each data row's model ranks) and the
    same parameter on every rank; a model-cut leaf's blocks differ."""
    arch, tkw, mesh, zero = CASES[name]
    _, pcfg, _, pt = _configs(arch, tkw, zero)
    ranks = ran["cases"][name]
    sh = _held(pcfg, pt, mesh, 0)
    n_model = mesh[1]
    replicated = [n for n in ranks[0]["state"]["params"] if not _cut_over_model(sh[f"params/{n}"])]
    cut = [n for n in ranks[0]["state"]["params"] if _cut_over_model(sh[f"params/{n}"])]
    assert replicated and cut
    for row in range(mesh[0]):
        first = ranks[row * n_model]
        for r in range(row * n_model + 1, (row + 1) * n_model):
            for n in replicated:
                if not _cut_over_model(sh[f"opt/m/{n}"]):
                    assert torch.equal(ranks[r]["state"]["m"][n], first["state"]["m"][n]), (r, n)
            assert any(not torch.equal(ranks[r]["state"]["params"][n],
                                       first["state"]["params"][n]) for n in cut)
    for r in range(1, mesh[0] * n_model):
        for n in replicated:
            assert torch.equal(ranks[r]["state"]["params"][n], ranks[0]["state"]["params"][n]), n


def test_state_restores_across_meshes(ran):
    """Saved on (2, 2) (parameters cut over "model", moments over both
    axes), restored onto (4, 1), (1, 4) and no mesh: each rank's blocks
    bitwise those of the global state in the files, whose (2, 2) blocks are
    what the ranks saved."""
    _, pcfg, _, pt = _configs("stablelm_3b", {}, True)
    outs = ran["ckpt"]
    full = outs[0]["restored"][None]["leaves"]
    cut_both = [k for k, s in _held(pcfg, pt, CKPT_MESH, 0).items() if len(s.cuts()) == 2]
    assert cut_both  # some moments are cut over both axes
    for r, out in enumerate(outs):
        assert out["restored"][None]["extra"] == dict(batch_seed=0)
        assert list(out["restored"][None]["leaves"]) == list(full)
        for k, t in out["restored"][None]["leaves"].items():
            assert torch.equal(t, full[k]), (r, k)
        for shape in (CKPT_MESH, *CKPT_RESTORE[:-1]):
            sh = _held(pcfg, pt, shape, r)
            got = out["saved"] if shape == CKPT_MESH else out["restored"][shape]["leaves"]
            assert list(got) == list(full)
            for k, t in full.items():
                want = sh[k].local(t) if k in sh else t
                assert torch.equal(got[k], want), (shape, r, k)


def test_state_shardings_cut_heads_and_keep_whole_kv():
    """On (1, 4): stablelm-3b's q/k/v rows, ``wo``'s and the MLP's inner
    columns, the embedding's and the head's vocabulary rows are cut over
    "model"; qwen2.5-32b's 2 kv heads do not divide by 4, so its
    ``wk``/``wv`` (and their biases) stay whole, their moments cut as the
    reference cuts the flat kv dim; the norms stay whole."""
    mesh = _mesh_of((1, 4), 1)
    tcfg = ptl.TrainConfig()
    sh = ptl.state_shardings(get_config("stablelm_3b").reduced(), mesh, tcfg)["params"]
    model_dim = {n: [d for d, names in s.cuts() if "model" in names] for n, s in sh.items()}
    assert model_dim["embed"] == [0] and model_dim["lm_head.weight"] == [0]
    for leaf, d in (("attn.wq.weight", 0), ("attn.wk.weight", 0), ("attn.wv.weight", 0),
                    ("attn.wo.weight", 1), ("mlp.w_gate.weight", 0), ("mlp.w_up.weight", 0),
                    ("mlp.w_out.weight", 1)):
        assert model_dim[f"blocks.0.{leaf}"] == [d], leaf
    assert model_dim["blocks.0.ln1.weight"] == model_dim["final_norm.weight"] == []
    qcfg = get_config("qwen2_5_32b").reduced()
    held = ptl.state_shardings(qcfg, mesh, tcfg)
    for leaf in ("wk.weight", "wv.weight", "wk.bias", "wv.bias"):
        n = f"blocks.1.attn.{leaf}"
        assert held["params"][n].replicated, n
        assert held["opt"]["m"][n].cuts(), n
    assert not held["params"]["blocks.1.attn.wq.bias"].replicated


def test_whole_kv_heads_are_those_each_rank_reads():
    """Kv heads that do not divide over the ranks: with 4 query heads in 2
    groups over 4 ranks each rank's one query head reads one kv head (a
    slice); with 6 query heads in 3 groups of 2 over 2 ranks each rank's
    three heads read two groups unevenly, so it takes a kv head for each
    query head."""
    from repro_torch.models.common import Attention

    def heads(n_heads, n_kv, m, r):
        cfg = get_config("qwen2_5_32b").reduced().with_(n_heads=n_heads, n_kv_heads=n_kv,
                                                        head_dim=8)
        with torch.device("meta"):
            att = Attention(cfg)
        k = torch.arange(n_kv, dtype=torch.float32).reshape(1, 1, n_kv, 1)
        got, _ = att._kv_heads(k, k, Axis(None, m, r))
        return got.reshape(-1).long().tolist()

    assert [heads(4, 2, 4, r) for r in range(4)] == [[0], [0], [1], [1]]
    assert [heads(6, 3, 2, r) for r in range(2)] == [[0, 0, 1], [1, 2, 2]]
