"""Tensor-parallel training of the ``vision_stub`` and encoder configs
(``training.train_loop`` under a model mesh with a ``"model"`` axis above 1)
on four gloo ranks on the CPU, against the reference's one-device step
(``repro.training``).

The reference's steps run once in this process (jitted, from the weights of
key 1 on the global batch of seed 0 from ``repro.data.specs.make_batch``,
which draws the patches and the frame embeddings); a ``vision_stub``
batch's labels at the patch positions are set to -1 on both sides, so that
the loss masks them and ``ntok`` counts the token labels alone. One world
of four ranks (``spawn_world`` + ``call_each``: one start-up) runs every
case through ``examples/torch_train_dp.py``'s rank functions:

* one train step of the reduced (float32) internvl2-1b on (1, 2), (1, 4)
  and (2, 2) meshes (4 heads, 2 kv heads, whole on every rank on (1, 4);
  vocabulary 512, cut; the patches join whole after the lookup's sum over
  "model"), and with a vocabulary of 513 on (1, 2) (it does not divide:
  the embedding and the head stay whole and the loss takes whole logits
  under the masked patch labels, as the full config's 151655 does);
* one train step of the reduced hubert-xlarge on (1, 2), (1, 4) and
  (2, 2): bidirectional attention, the gelu MLP's ``w_in``/``w_out`` cut
  over "model", no token embedding (the frame embeddings enter whole), the
  head cut by its vocabulary rows.

Every case has ZeRO-1 moments and ``grad_specs``. Each member rank against
the reference: loss, ce and grad norm within rel 1e-5, ``ntok`` equal; the
parameters, this rank's blocks of them, within ``_param_bound``
(``tests/test_torch_training.py``); leaf by leaf this rank's block of the
first moment within 1e-4 of the reference's moment's scale (a gradient
scaled by the model axis's size would miss by a factor of it); each
replicated leaf's gradient (its moment block) bitwise the same on every
model rank of a data row, and every replicated parameter the same on every
rank. A hubert state saved on (2, 2) is restored onto (1, 4) and no mesh,
bitwise the blocks of the global state the files hold.

In this process: ``state_shardings``' layouts of both families. The configs
that still raise on a ``"model"`` axis are held in
``tests/test_torch_dp_train.py``.
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
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl
from repro_torch.distributed import call_each, spawn_world
from test_torch_tp_train import _cut_over_model, _held, _mesh_of
from test_torch_training import _param_bound, _rel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_train_dp as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

S, B = 32, 8
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
WORLD, WORLD_TIMEOUT_S = 4, 240
# model: (arch, config fields over its reduced config)
MODELS = {"internvl": ("internvl2_1b", {}), "internvl-v513": ("internvl2_1b", {"vocab_size": 513}),
          "hubert": ("hubert_xlarge", {})}
# case: (model, mesh)
CASES = {
    "internvl-1x2": ("internvl", (1, 2)),
    "internvl-1x4-whole-kv": ("internvl", (1, 4)),
    "internvl-2x2": ("internvl", (2, 2)),
    "internvl-1x2-whole-vocab": ("internvl-v513", (1, 2)),
    "hubert-1x2": ("hubert", (1, 2)),
    "hubert-1x4": ("hubert", (1, 4)),
    "hubert-2x2": ("hubert", (2, 2)),
}
CKPT_MODEL, CKPT_MESH, CKPT_RESTORE = "hubert", (2, 2), [(1, 4), None]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(model):
    arch, extra = MODELS[model]
    rcfg = ref_config(arch).reduced().with_(**extra)
    pcfg = get_config(arch).reduced().with_(**extra)
    rt = rtl.TrainConfig(opt=ropt.OptConfig(**OPT))
    pt = ptl.TrainConfig(opt=popt.OptConfig(**OPT, zero_sharding=True))
    return rcfg, pcfg, rt, pt


def _reference(model):
    """The reference's weights (key 1), batch (seed 0, the patch positions'
    labels -1) and one jitted step."""
    rcfg, pcfg, rt, _ = _configs(model)
    rstate = rtl.init_train_state(jax.random.PRNGKey(1), rcfg, rt)
    batch = _np(ref_make_batch(np.random.default_rng(0), rcfg, B=B, S=S))
    if "patches" in batch:
        batch["labels"] = batch["labels"].copy()
        batch["labels"][:, :batch["patches"].shape[1]] = -1
    weights = convert.model_params_from_numpy(pcfg, _np(rstate["params"]))
    new, met = jax.jit(rtl.make_train_step(rcfg, rt))(rstate, batch)
    return dict(weights=weights, batch=batch, metrics=met,
                params=convert.model_params_from_numpy(pcfg, _np(new["params"])),
                m=convert.model_params_from_numpy(pcfg, _np(new["opt"]["m"]),
                                                  dtype=torch.float32))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's steps, then one world of four gloo ranks running
    every case and the checkpoint."""
    refs = {model: _reference(model) for model in dict.fromkeys(m for m, _ in CASES.values())}
    calls = []
    for model, mesh in CASES.values():
        _, pcfg, _, pt = _configs(model)
        calls.append((ex.train_rank, (pcfg, pt, mesh, refs[model]["weights"],
                                      [refs[model]["batch"]]),
                      {"grad_specs": True, "device": "cpu"}))
    ckpt_dir = tmp_path_factory.mktemp("frontend_tp_ckpt")
    _, pcfg, _, pt = _configs(CKPT_MODEL)
    calls.append((ex.checkpoint_rank, (pcfg, pt, CKPT_MESH, refs[CKPT_MODEL]["weights"],
                                       refs[CKPT_MODEL]["batch"], str(ckpt_dir), CKPT_RESTORE),
                  {"device": "cpu"}))
    world = spawn_world(call_each, WORLD, "gloo", WORLD_TIMEOUT_S, (calls,))
    return dict(refs=refs, cases={name: [w[i] for w in world] for i, name in enumerate(CASES)},
                ckpt=[w[len(CASES)] for w in world])


def test_patch_labels_are_masked(ran):
    """The internvl batches carry -1 at the patch positions, so the loss's
    masked branches run: the reference's token count is the token labels'."""
    for model in ("internvl", "internvl-v513"):
        ref = ran["refs"][model]
        n_p = ref["batch"]["patches"].shape[1]
        assert int(ref["metrics"]["ntok"]) == B * (S - n_p)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_reference(ran, name):
    model, mesh = CASES[name]
    ref = ran["refs"][model]
    _, pcfg, _, pt = _configs(model)
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
    model, mesh = CASES[name]
    _, pcfg, _, pt = _configs(model)
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


def test_encoder_state_restores_across_meshes(ran):
    """A hubert state saved on (2, 2) (the gelu MLP and the head cut over
    "model", moments over both axes), restored onto (1, 4) and no mesh:
    each rank's blocks bitwise those of the global state in the files,
    whose (2, 2) blocks are what the ranks saved."""
    _, pcfg, _, pt = _configs(CKPT_MODEL)
    outs = ran["ckpt"]
    full = outs[0]["restored"][None]["leaves"]
    assert not any(k.endswith("/embed") for k in full)
    cut_both = [k for k, s in _held(pcfg, pt, CKPT_MESH, 0).items() if len(s.cuts()) == 2]
    assert "opt/m/blocks.0.mlp.w_in.weight" in cut_both
    for r, out in enumerate(outs):
        assert out["restored"][None]["extra"] == dict(batch_seed=0)
        for k, t in out["restored"][None]["leaves"].items():
            assert torch.equal(t, full[k]), (r, k)
        for shape in (CKPT_MESH, *CKPT_RESTORE[:-1]):
            sh = _held(pcfg, pt, shape, r)
            got = out["saved"] if shape == CKPT_MESH else out["restored"][shape]["leaves"]
            assert list(got) == list(full)
            for k, t in full.items():
                want = sh[k].local(t) if k in sh else t
                assert torch.equal(got[k], want), (shape, r, k)


def test_state_shardings_of_the_encoder_and_vision_stub():
    """On (1, 4): hubert's head is cut by its vocabulary rows (504 / 4 = 126
    a rank at full width), its gelu MLP's ``w_in`` rows and ``w_out``
    columns and its heads over "model", and it has no embedding; the reduced
    internvl2-1b's 2 kv heads stay whole, and at a vocabulary of 513 its
    embedding and head are whole."""
    mesh = _mesh_of((1, 4), 1)
    tcfg = ptl.TrainConfig()

    def model_dims(cfg):
        sh = ptl.state_shardings(cfg, mesh, tcfg)["params"]
        return {n: [d for d, names in s.cuts() if "model" in names] for n, s in sh.items()}, sh

    dims, sh = model_dims(get_config("hubert_xlarge"))
    assert "embed" not in dims and dims["lm_head.weight"] == [0]
    assert tuple(sh["lm_head.weight"].local(torch.empty(504, 1280, device="meta")).shape) == (
        126, 1280)
    for leaf, d in (("attn.wq.weight", 0), ("attn.wk.weight", 0), ("attn.wo.weight", 1),
                    ("mlp.w_in.weight", 0), ("mlp.w_out.weight", 1)):
        assert dims[f"blocks.0.{leaf}"] == [d], leaf
    assert dims["blocks.0.ln1.weight"] == dims["final_norm.weight"] == []
    dims, sh = model_dims(get_config("internvl2_1b").reduced())
    assert dims["embed"] == [0] and dims["lm_head.weight"] == [0]
    for leaf in ("wk.weight", "wv.weight", "wk.bias", "wv.bias"):
        assert sh[f"blocks.0.attn.{leaf}"].replicated, leaf
    assert dims["blocks.0.attn.wq.bias"] == [0]
    dims, sh = model_dims(get_config("internvl2_1b").reduced().with_(vocab_size=513))
    assert sh["embed"].replicated and sh["lm_head.weight"].replicated
