"""Data-parallel training across ranks (``training.train_loop`` under a
model mesh, ``distributed.sharding``, the elastic checkpoint and
``distributed.pipeline``) on four gloo ranks on the CPU, against the
reference's one-device step (``repro.training``) and the port's one-rank
step.

One world of four ranks (``spawn_world`` + ``call_each``: one start-up)
runs every case through ``examples/torch_train_dp.py``'s rank functions:

* one train step of the reduced (float32) stablelm-3b (dense),
  internvl2-1b (``vision_stub``) and hubert-xlarge (encoder) from the
  reference's weights on its global batch of 8 (6 for the batch that does
  not split over 4), on a 4x1 mesh, and on a 2x1 mesh with two ranks off
  it; ZeRO-1 on and off, ``grad_specs`` on and off, microbatches 2, z-loss,
  gradient compression. Each against the reference's jitted one-device
  step: loss, ce and grad norm within rel 1e-5, ``ntok`` equal, the
  parameters within ``_param_bound`` (``tests/test_torch_training.py``),
  every rank's moment blocks within the gradient check's bound of the
  reference's moments' blocks; each against the port's one-rank step the
  same way; every rank's parameters the same bitwise; the ranks off the
  mesh keep their state and get the mesh's metrics;
* a ZeRO-1 state saved on four ranks (``save_checkpoint`` and an
  ``AsyncCheckpointer``), restored onto a 2x1 mesh and onto one rank:
  bitwise the global state, and the files byte for byte those of a
  one-rank checkpoint of it;
* ``pipeline_apply`` on four ranks with the shapes of
  ``tests/test_pipeline.py`` (4 stages, 6 microbatches of 2, D 16) against
  the sequential application in JAX, within 1e-5.

In this process: a 1x1 mesh (ZeRO-1, ``grad_specs``) is the meshless step
bitwise; a ``"model"`` axis of more than one rank raises
``NotImplementedError`` naming module item 5b for the configs that
tensor-parallel training does not cover (encoder, ``vision_stub``, SSM,
hybrid; MoE training on ``(n, 1)`` meshes: ``tests/test_torch_moe_train.py``;
a dense decoder's tensor-parallel step: ``tests/test_torch_tp_train.py``;
an MoE decoder's: ``tests/test_torch_moe_tp_train.py``), and ``ValueError``
for a dense config whose heads do not divide over it.
"""
import filecmp
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.specs import make_batch as ref_make_batch
from repro.training import optimizer as ropt
from repro.training import train_loop as rtl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import Axis, call_each, set_mesh, spawn_world
from repro_torch.distributed import sharding as psh
from repro_torch.launch.mesh import ModelMesh, make_host_mesh
from repro_torch.models import model_zoo as pz
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl
from test_torch_training import _param_bound, _rel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import torch_train_dp as ex  # noqa: E402  (the spawned ranks import it by this name)

torch.set_num_threads(1)

S = 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
WORLD, WORLD_TIMEOUT_S = 4, 240
# case: (arch, TrainConfig fields, global batch, mesh, zero_sharding, grad_specs)
CASES = {
    "stablelm-4x1-zero-specs": ("stablelm_3b", {}, 8, (4, 1), True, True),
    "stablelm-4x1-zero": ("stablelm_3b", {}, 8, (4, 1), True, False),
    "stablelm-4x1-specs": ("stablelm_3b", {}, 8, (4, 1), False, True),
    "stablelm-4x1-replicated": ("stablelm_3b", {}, 8, (4, 1), False, False),
    "stablelm-2x1-two-off": ("stablelm_3b", {}, 8, (2, 1), True, True),
    "stablelm-microbatches2": ("stablelm_3b", {"microbatches": 2}, 8, (4, 1), True, True),
    "stablelm-z_loss": ("stablelm_3b", {"z_loss": 1e-3}, 8, (4, 1), True, True),
    "stablelm-compression": ("stablelm_3b", {"grad_compression": True}, 8, (4, 1), True, True),
    "stablelm-compression-no-specs": ("stablelm_3b", {"grad_compression": True}, 8, (4, 1),
                                      True, False),
    "stablelm-B6-unsplit": ("stablelm_3b", {}, 6, (4, 1), True, True),
    "internvl2-4x1": ("internvl2_1b", {}, 8, (4, 1), True, True),
    "hubert-4x1": ("hubert_xlarge", {}, 8, (4, 1), True, True),
}
PIPE = dict(n_stages=4, n_micro=6, mb=2, D=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, tkw, zero):
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rt = rtl.TrainConfig(opt=ropt.OptConfig(**OPT), **tkw)
    pt = ptl.TrainConfig(opt=popt.OptConfig(**OPT, zero_sharding=zero), **tkw)
    return rcfg, pcfg, rt, pt


def _reference(arch, tkw, B):
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


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    n, D = PIPE["n_stages"], PIPE["D"]
    params = {"w": rng.standard_normal((n, D, D)).astype(np.float32) * 0.3,
              "b": rng.standard_normal((n, D)).astype(np.float32) * 0.1}
    x = rng.standard_normal((PIPE["n_micro"], PIPE["mb"], D)).astype(np.float32)
    return params, x


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference's steps, then one world of four gloo ranks running
    every case, the checkpoint and the pipeline."""
    refs = {}
    for arch, tkw, B, *_ in CASES.values():
        key = (arch, tuple(sorted(tkw.items())), B)
        if key not in refs:
            refs[key] = _reference(arch, tkw, B)
    calls = []
    for arch, tkw, B, mesh, zero, specs in CASES.values():
        ref = refs[(arch, tuple(sorted(tkw.items())), B)]
        _, pcfg, _, pt = _configs(arch, tkw, zero)
        calls.append((ex.train_rank, (pcfg, pt, mesh, ref["weights"], [ref["batch"]]),
                      {"grad_specs": specs, "device": "cpu"}))
    ckpt_dir = tmp_path_factory.mktemp("dp_ckpt")
    ref = refs[("stablelm_3b", (), 8)]
    _, pcfg, _, pt = _configs("stablelm_3b", {}, True)
    calls.append((ex.checkpoint_rank, (pcfg, pt, (4, 1), ref["weights"], ref["batch"],
                                       str(ckpt_dir), [(2, 1), None]), {"device": "cpu"}))
    params, x = _pipeline_inputs()
    calls.append((ex.pipeline_rank, ({k: torch.from_numpy(v) for k, v in params.items()},
                                     torch.from_numpy(x), PIPE["n_stages"]), {"device": "cpu"}))
    world = spawn_world(call_each, WORLD, "gloo", WORLD_TIMEOUT_S, (calls,))
    n = len(CASES)
    return dict(refs=refs, cases={name: [w[i] for w in world] for i, name in enumerate(CASES)},
                ckpt=[w[n] for w in world], ckpt_dir=ckpt_dir, pipe=[w[n + 1] for w in world])


def _one_rank(arch, tkw, zero, ref):
    """The port's one-rank step from the same weights and batch."""
    _, pcfg, _, pt = _configs(arch, tkw, zero)
    return ex.train_rank(pcfg, pt, None, ref["weights"], [ref["batch"]], device="cpu")


def _moment_blocks(pcfg, pt, mesh_shape, rank, full: dict) -> dict:
    """``full`` (a tree of the parameters' shape) cut to rank ``rank``'s
    blocks of the moments' layout on a ``mesh_shape`` mesh."""
    n_data, n_model = mesh_shape
    mesh = ModelMesh((("data", Axis(None, n_data, rank // n_model)),
                      ("model", Axis(None, n_model, rank % n_model))))
    sh = psh.train_state_shardings(pcfg, mesh, pt)["opt"]["m"]
    return {n: sh[n].local(t) for n, t in full.items()}


def _check_step(got, want_met, want_params, want_m, pcfg, pt, mesh_shape, rank):
    """One member rank's step against a reference (the reference's or the
    port's one-rank step): metrics, parameters, moment blocks."""
    met = got["metrics"][0]
    for key in ("loss", "ce", "grad_norm"):
        assert _rel(met[key], want_met[key]) <= 1e-5, (key, met[key], float(want_met[key]))
    assert _rel(met["lr"], want_met["lr"]) <= 1e-6
    assert int(met["ntok"]) == int(want_met["ntok"])
    grad_tol = 1e-4 + (1 / 127 if pt.grad_compression else 0.0)
    # the first moment is (1 - b1) * the clipped gradient: the bound is invariant to the scale
    bound = _param_bound({n: m / (1 - pt.opt.b1) for n, m in want_m.items()},
                         float(want_met["lr"]), grad_tol)
    for n, w in want_params.items():
        gap = (got["state"]["params"][n] - w).abs()
        assert bool((gap <= bound[n]).all()), (n, float((gap - bound[n]).max()))
    blocks = _moment_blocks(pcfg, pt, mesh_shape, rank, want_m)
    for n, w in blocks.items():
        m = got["state"]["m"][n]
        assert m.shape == w.shape, n
        scale = max(float(want_m[n].abs().max()), 1e-30)
        assert float((m - w).abs().max()) / scale <= grad_tol, n
    assert got["state"]["step"] == 1


def _case(ran, name):
    arch, tkw, B, mesh, zero, specs = CASES[name]
    ref = ran["refs"][(arch, tuple(sorted(tkw.items())), B)]
    _, pcfg, _, pt = _configs(arch, tkw, zero)
    return ref, pcfg, pt, mesh, ran["cases"][name]


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_reference(ran, name):
    ref, pcfg, pt, mesh, ranks = _case(ran, name)
    members = [r for r, out in enumerate(ranks) if out["member"]]
    assert len(members) == mesh[0] * mesh[1]
    for r in members:
        _check_step(ranks[r], ref["metrics"], ref["params"], ref["m"], pcfg, pt, mesh, r)
        assert ranks[r]["elements"][0] > 0  # the "dp" payload
        for n, p in ranks[r]["state"]["params"].items():  # every rank holds the same weights
            assert torch.equal(p, ranks[members[0]]["state"]["params"][n]), (r, n)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_one_rank_port(ran, name):
    ref, pcfg, pt, mesh, ranks = _case(ran, name)
    arch, tkw, _, _, zero, _ = CASES[name]
    one = _one_rank(arch, tkw, zero, ref)
    for r, out in enumerate(ranks):
        if out["member"]:
            _check_step(out, one["metrics"][0], one["state"]["params"], one["state"]["m"],
                        pcfg, pt, mesh, r)


def test_ranks_off_the_mesh_keep_their_state(ran):
    """On a 2x1 mesh in a world of four, ranks 2 and 3 take no part: their
    state is the starting one, their metrics the mesh's."""
    ref, *_, ranks = _case(ran, "stablelm-2x1-two-off")
    assert [out["member"] for out in ranks] == [True, True, False, False]
    for out in ranks[2:]:
        assert out["metrics"] == ranks[0]["metrics"]
        assert out["state"]["step"] == 0
        for n, w in ref["weights"].items():
            assert torch.equal(out["state"]["params"][n], w), n
        assert all(not bool(m.any()) for m in out["state"]["m"].values())


def _global(pcfg, pt, saved_by_rank):
    """The global state from the four ranks' blocks of a 4x1 ZeRO-1 state."""
    mesh = ModelMesh((("data", Axis(None, 4, 0)), ("model", Axis(None, 1, 0))))
    sh = ck.flatten_state(psh.train_state_shardings(pcfg, mesh, pt))
    out = {}
    for key, leaf in saved_by_rank[0].items():
        cuts = sh[key].cuts() if key in sh else []
        if not cuts:
            out[key] = leaf
            continue
        (d, _), = cuts
        out[key] = torch.cat([s[key] for s in saved_by_rank], dim=d)
    return out


def test_zero_state_restores_across_meshes(ran, tmp_path):
    """Saved on four ranks, restored onto a 2x1 mesh (ranks 2, 3 off it:
    the whole state) and onto one rank: bitwise the global state's blocks;
    the checkpoint's files are those of a one-rank checkpoint of it."""
    _, pcfg, _, pt = _configs("stablelm_3b", {}, True)
    outs = ran["ckpt"]
    full = _global(pcfg, pt, [o["saved"] for o in outs])
    assert any(full[k].shape != outs[0]["saved"][k].shape for k in full)  # ZeRO cut something
    for r, out in enumerate(outs):
        one = out["restored"][None]
        assert one["extra"] == dict(batch_seed=0)
        assert list(one["leaves"]) == list(full)
        for k, t in full.items():
            assert torch.equal(one["leaves"][k], t), (r, k)
        two = out["restored"][(2, 1)]["leaves"]
        mesh = ModelMesh((("data", Axis(None, 2, r)), ("model", Axis(None, 1, 0)))) if r < 2 \
            else ModelMesh()
        sh = ck.flatten_state(psh.train_state_shardings(pcfg, mesh, pt))
        for k, t in full.items():
            want = sh[k].local(t) if k in sh else t
            assert torch.equal(two[k], want), (r, k)
    # the files (saved, and through an AsyncCheckpointer): byte for byte a one-rank
    # checkpoint of the global state
    ck.save_checkpoint(tmp_path, 1, full, extra=dict(batch_seed=0))
    b = tmp_path / "step_1"
    names = sorted(p.name for p in b.iterdir())
    for a in (Path(ran["ckpt_dir"]) / "step_1", Path(f"{ran['ckpt_dir']}-async") / "step_1"):
        assert sorted(p.name for p in a.iterdir()) == names
        assert all(filecmp.cmp(a / n, b / n, shallow=False) for n in names), a


def test_pipeline_apply_matches_sequential(ran):
    params, x = _pipeline_inputs()
    ref = jnp.asarray(x)
    for s in range(PIPE["n_stages"]):
        w, b = jnp.asarray(params["w"][s]), jnp.asarray(params["b"][s])
        ref = jax.vmap(lambda h: jnp.tanh(h @ w + b))(ref)
    ref = np.asarray(ref)
    for out in ran["pipe"]:
        assert float(np.abs(out["out"].numpy() - ref).max()) < 1e-5
        assert out["elements"] > 0
        assert torch.equal(out["out"], ran["pipe"][0]["out"])


@pytest.mark.parametrize("tkw", [{}, {"microbatches": 2, "z_loss": 1e-3},
                                 {"grad_compression": True}])
def test_one_by_one_mesh_is_the_meshless_step_bitwise(tkw):
    cfg = get_config("stablelm_3b").reduced()
    tcfg = ptl.TrainConfig(opt=popt.OptConfig(**OPT), **tkw)
    batch = {k: torch.as_tensor(v) for k, v in
             ref_make_batch(np.random.default_rng(0), ref_config("stablelm_3b").reduced(),
                            B=4, S=S).items()}
    batch = {k: v.long() if not v.is_floating_point() else v for k, v in batch.items()}

    def run(mesh):
        set_mesh(mesh)
        try:
            state = ptl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
            specs = None
            if mesh is not None:
                ptl.shard_train_state(state, psh.train_state_shardings(cfg, mesh, tcfg))
                specs = psh.specs_for_template(pz.template(cfg), psh.zero_rules(mesh), mesh)
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


def test_tensor_parallel_and_moe_across_ranks_raise():
    """A ``"model"`` axis of more than one rank raises naming module item
    5b for an SSM and a hybrid config (the dense and MoE decoders', the
    ``vision_stub`` configs' and the encoders' tensor-parallel training
    ``tests/test_torch_tp_train.py``, ``tests/test_torch_moe_tp_train.py``
    and ``tests/test_torch_frontend_tp_train.py`` hold), as does a
    ``"pod"`` axis; a config whose heads do not divide over the axis (a
    dense one, the full internvl2-1b's 14 over 4) raises ``ValueError``
    when the step is built."""
    mesh = ModelMesh((("data", Axis(None, 2, 0)), ("model", Axis(None, 2, 0))))
    for cfg in (get_config("mamba2_1_3b").reduced(), get_config("zamba2_1_2b").reduced()):
        set_mesh(mesh)
        try:
            with pytest.raises(NotImplementedError, match="module item 5b"):
                ptl.make_train_step(cfg, ptl.TrainConfig())
        finally:
            set_mesh(None)
    pod = ModelMesh((("pod", Axis(None, 2, 0)), ("data", Axis()), ("model", Axis())))
    set_mesh(pod)
    try:
        with pytest.raises(NotImplementedError, match="module item 5b"):
            ptl.make_train_step(get_config("stablelm_3b").reduced(), ptl.TrainConfig())
    finally:
        set_mesh(None)
    set_mesh(ModelMesh((("data", Axis()), ("model", Axis(None, 4, 1)))))
    try:
        with pytest.raises(ValueError, match="6 heads do not divide over the 4 ranks"):
            ptl.make_train_step(get_config("stablelm_3b").reduced().with_(n_heads=6,
                                                                          n_kv_heads=6),
                                ptl.TrainConfig())
        with pytest.raises(ValueError, match="14 heads do not divide over the 4 ranks"):
            ptl.make_train_step(get_config("internvl2_1b"), ptl.TrainConfig())
    finally:
        set_mesh(None)
