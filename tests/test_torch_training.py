"""The port's training (``repro_torch.training``) against the reference
(``repro.training``) on the CPU, on the reduced (float32) configs.

* ``lr_at``, ``global_norm``, ``adamw_update`` and ``compress_grads`` on the
  same trees (numpy seed; the reference's (in, out) matrices transposed to
  the port's ``nn.Linear`` layout, its stacked leaves split per layer);
* one ``make_train_step`` of a dense (stablelm-3b), a ``vision_stub``
  (internvl2-1b, patches before the tokens), an encoder (hubert-xlarge), an
  MoE (granite-moe-1b, top-k and the POTUS router) and an SSM (mamba2-1.3b)
  config from the reference's weights and batch: loss and grad norm within
  rel 1e-5, every gradient (mapped through ``convert``) within 1e-4 of its
  leaf's max |g|, the router state equal, and the parameters after the step
  within the bound :func:`_param_bound` derives;
* the same for microbatches 2, z-loss and gradient compression;
* the three remat policies give the loss and gradients of ``"none"``;
* checkpoints round-trip bitwise (bfloat16 leaves through their bits),
  retention, ``AsyncCheckpointer``, and a run preempted and resumed from a
  checkpoint equals an uninterrupted one bitwise, as
  ``tests/test_training_infra.py`` holds the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data.specs import make_batch as ref_make_batch
from repro.training import compression as rcomp
from repro.training import optimizer as ropt
from repro.training import train_loop as rtl
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.specs import as_tensors, make_batch
from repro_torch.training import checkpoint as ck
from repro_torch.training import compression as pcomp
from repro_torch.training import optimizer as popt
from repro_torch.training import train_loop as ptl

B, S = 2, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _worst_leaf_gap(got: dict, want: dict) -> float:
    """max over leaves of max |got - want| / max |want|."""
    assert set(got) == set(want)
    return max(float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30)
               for n in want)


def _param_bound(grad_ref: dict, lr: float, grad_tol: float = 1e-4) -> dict:
    """Per element, how far the parameters after AdamW's first step may
    part. The step moves p by lr * u, u = g/(|g| + eps) + wd * p (the bias
    corrections make m/bc1 = g and v/bc2 = g^2), and the two sides' g part
    by at most delta = grad_tol * max|g| of the leaf (the gradient check).
    Where |g| > 4 delta the sign and size of u agree to 2 delta / (|g| -
    delta) < 1, so |dp| <= lr * 4 delta / |g|; nearer zero the two u may
    take opposite signs, |dp| <= 2 lr. On top, 2e-7 of rounding in a
    parameter of size <= 1 (f32's ulp at 1 is 1.2e-7)."""
    out = {}
    for n, g in grad_ref.items():
        delta = grad_tol * float(g.abs().max())
        out[n] = lr * torch.clamp(4 * delta / g.abs().clamp_min(1e-30), max=2.0) + 2e-7
    return out


def _pair_state(arch, **tkw):
    """(reference cfg, port cfg, reference TrainConfig, port TrainConfig,
    reference state, port state with the reference's weights)."""
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rt = rtl.TrainConfig(opt=ropt.OptConfig(**OPT), **tkw)
    pt = ptl.TrainConfig(opt=popt.OptConfig(**OPT), **tkw)
    rstate = rtl.init_train_state(jax.random.PRNGKey(1), rcfg, rt)
    pstate = ptl.init_train_state(pcfg, pt, torch.Generator().manual_seed(0), "cpu")
    pstate["params"].load_state_dict(convert.model_params_from_numpy(pcfg, _np(rstate["params"])))
    return rcfg, pcfg, rt, pt, rstate, pstate


STEP_CASES = {
    "stablelm_3b": ("stablelm_3b", {}, {}),
    "internvl2_1b": ("internvl2_1b", {}, {}),
    "hubert_xlarge": ("hubert_xlarge", {}, {}),
    "granite_moe_1b": ("granite_moe_1b", {}, {}),
    "granite_moe_1b-potus": ("granite_moe_1b", {"router": "potus"}, {}),
    "mamba2_1_3b": ("mamba2_1_3b", {}, {}),
    "microbatches2": ("stablelm_3b", {}, {"microbatches": 2}),
    "z_loss": ("stablelm_3b", {}, {"z_loss": 1e-3}),
    "grad_compression": ("stablelm_3b", {}, {"grad_compression": True}),
}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def stepped(request):
    """One train step on each side from the same state and batch, and the
    reference's gradients of that batch at the starting weights."""
    arch, cfg_kw, tkw = STEP_CASES[request.param]
    rcfg, pcfg, rt, pt, rstate, pstate = _pair_state(arch, **tkw)
    rcfg, pcfg = rcfg.with_(**cfg_kw), pcfg.with_(**cfg_kw)
    rbatch = ref_make_batch(np.random.default_rng(0), rcfg, B=B, S=S)
    pbatch = make_batch(np.random.default_rng(0), pcfg, B, S, device="cpu")
    if rt.microbatches > 1:  # the reference's microbatch gradients, averaged
        micro = [jax.tree.map(lambda a: a[i::rt.microbatches], rbatch)
                 for i in range(rt.microbatches)]
        rs, gsum = rstate["router_state"], None
        for mb in micro:
            (_, (_, rs_new)), g = jax.value_and_grad(rtl.make_loss_fn(rcfg, rt), has_aux=True)(
                rstate["params"], mb, rs)
            rs = rs_new if rs_new is not None else rs
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        rgrads = jax.tree.map(lambda g: g / rt.microbatches, gsum)
    else:
        (_, _), rgrads = jax.value_and_grad(rtl.make_loss_fn(rcfg, rt), has_aux=True)(
            rstate["params"], rbatch, rstate["router_state"])
    rstep = jax.jit(rtl.make_train_step(rcfg, rt))
    new_r, rmet = rstep(rstate, rbatch)

    model = pstate["params"]
    names = [n for n, _ in model.named_parameters()]
    if pt.microbatches > 1:
        gsum, rs = None, pstate["router_state"]
        for i in range(pt.microbatches):
            mb = {k: a[i::pt.microbatches] for k, a in pbatch.items()}
            loss, (_, rs_new) = ptl.make_loss_fn(pcfg, pt)(model, mb, rs)
            g = torch.autograd.grad(loss, list(model.parameters()))
            rs = rs_new.detach()
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        pgrads = {n: g / pt.microbatches for n, g in zip(names, gsum)}
    else:
        loss, _ = ptl.make_loss_fn(pcfg, pt)(model, pbatch, pstate["router_state"])
        pgrads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    pstate, pmet = ptl.make_train_step(pcfg, pt)(pstate, pbatch)
    return dict(rcfg=rcfg, pcfg=pcfg, rt=rt, pt=pt, rstep=rstep, new_r=new_r, rmet=rmet,
                pstate=pstate, pmet=pmet, pgrads=pgrads,
                rgrads=convert.model_params_from_numpy(pcfg, _np(rgrads), dtype=torch.float32))


def test_train_step_loss_and_grad_norm_match_reference(stepped):
    s = stepped
    assert np.isfinite(float(s["pmet"]["loss"])) and np.isfinite(float(s["pmet"]["grad_norm"]))
    assert _rel(s["pmet"]["loss"], s["rmet"]["loss"]) <= 1e-5
    assert _rel(s["pmet"]["ce"], s["rmet"]["ce"]) <= 1e-5
    assert _rel(s["pmet"]["grad_norm"], s["rmet"]["grad_norm"]) <= 1e-5
    assert _rel(s["pmet"]["lr"], s["rmet"]["lr"]) <= 1e-6
    assert int(s["pmet"]["ntok"]) == int(s["rmet"]["ntok"])
    assert _rel(s["pmet"]["moe_aux"], s["rmet"]["moe_aux"]) <= 1e-5 or float(
        s["rmet"]["moe_aux"]) == float(s["pmet"]["moe_aux"]) == 0.0


def test_train_step_gradients_match_reference(stepped):
    """Each gradient within 1e-4 of its leaf's max |g| (the reference's
    gradients mapped onto the port's names through ``convert``)."""
    assert _worst_leaf_gap(stepped["pgrads"], stepped["rgrads"]) <= 1e-4


def test_train_step_state_after_the_step_matches_reference(stepped):
    s = stepped
    pcfg = s["pcfg"]
    want = convert.model_params_from_numpy(pcfg, _np(s["new_r"]["params"]))
    got = s["pstate"]["params"].state_dict()
    # with compression a gradient may round to the next int8 step on one side only: the
    # gradients fed to AdamW then part by up to one step (max |g| / 127), not 1e-4
    grad_tol = 1e-4 + (1 / 127 if s["pt"].grad_compression else 0.0)
    bound = _param_bound(s["rgrads"], float(s["rmet"]["lr"]), grad_tol)
    for n, w in want.items():
        gap = (got[n] - w).abs()
        assert bool((gap <= bound[n]).all()), (n, float((gap - bound[n]).max()))
    assert int(s["pstate"]["opt"]["step"]) == int(s["new_r"]["opt"]["step"]) == 1
    np.testing.assert_array_equal(s["pstate"]["router_state"].numpy(),
                                  np.asarray(s["new_r"]["router_state"]))
    # the first moments are (1 - b1) * the clipped gradients: within the gradient check's bound
    m_want = convert.model_params_from_numpy(pcfg, _np(s["new_r"]["opt"]["m"]),
                                             dtype=torch.float32)
    assert _worst_leaf_gap(s["pstate"]["opt"]["m"], m_want) <= grad_tol
    if s["pt"].grad_compression:
        err_want = convert.model_params_from_numpy(pcfg, _np(s["new_r"]["err"]),
                                                   dtype=torch.float32)
        # the residual of each row is below one quantisation step of it: compare it to the
        # reference's within one step of the row's scale (max |g| / 127)
        for n, e in err_want.items():
            step = float(s["rgrads"][n].abs().max()) / 127.0
            assert float((s["pstate"]["err"][n] - e).abs().max()) <= step + 1e-7, n


def _mid_run_bound(m2, m3, v3, p, lr, step, opt, grad_tol):
    """Per element, how far the parameters, first and second moments after
    step ``step`` may part when both sides start it from one state (``m2``
    the first moments before it, ``m3``, ``v3`` the reference's after it).

    The reference's clipped gradient is g = (m3 - b1 m2) / (1 - b1); the two
    sides' gradients part by at most delta = grad_tol * max|g| of the leaf
    (the gradient check, plus 1e-5 of the clip scale that the grad-norm
    check leaves). Then m parts by dm = (1 - b1) delta and v by dv =
    (1 - b2)(2 |g| delta + delta^2). The update u = a / (sqrt(c) + eps), a =
    m / bc1, c = v / bc2, is monotone in a and in c, so its gap is at most
    the largest |u(a +- da, c -+ dc) - u| over the four corners, and p's is
    lr times that. On top, rounding: 4 ulp of each leaf's largest moment,
    and 2.5e-7 of max(|p|, 1) (f32's ulp at 1 is 1.2e-7)."""
    b1, b2, eps = opt.b1, opt.b2, opt.eps
    g = (m3 - b1 * m2) / (1 - b1)
    delta = (grad_tol + 1e-5) * g.abs().max()
    dm = (1 - b1) * delta + 4.8e-7 * m3.abs().max()
    dv = (1 - b2) * (2 * g.abs() * delta + delta * delta) + 4.8e-7 * v3.abs().max()
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    a, c, da, dc = m3 / bc1, v3 / bc2, dm / bc1, dv / bc2
    u = a / (torch.sqrt(c) + eps)
    du = torch.zeros_like(u)
    for sa in (-1, 1):
        for sc in (-1, 1):
            corner = (a + sa * da) / (torch.sqrt((c + sc * dc).clamp_min(0.0)) + eps)
            du = torch.maximum(du, (corner - u).abs())
    return lr * du + 2.5e-7 * p.abs().clamp_min(1.0), dm, dv


def test_train_step_from_a_mid_run_state_matches_reference(stepped):
    """Both sides start one step from the reference's state after two steps
    (weights through ``convert.model_params_from_numpy``, AdamW's moments and
    step through ``convert.opt_state_from_numpy``, the router state and the
    compression residuals as they are): loss and grad norm within rel 1e-5,
    and the parameters, first and second moments after it within
    :func:`_mid_run_bound`. Past AdamW's first step the moments carry the
    earlier gradients and the bias corrections are below 1, which the
    one-step test does not reach."""
    s = stepped
    rcfg, pcfg, rt, pt = s["rcfg"], s["pcfg"], s["rt"], s["pt"]
    r1 = s["new_r"]
    r2, _ = s["rstep"](r1, ref_make_batch(np.random.default_rng(1), rcfg, B=B, S=S))
    r3, rmet = s["rstep"](r2, ref_make_batch(np.random.default_rng(2), rcfg, B=B, S=S))
    pstate = ptl.init_train_state(pcfg, pt, torch.Generator().manual_seed(3), "cpu")
    pstate["params"].load_state_dict(convert.model_params_from_numpy(pcfg, _np(r2["params"])))
    pstate["opt"] = convert.opt_state_from_numpy(pcfg, _np(r2["opt"]))
    assert int(pstate["opt"]["step"]) == 2
    pstate["router_state"] = torch.from_numpy(np.array(r2["router_state"]))
    if pt.grad_compression:
        pstate["err"] = convert.model_params_from_numpy(pcfg, _np(r2["err"]), dtype=torch.float32)
    m2 = pstate["opt"]["m"]
    m2 = {n: t.clone() for n, t in m2.items()}
    pstate, pmet = ptl.make_train_step(pcfg, pt)(
        pstate, make_batch(np.random.default_rng(2), pcfg, B, S, device="cpu"))

    assert _rel(pmet["loss"], rmet["loss"]) <= 1e-5
    assert _rel(pmet["grad_norm"], rmet["grad_norm"]) <= 1e-5
    assert int(pstate["opt"]["step"]) == int(r3["opt"]["step"]) == 3
    np.testing.assert_array_equal(pstate["router_state"].numpy(), np.asarray(r3["router_state"]))
    want = convert.model_params_from_numpy(pcfg, _np(r3["params"]))
    want_opt = convert.opt_state_from_numpy(pcfg, _np(r3["opt"]))
    got = pstate["params"].state_dict()
    grad_tol = 1e-4 + (1 / 127 if pt.grad_compression else 0.0)
    for n, w in want.items():
        bound, dm, dv = _mid_run_bound(m2[n], want_opt["m"][n], want_opt["v"][n], w,
                                       float(rmet["lr"]), 3, pt.opt, grad_tol)
        for what, a, b, lim in (("param", got[n], w, bound),
                                ("m", pstate["opt"]["m"][n], want_opt["m"][n], dm),
                                ("v", pstate["opt"]["v"][n], want_opt["v"][n], dv)):
            gap = (a - b).abs()
            assert bool((gap <= lim).all()), (n, what, float((gap - lim).max()))


def test_lr_schedule_matches_reference():
    cfg_r, cfg_p = ropt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100), popt.OptConfig(
        lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(popt.lr_at(cfg_p, torch.tensor(step, dtype=torch.int32)))
        want = float(ropt.lr_at(cfg_r, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * want + 1e-12, step


def _tree_pair(seed):
    """A reference-shaped tree {w (L, in, out) stacked, b (L, n), final (n,)}
    and the same numbers as the port's tree (:func:`_port_view`)."""
    rng = np.random.default_rng(seed)
    ref = {"w": jnp.asarray(rng.standard_normal((2, 6, 5)).astype(np.float32)),
           "b": jnp.asarray(rng.standard_normal((2, 5)).astype(np.float32)),
           "final": jnp.asarray(rng.standard_normal(5).astype(np.float32))}
    return ref, _port_view(ref)


def _port_view(ref):
    """A reference tree of :func:`_tree_pair`'s shape as the port's
    {blocks.i.lin.weight (out, in), blocks.i.lin.bias, final_norm.weight}."""
    r = {k: np.asarray(v) for k, v in ref.items()}
    out = {"final_norm.weight": torch.from_numpy(r["final"].copy())}
    for i in range(2):
        out[f"blocks.{i}.lin.weight"] = torch.from_numpy(r["w"][i].T.copy())
        out[f"blocks.{i}.lin.bias"] = torch.from_numpy(r["b"][i].copy())
    return out


def test_global_norm_matches_reference():
    ref, port = _tree_pair(0)
    assert _rel(popt.global_norm(port), ropt.global_norm(ref)) <= 1e-6


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(steps):
    """``steps`` updates on the same trees: parameters and moments within
    1e-6; the weight decay falls on the stacked leaves (their bias and
    norm-like rows included) and not on the final vector, as in the
    reference."""
    cfg_r = ropt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    cfg_p = popt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    params_r, params_p = _tree_pair(1)
    state_r, state_p = ropt.init_opt_state(params_r, cfg_r), popt.init_opt_state(params_p, cfg_p)
    for k in range(steps):
        grads_r, grads_p = _tree_pair(10 + k)
        params_r, state_r, met_r = ropt.adamw_update(params_r, grads_r, state_r, cfg_r)
        params_p, state_p, met_p = popt.adamw_update(params_p, grads_p, state_p, cfg_p)
        assert _rel(met_p["grad_norm"], met_r["grad_norm"]) <= 1e-6
        assert _rel(met_p["lr"], met_r["lr"]) <= 1e-6
    for got, want in ((params_p, _port_view(params_r)), (state_p["m"], _port_view(state_r["m"])),
                      (state_p["v"], _port_view(state_r["v"]))):
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6)
    assert int(state_p["step"]) == int(state_r["step"]) == steps
    assert popt.decays("blocks.0.lin.bias", params_p["blocks.0.lin.bias"])
    assert not popt.decays("final_norm.weight", params_p["final_norm.weight"])


@pytest.mark.parametrize("steps", [1, 5])
def test_compress_grads_matches_reference(steps):
    """Row-wise int8 with error feedback: the reference's rows (the last
    axis of its (in, out) leaves) are dim 0 of the port's (out, in)
    weights; dequantised gradients and residuals within 1e-6."""
    ref, port = _tree_pair(2)
    err_r, err_p = rcomp.init_error_state(ref), pcomp.init_error_state(port)
    for k in range(steps):
        ref, port = _tree_pair(20 + k)
        deq_r, err_r = rcomp.compress_grads(ref, err_r)
        deq_p, err_p = pcomp.compress_grads(port, err_p)
    for got, want in ((deq_p, _port_view(deq_r)), (err_p, _port_view(err_r))):
        for n in want:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6)


def test_grad_compression_error_feedback():
    """The error is carried, not lost: the mean of the dequantised
    gradients over 20 steps converges to the true gradient (the
    reference's own test, ``tests/test_training_infra.py``)."""
    rng = np.random.default_rng(0)
    g_true = {"lin.weight": torch.from_numpy(
        rng.standard_normal((64, 64)).astype(np.float32) * 0.01)}
    err = pcomp.init_error_state(g_true)
    acc = torch.zeros((64, 64))
    for _ in range(20):
        deq, err = pcomp.compress_grads(g_true, err)
        acc = acc + deq["lin.weight"]
    np.testing.assert_allclose((acc / 20).numpy(), g_true["lin.weight"].numpy(), rtol=0,
                               atol=2e-4)


@pytest.fixture(scope="module")
def dense_setup():
    cfg = get_config("stablelm_3b").reduced()
    tcfg = ptl.TrainConfig(opt=popt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    state = ptl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, tcfg, state


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_1_3b"])
def test_remat_policies_equal_none(remat, arch):
    """Re-running the blocks in the backward pass changes no number: loss
    and every gradient bitwise those of ``remat="none"``."""
    cfg = get_config(arch).reduced()
    state = ptl.init_train_state(cfg, ptl.TrainConfig(), torch.Generator().manual_seed(0), "cpu")
    model = state["params"]
    batch = make_batch(np.random.default_rng(0), cfg, B, S, device="cpu")
    out = {}
    for policy in ("none", remat):
        loss, _ = ptl.make_loss_fn(cfg, ptl.TrainConfig(remat=policy))(model, batch,
                                                                       state["router_state"])
        out[policy] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out["none"][0], out[remat][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out[remat][1]))


def test_unknown_remat_policy_raises(dense_setup):
    cfg, _, state = dense_setup
    batch = make_batch(np.random.default_rng(0), cfg, B, S, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        ptl.make_loss_fn(cfg, ptl.TrainConfig(remat="some"))(state["params"], batch,
                                                             state["router_state"])


def _leaves(state):
    return ck.flatten_state(state)


def test_checkpoint_roundtrip(tmp_path, dense_setup):
    cfg, _, state = dense_setup
    ck.save_checkpoint(tmp_path, 4, state, extra=dict(pipeline=dict(seed=7, step=2)))
    assert ck.latest_step(tmp_path) == 4
    fresh = ptl.init_train_state(cfg, ptl.TrainConfig(), torch.Generator().manual_seed(9), "cpu")
    restored, extra = ck.restore_checkpoint(tmp_path, 4, fresh)
    assert extra["pipeline"]["step"] == 2
    a, b = _leaves(state), _leaves(restored)
    assert list(a) == list(b) and "params/blocks.0.attn.wq.weight" in a and "opt/step" in a
    for key in a:
        assert torch.equal(a[key].detach(), b[key].detach()), key


def test_checkpoint_keeps_bfloat16_bits(tmp_path):
    """numpy has no bfloat16: the leaf is stored as its uint16 bits and
    named bfloat16 in the manifest; it comes back bit for bit."""
    import json

    x = torch.randn(5, 7).to(torch.bfloat16)
    state = {"params": {"w": x}, "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    ck.save_checkpoint(tmp_path, 1, state)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["leaves"]["params/w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_1" / "params__w.npy").dtype == np.uint16
    like = {"params": {"w": torch.zeros(5, 7, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    restored, _ = ck.restore_checkpoint(tmp_path, 1, like)
    assert torch.equal(restored["params"]["w"].view(torch.int16), x.view(torch.int16))
    assert int(restored["opt"]["step"]) == 3


def test_checkpoint_retention(tmp_path):
    for s in (1, 2, 3, 4):
        ck.save_checkpoint(tmp_path, s, {"x": torch.ones(3)}, keep=2)
    assert ck.latest_step(tmp_path) == 4
    assert not (tmp_path / "step_1").exists()
    assert (tmp_path / "step_3").exists()


def test_async_checkpointer(tmp_path):
    w = torch.arange(10.0)
    ckpt = ck.AsyncCheckpointer(tmp_path, keep=2)
    ckpt.save(1, {"w": w})
    w.add_(100.0)  # the snapshot was taken on the caller's thread before this
    ckpt.wait()
    restored, _ = ck.restore_checkpoint(tmp_path, 1, {"w": torch.zeros(10)})
    np.testing.assert_allclose(restored["w"].numpy(), np.arange(10.0))


def test_checkpoint_refuses_a_wrong_shape_or_missing_leaf(tmp_path):
    ck.save_checkpoint(tmp_path, 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(tmp_path, 1, {"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        ck.restore_checkpoint(tmp_path, 1, {"u": torch.zeros(3)})


def test_preemption_resume_bit_exact(tmp_path, dense_setup):
    """Killed at step 5, resumed from the step-3 checkpoint (weights, AdamW's
    moments and step, the pipeline's position): the final state equals an
    uninterrupted run's bitwise."""
    cfg, tcfg, _ = dense_setup
    step = ptl.make_train_step(cfg, tcfg)
    total = 8

    def fresh():
        return ptl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")

    def run(state, start_step, ckpt_every=None, crash_at=None):
        pipe = TokenPipeline(cfg, batch=2, seq=32, seed=11)
        pipe.restore(dict(seed=11, step=start_step))
        for s in range(start_step, total):
            if crash_at is not None and s == crash_at:
                return None, s
            state, _ = step(state, as_tensors(pipe.next_batch(), cfg, "cpu"))
            if ckpt_every and (s + 1) % ckpt_every == 0:
                ck.save_checkpoint(tmp_path, s + 1, state, extra=dict(pipeline=pipe.state()))
        return state, total

    golden, _ = run(fresh(), 0)
    _, crashed_at = run(fresh(), 0, ckpt_every=3, crash_at=5)
    assert crashed_at == 5
    last = ck.latest_step(tmp_path)
    assert last == 3
    restored, extra = ck.restore_checkpoint(tmp_path, last,
                                            ptl.init_train_state(cfg, tcfg,
                                                                 torch.Generator().manual_seed(5),
                                                                 "cpu"))
    resumed, _ = run(restored, extra["pipeline"]["step"])
    a, b = _leaves(golden), _leaves(resumed)
    for key in a:
        assert torch.equal(a[key].detach(), b[key].detach()), key


def test_init_train_state_needs_a_card_unless_cpu_is_asked_for(dense_setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for a machine without one")
    cfg, tcfg, state = dense_setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
    assert all(p.requires_grad for p in state["params"].parameters())
    assert state["opt"]["m"]["embed"].dtype == torch.float32
