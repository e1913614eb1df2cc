"""The port's mixture-of-experts layer and MoE decoders against the JAX
reference (``repro.models.moe``, the MoE routes of ``repro.models.model_zoo``).

* ``moe_ffn`` on ``granite_moe_1b.reduced()`` and
  ``llama4_maverick_400b.reduced()`` (top-1, a shared expert), at capacity
  factors 4.0 (no drops), 1.0 and 0.5 (drops), N in {1, 4, 37, 64}, with
  ``router="topk"`` and ``"potus"``, with and without a state: the
  selected experts, the keep mask, ``load``, ``router_state`` and
  ``dropped_frac`` exactly; ``y`` and ``aux_loss`` within 1e-5 in float32
  (of max |y| for y); a bfloat16 case within 2e-2 of max |y|; eight steps
  with the state threaded; an all-zero router (every logit equal) selects
  the reference's experts, the lowest indices;
* the POTUS router balances a skewed load better than top-k on the port
  (``tests/test_archs.py::test_potus_router_balances_load``);
* ``forward`` (logits, ``moe_aux_loss``, ``router_state``), ``prefill`` and
  four ``decode_step``s of both reduced MoE decoders with the reference's
  ``use_pallas`` False and True, within 1e-4 (``tests/test_torch_models.py``);
* ``convert`` bit for bit in float32 and bfloat16, the ``sub{j}`` stacks
  included, with an equal parameter count; ``init``'s router and expert
  scales;
* a ``ServingEngine`` on reduced granite with 4 slots and tight capacity
  gives the reference engine's tokens slot by slot;
* ``benchmarks.torch_systems moe_router`` on the CPU gives the derived
  columns of ``benchmarks/systems_bench.py::moe_router_bench`` run on the
  same weights.

The selections of the reference are read from its ``jax.lax.top_k`` call;
its keep mask follows from them by the cumulative count it states
(``src/repro/models/moe.py:89-93``). Everything runs on the CPU; the
card's case is in ``tests/test_torch_kernel_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model_zoo as rz
from repro.models import moe as rm
from repro.models.common import count_params, init_params
from repro.serving import engine as re
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.models import model_zoo as pz
from repro_torch.models import moe as pm
from repro_torch.serving import engine as pe

MOE = ["granite_moe_1b", "llama4_maverick_400b"]
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = {1: (1, 1), 4: (4, 1), 37: (1, 37), 64: (2, 32)}


def _cfgs(name, **kw):
    return (rconfigs.get_config(name).reduced().with_(**kw),
            pconfigs.get_config(name).reduced().with_(**kw))


def _layer(rcfg, pcfg, seed=0, dtype="float32"):
    """One MoE layer's reference parameters and the port's :class:`MoE`
    holding them."""
    params = init_params(jax.random.PRNGKey(seed), rm.moe_template(rcfg), jnp.dtype(dtype))
    moe = pm.MoE(pcfg, dtype=pz.DTYPES[dtype])
    moe.load_state_dict(convert.moe_params_from_numpy(jax.tree.map(np.asarray, params),
                                                      dtype=pz.DTYPES[dtype]))
    return params, moe.requires_grad_(False)


def _ref_moe(monkeypatch, params, x, cfg, rs):
    """The reference's ``moe_ffn`` on numpy ``x``, and the (N, k) experts its
    ``jax.lax.top_k`` chose."""
    chosen = []
    top_k = jax.lax.top_k

    def spy(operand, k):
        out = top_k(operand, k)
        chosen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    y, aux = rm.moe_ffn(params, jnp.asarray(x), cfg, None if rs is None else jnp.asarray(rs))
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(chosen) == 1
    return y, aux, chosen[0]


def _keep(top_i, n_experts, cap):
    """The reference's keep mask from its selections: each entry's position
    among the entries of its expert in token-major order, below ``cap``."""
    flat = top_i.reshape(-1)
    pos = np.zeros(flat.shape, np.int64)
    seen = np.zeros(n_experts, np.int64)
    for j, e in enumerate(flat):
        pos[j] = seen[e]
        seen[e] += 1
    return pos < cap


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _check_layer(monkeypatch, params, moe, rcfg, pcfg, x, rs, dtype="float32"):
    """One call of both sides; the exact and the toleranced checks. Returns
    the port's new router state (numpy) or None."""
    B, S, _ = x.shape
    want_y, want, ref_top_i = _ref_moe(monkeypatch, params, x, rcfg, rs)
    tx = torch.as_tensor(np.asarray(jnp.asarray(x)).astype(np.float32)).to(pz.DTYPES[dtype])
    got_y, got = pm.moe_ffn(moe, tx, pcfg, None if rs is None else torch.as_tensor(rs))
    top_i = got["top_i"].numpy()
    flips = np.argwhere(top_i != ref_top_i)
    assert flips.size == 0, f"selections differ at (token, choice) {flips[:4].tolist()}"
    cap = pm.moe_capacity(pcfg, B * S)
    assert cap == rm.moe_capacity(rcfg, B * S)
    np.testing.assert_array_equal(got["keep"].numpy(), _keep(ref_top_i, rcfg.n_experts, cap))
    np.testing.assert_array_equal(got["load"].numpy(), np.asarray(want["load"]))
    assert float(got["dropped_frac"]) == float(want["dropped_frac"])
    if rs is None:
        assert got["router_state"] is None and want["router_state"] is None
    else:
        np.testing.assert_array_equal(got["router_state"].numpy(),
                                      np.asarray(want["router_state"]))
    want_y = np.asarray(want_y, np.float32)
    scale = np.abs(want_y).max()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got_y.shape == want_y.shape and got_y.dtype == pz.DTYPES[dtype]
    assert np.abs(_as_np(got_y) - want_y).max() <= tol * scale
    np.testing.assert_allclose(float(got["aux_loss"]), float(want["aux_loss"]), rtol=1e-5,
                               atol=1e-5)
    return None if rs is None else got["router_state"].numpy()


def _tokens(rng, N, D):
    B, S = SHAPES[N]
    return rng.standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("router,with_state", [("topk", False), ("topk", True),
                                               ("potus", False), ("potus", True)])
@pytest.mark.parametrize("N", sorted(SHAPES))
@pytest.mark.parametrize("capacity_factor", [4.0, 1.0, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_reference(monkeypatch, name, capacity_factor, N, router, with_state):
    rcfg, pcfg = _cfgs(name, capacity_factor=capacity_factor, router=router)
    params, moe = _layer(rcfg, pcfg)
    rng = np.random.default_rng(N)
    x = _tokens(rng, N, rcfg.d_model)
    rs = (rng.integers(0, 6, rcfg.n_experts).astype(np.float32) if with_state else None)
    _check_layer(monkeypatch, params, moe, rcfg, pcfg, x, rs)


@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
@pytest.mark.parametrize("name", MOE)
def test_potus_state_threaded_over_eight_steps(monkeypatch, name, capacity_factor):
    """Skewed tokens, the state fed back each step: every step's selections,
    loads and state equal the reference's."""
    rcfg, pcfg = _cfgs(name, capacity_factor=capacity_factor, router="potus")
    params, moe = _layer(rcfg, pcfg, seed=1)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((1, 1, rcfg.d_model)).astype(np.float32)
    x = np.concatenate([np.repeat(base, 24, axis=1)
                        + 0.05 * rng.standard_normal((1, 24, rcfg.d_model)),
                        rng.standard_normal((1, 8, rcfg.d_model))], axis=1).astype(np.float32)
    rs = np.zeros(rcfg.n_experts, np.float32)
    states = []
    for _ in range(8):
        rs = _check_layer(monkeypatch, params, moe, rcfg, pcfg, x, rs)
        states.append(rs)
    assert np.abs(np.array(states)).sum() > 0  # the queues moved


@pytest.mark.parametrize("router", ["topk", "potus"])
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_bfloat16(monkeypatch, name, router):
    rcfg, pcfg = _cfgs(name, capacity_factor=1.0, router=router, param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    params, moe = _layer(rcfg, pcfg, dtype="bfloat16")
    rng = np.random.default_rng(5)
    x = np.asarray(jnp.asarray(_tokens(rng, 37, rcfg.d_model), jnp.bfloat16))
    rs = rng.integers(0, 6, rcfg.n_experts).astype(np.float32)
    _check_layer(monkeypatch, params, moe, rcfg, pcfg, x, rs, dtype="bfloat16")


@pytest.mark.parametrize("router", ["topk", "potus"])
@pytest.mark.parametrize("name", MOE)
def test_ties_select_the_lowest_index(monkeypatch, name, router):
    """An all-zero router makes every logit equal: both sides select experts
    0..k-1 for every token (``jax.lax.top_k``'s order on ties)."""
    rcfg, pcfg = _cfgs(name, capacity_factor=1.0, router=router)
    params, moe = _layer(rcfg, pcfg)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    moe.router.zero_()
    x = _tokens(np.random.default_rng(7), 37, rcfg.d_model)
    # a zero state, so the prices stay tied under potus too
    _check_layer(monkeypatch, params, moe, rcfg, pcfg, x, np.zeros(rcfg.n_experts, np.float32))
    _, aux = pm.moe_ffn(moe, torch.as_tensor(x), pcfg)
    assert (aux["top_i"] == torch.arange(pcfg.top_k)).all()


def test_potus_router_balances_load():
    """The port's counterpart of ``tests/test_archs.py::test_potus_router_balances_load``:
    on a skewed input, the virtual-queue router's load imbalance is below
    plain top-k's."""
    rcfg, pcfg = _cfgs("granite_moe_1b", n_experts=8, top_k=2)
    _, moe = _layer(rcfg, pcfg)
    rng = np.random.default_rng(0)
    x_base = rng.standard_normal((1, 1, pcfg.d_model)).astype(np.float32)
    x = torch.as_tensor(np.concatenate(
        [np.repeat(x_base, 64, axis=1),
         rng.standard_normal((1, 64, pcfg.d_model)).astype(np.float32) * 0.1], axis=1))

    def run(router, steps=8):
        c = pcfg.with_(router=router)
        rs = pm.init_router_state(c)
        maxloads = []
        for _ in range(steps):
            _, aux = pm.moe_ffn(moe, x, c, rs)
            if router == "potus":
                rs = aux["router_state"]
            load = aux["load"].numpy()
            maxloads.append(load.max() / max(load.mean(), 1))
        return np.mean(maxloads[2:])

    imb_topk, imb_potus = run("topk"), run("potus")
    assert imb_potus < imb_topk, (imb_potus, imb_topk)


def _pair(name, **kw):
    rcfg, pcfg = _cfgs(name, **kw)
    params = rz.init(jax.random.PRNGKey(0), rcfg)
    model = pz.init(pcfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(convert.model_params_from_numpy(pcfg, jax.tree.map(np.asarray, params)))
    return rcfg, pcfg, params, model


def _tok(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_model_matches_reference(name, use_pallas):
    """POTUS routing at capacity factor 1.0 (drops), so the router state
    threaded through the layers sets the selections; ``forward`` also with
    top-k routing and from a given state. The reference's entry points run
    under ``jax.jit`` (the config static), compiled once per test."""
    rcfg, pcfg, params, model = _pair(name, use_pallas=use_pallas, router="potus",
                                      capacity_factor=1.0)
    r_forward = jax.jit(rz.forward, static_argnums=1)
    r_prefill = jax.jit(rz.prefill, static_argnums=(1, 3))
    r_decode = jax.jit(rz.decode_step, static_argnums=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (2, 16)).astype(np.int32)
    rs0 = np.arange(rcfg.n_experts, dtype=np.float32)
    for router, rs in (("potus", None), ("potus", rs0), ("topk", None)):
        rc, pc = rcfg.with_(router=router), pcfg.with_(router=router)
        want, waux = r_forward(params, rc, {"tokens": jnp.asarray(toks)},
                               None if rs is None else jnp.asarray(rs))
        got, aux = pz.forward(model, pc, {"tokens": _tok(toks)},
                              None if rs is None else torch.as_tensor(rs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux["moe_aux_loss"]), float(waux["moe_aux_loss"]),
                                   **TOL)
        assert float(aux["moe_aux_loss"]) > 0
        np.testing.assert_array_equal(aux["router_state"].numpy(),
                                      np.asarray(waux["router_state"]))

    max_len = 32
    want, rcache = r_prefill(params, rcfg, {"tokens": jnp.asarray(toks)}, max_len)
    got, pcache = pz.prefill(model, pcfg, {"tokens": _tok(toks)}, max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    shape, _ = pz.cache_spec(pcfg, 2, max_len)["k"]
    assert tuple(pcache["k"].shape) == shape == tuple(rcache["k"].shape)

    pos = np.array([16, 16], np.int32)
    for _ in range(4):
        tok = rng.integers(0, rcfg.vocab_size, (2, 1)).astype(np.int32)
        want, rcache = r_decode(params, rcfg, jnp.asarray(tok), jnp.asarray(pos), rcache)
        got, pcache = pz.decode_step(model, pcfg, _tok(tok), torch.from_numpy(pos), pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(rcache[key]), **TOL)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _port_bits(t):
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_weights_survive_conversion(name, dtype):
    """Router and experts as they are, the shared expert transposed, unit u's
    ``sub{j}`` at layer ``u * moe_interleave + j``, bit for bit."""
    rcfg, pcfg, params, model = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    sd = model.state_dict()
    flat = jax.tree.map(np.asarray, params)
    per = rcfg.moe_interleave
    for i in range(rcfg.n_layers):
        u, j = divmod(i, per)
        stack = flat["blocks"][f"sub{j}"] if per > 1 else flat["blocks"]
        assert np.array_equal(_port_bits(sd[f"blocks.{i}.attn.wq.weight"]),
                              _bits(stack["attn"]["wq"][u]).T)
        assert np.array_equal(_port_bits(sd[f"blocks.{i}.ln2.weight"]), _bits(stack["ln2"][u]))
        assert pz.is_moe_layer(pcfg, i) == ("moe" in stack)
        if "moe" not in stack:
            assert np.array_equal(_port_bits(sd[f"blocks.{i}.mlp.w_out.weight"]),
                                  _bits(stack["mlp"]["w_out"][u]).T)
            continue
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            assert np.array_equal(_port_bits(sd[f"blocks.{i}.moe.{leaf}"]),
                                  _bits(stack["moe"][leaf][u]))
        for leaf, w in stack["moe"].get("shared", {}).items():
            assert np.array_equal(_port_bits(sd[f"blocks.{i}.moe.shared.{leaf}.weight"]),
                                  _bits(w[u]).T)
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_ref
    assert all(t.dtype == pz.DTYPES[dtype] for t in sd.values())


def test_init_draws_the_reference_scales():
    """``Leaf.materialize``: the router N(0, 1) * 0.02 (its ``scale``), the
    expert tensors 1/sqrt(shape[-2]) (w_gate and w_up 1/sqrt(D), w_down
    1/sqrt(F)), the shared expert's matrices 1/sqrt(fan_in)."""
    cfg = pconfigs.get_config("llama4_maverick_400b").reduced()
    m = pz.init(cfg, torch.Generator().manual_seed(2), "cpu")
    dense, moe = m.blocks[0], m.blocks[1]
    assert dense.moe is None and moe.mlp is None
    assert abs(float(moe.moe.router.std()) - 0.02) < 0.002
    for w in (moe.moe.w_gate, moe.moe.w_up):
        assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(moe.moe.w_down.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert abs(float(moe.moe.shared.w_gate.weight.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(float(moe.moe.shared.w_out.weight.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    rcfg = rconfigs.get_config("llama4_maverick_400b").reduced()
    assert sum(p.numel() for p in m.parameters()) == count_params(rz.template(rcfg))


@pytest.mark.parametrize("router", ["topk", "potus"])
def test_engine_matches_reference_with_tight_capacity(router):
    """4 slots share each expert's capacity in a decode round (cap =
    ceil(4 * 2 / 4 * 0.5) = 1 here), so the other slots' tokens change
    which entries drop: the port's engine gives the reference's tokens slot
    by slot all the same."""
    rcfg, pcfg, params, model = _pair("granite_moe_1b", capacity_factor=0.5, router=router)
    kw = dict(max_batch=4, max_len=48)
    ref_eng, port_eng = re.ServingEngine(rcfg, params, **kw), pe.ServingEngine(pcfg, model, **kw)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, rcfg.vocab_size, int(rng.integers(4, 12)))
        ref_eng.submit(re.Request(rid, prompt, max_new=5))
        port_eng.submit(pe.Request(rid, prompt, max_new=5))
    for t in range(12):
        a, b = ref_eng.step(), port_eng.step()
        assert b == a, f"slot {t}"
        assert port_eng.backlog_tokens == ref_eng.backlog_tokens
    assert port_eng.tokens_served == ref_eng.tokens_served == 30
    assert port_eng.decode_rounds > 0


def test_moe_router_bench_matches_reference(monkeypatch):
    """``benchmarks.torch_systems``'s ``moe_router`` rows on the CPU carry
    the derived columns that ``systems_bench.moe_router_bench`` computes
    from the same weights (its ``init_params`` handed the port's)."""
    from benchmarks import systems_bench
    from benchmarks import torch_systems as ts
    from repro.models import common as rcommon

    cfg, moe, x = ts.moe_router_inputs("cpu")
    leaves = {k: jnp.asarray(v.numpy()) for k, v in moe.state_dict().items()}
    monkeypatch.setattr(rcommon, "init_params", lambda key, tmpl, dtype: dict(leaves))
    want = systems_bench.moe_router_bench()
    got = ts.moe_router_rows("cpu", inputs=(cfg, moe, x))
    assert [r.name for r in got] == [r.name for r in want] == ["moe_router/topk",
                                                               "moe_router/potus"]
    assert [r.derived for r in got] == [r.derived for r in want]
    assert ts.BENCH_ROWS[-1]["engine"] == "torch-moe"
