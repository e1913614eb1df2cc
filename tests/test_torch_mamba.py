"""The port's SSM and hybrid models against the JAX reference, on the CPU.

* the reference's Mamba2 and shared-attention weights survive
  ``convert.model_params_from_numpy`` bit for bit, and the cache layout is
  the reference's;
* ``forward``, ``prefill`` and four ``decode_step``s of the reduced
  ``mamba2_1_3b`` and ``zamba2_1_2b`` equal the reference's on the same
  weights and tokens (numpy seed), with the reference's ``use_pallas``
  False (its einsums) and True (the Pallas SSD kernel in interpret mode),
  at a prompt of 40 tokens (the chunk is 16, so the dt=0 pad runs): float32
  logits within rtol = atol = 1e-4, and the caches likewise;
* the port's prefill and decode agree with its own forward (the pattern of
  ``tests/test_archs.py:50``): the hand-over from the chunked scan to the
  recurrence;
* in bfloat16 the blocks keep the reference's type promotions (float32
  caches, bf16 block outputs), and one prefill block (with its states) and
  one decode step agree with the reference's within bf16 rounding;
* a ``ServingEngine`` over the reduced ``zamba2_1_2b`` (and the whole path,
  dispatcher and fleet) gives the reference's tokens.

The reduced configs keep prompts at or below ``dense_attn_max_seq`` (128),
where the reference's plain attention is one einsum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import events as rev
from repro.models import model_zoo as rz
from repro.serving import dispatcher as rd
from repro.serving import engine as re
from repro.serving import fleet as rf
from repro_torch import configs as pconfigs
from repro_torch.core import events as pev
from repro_torch.models import mamba as pm
from repro_torch.models import model_zoo as pz
from repro_torch.serving import dispatcher as pd
from repro_torch.serving import engine as pe
from repro_torch.serving import fleet as pf
from test_torch_models import _pair, _tok
from test_torch_serving import _serve

SSM = ["mamba2_1_3b", "zamba2_1_2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
T_PROMPT, MAX_LEN = 40, 48


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _port_bits(t):
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", SSM)
def test_weights_survive_conversion(name):
    rcfg, pcfg, params, model = _pair(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    sd = model.state_dict()
    flat = jax.tree.map(np.asarray, params)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    L = rcfg.n_layers
    blocks = flat["blocks"]
    assert np.array_equal(_port_bits(sd[f"blocks.{L - 1}.in_proj.weight"]),
                          _bits(blocks["in_proj"][L - 1]).T)
    assert np.array_equal(_port_bits(sd["blocks.0.out_proj.weight"]), _bits(blocks["out_proj"][0]).T)
    for leaf, port in (("conv_w", "conv_w"), ("conv_b", "conv_b"), ("A_log", "A_log"),
                       ("D", "D"), ("dt_bias", "dt_bias"), ("norm", "norm.weight"),
                       ("gate_norm", "gate_norm.weight")):
        assert np.array_equal(_port_bits(sd[f"blocks.1.{port}"]), _bits(blocks[leaf][1]))
    if rcfg.attn_every:
        sh = flat["shared_attn"]
        assert np.array_equal(_port_bits(sd["shared_attn.1.attn.wq.weight"]),
                              _bits(sh["attn"]["wq"][1]).T)
        assert np.array_equal(_port_bits(sd["shared_attn.0.mlp.w_gate.weight"]),
                              _bits(sh["mlp"]["w_gate"][0]).T)
        assert np.array_equal(_port_bits(sd["shared_attn.1.ln2.weight"]), _bits(sh["ln2"][1]))
        assert "lm_head.weight" in sd
    else:
        assert "lm_head.weight" not in sd  # tied: the embedding is the head
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_ref


@pytest.mark.parametrize("name", SSM)
def test_cache_spec_matches_reference(name):
    want = rz.cache_spec(rconfigs.get_config(name).reduced(), 3, 24)
    got = pz.cache_spec(pconfigs.get_config(name).reduced(), 3, 24)
    assert set(got) == set(want)
    for key, (shape, dtype) in got.items():
        assert shape == want[key].shape
        assert str(dtype).split(".")[-1] == want[key].dtype.name
    full = pz.cache_spec(pconfigs.get_config(name), 1, 8)
    assert full["ssm"][0][0] == pconfigs.get_config(name).n_layers
    if name == "zamba2_1_2b":
        assert full["k"][0][0] == 6  # one entry per shared-attention invocation


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", SSM)
def test_model_matches_reference(name, use_pallas):
    rcfg, pcfg, params, model = _pair(name, use_pallas=use_pallas)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (2, T_PROMPT)).astype(np.int32)

    want, _ = rz.forward(params, rcfg, {"tokens": jnp.asarray(toks)})
    got, aux = pz.forward(model, pcfg, {"tokens": _tok(toks)})
    assert got.shape == (2, T_PROMPT, rcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["moe_aux_loss"]) == 0.0

    want, rcache = rz.prefill(params, rcfg, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, pcache = pz.prefill(model, pcfg, {"tokens": _tok(toks)}, MAX_LEN)
    assert got.shape == (2, 1, rcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(pcache) == set(rcache)
    for key in pcache:
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(rcache[key]), **TOL)

    pos = np.array([T_PROMPT, T_PROMPT], np.int32)
    for _ in range(4):
        tok = rng.integers(0, rcfg.vocab_size, (2, 1)).astype(np.int32)
        want, rcache = rz.decode_step(params, rcfg, jnp.asarray(tok), jnp.asarray(pos), rcache)
        got, pcache = pz.decode_step(model, pcfg, _tok(tok), torch.from_numpy(pos), pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + 1
    for key in pcache:
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(rcache[key]), **TOL)


@pytest.mark.parametrize("T", [T_PROMPT, 32])
@pytest.mark.parametrize("name", SSM)
def test_prefill_and_decode_match_own_forward(name, T):
    """Prefill T tokens, then feed 4 more through decode_step: each step's
    logits equal the forward's over the whole sequence at that position."""
    _, pcfg, _, model = _pair(name)
    rng = np.random.default_rng(1)
    toks = _tok(rng.integers(0, pcfg.vocab_size, (2, T + 4)))
    full, _ = pz.forward(model, pcfg, {"tokens": toks})
    logits, cache = pz.prefill(model, pcfg, {"tokens": toks[:, :T]}, MAX_LEN)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, T - 1].numpy(), **TOL)
    pos = torch.full((2,), T, dtype=torch.int32)
    for i in range(4):
        logits, cache = pz.decode_step(model, pcfg, toks[:, T + i : T + i + 1], pos, cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, T + i].numpy(), **TOL)
        pos = pos + 1


@pytest.mark.parametrize("name", SSM)
def test_bf16_keeps_the_reference_promotions(name):
    """bfloat16 weights: the block's output and the logits are bf16, the
    decode caches float32, and one block agrees with the reference's within
    bf16 rounding."""
    from repro.models import mamba as rm

    rcfg, pcfg, params, model = _pair(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, rcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx).view(np.uint16).copy()).view(torch.bfloat16)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    want = rm.mamba_block(p0, jx, rcfg)
    got = pm.mamba_block(model.blocks[0], tx, pcfg)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    assert float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()) < 2e-2 * scale

    toks = _tok(rng.integers(0, pcfg.vocab_size, (2, 20)))
    logits, cache = pz.prefill(model, pcfg, {"tokens": toks}, 32)
    assert logits.dtype == torch.bfloat16
    assert cache["conv"].dtype == cache["ssm"].dtype == torch.float32
    logits, cache = pz.decode_step(model, pcfg, toks[:, :1], torch.full((2,), 20), cache)
    assert cache["conv"].dtype == cache["ssm"].dtype == torch.float32
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())


def _bf16(x):
    """(the reference's bf16 array, the port's bf16 tensor) of one float32 array."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)


def _close_to_scale(got, want, tol=2e-2):
    assert str(got.dtype).split(".")[-1] == np.asarray(want).dtype.name
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.float().numpy() - want).max()) < tol * scale


@pytest.mark.parametrize("name", SSM)
def test_bf16_prefill_block_and_decode_step_match_reference(name):
    """One bf16 block as the prefill runs it (``with_state``: output, conv
    window, final SSM state) against the reference's ``block_with_state``,
    then one bf16 ``mamba_decode_step`` from the same float32 caches against
    the reference's: each output in the reference's type and within bf16
    rounding (2e-2 of its scale)."""
    from repro.models import mamba as rm

    rcfg, pcfg, params, model = _pair(name, param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(4)
    jx, tx = _bf16(rng.standard_normal((2, 20, rcfg.d_model)).astype(np.float32))
    one = rcfg.with_(n_layers=1)
    p_one = {"blocks": jax.tree.map(lambda a: a[:1], params["blocks"])}
    x_out, rcache, _ = rz._ssm_prefill(p_one, one, jx, {}, jnp.arange(20), None)
    y, conv, ssm = pm.mamba_block(model.blocks[0], tx, pcfg, with_state=True)
    assert y.dtype == torch.bfloat16
    _close_to_scale(tx + y, x_out)
    _close_to_scale(conv, rcache["conv"][0])
    _close_to_scale(ssm, rcache["ssm"][0])

    conv_state, ssm_state = (np.array(rcache[k][0]) for k in ("conv", "ssm"))
    jt, tt = _bf16(rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32))
    p0 = jax.tree.map(lambda a: a[0], params["blocks"])
    want = rm.mamba_decode_step(p0, jt, rcfg, jnp.asarray(conv_state), jnp.asarray(ssm_state))
    got = pm.mamba_decode_step(model.blocks[0], tt, pcfg, torch.from_numpy(conv_state),
                               torch.from_numpy(ssm_state))
    for g, w in zip(got, want):
        _close_to_scale(g, w)


def test_serving_engine_matches_reference():
    """One zamba2 replica: the port's engine emits the reference engine's
    tokens slot by slot (prompts of 6 to 20 tokens, 5 new tokens each)."""
    rcfg, pcfg, params, model = _pair("zamba2_1_2b")
    ref_eng = re.ServingEngine(rcfg, params, max_batch=2, max_len=32, service_rate=2.0)
    port_eng = pe.ServingEngine(pcfg, model, max_batch=2, max_len=32, service_rate=2.0)
    rng = np.random.default_rng(3)
    for rid in range(4):
        prompt = rng.integers(0, rcfg.vocab_size, int(rng.integers(6, 21)))
        ref_eng.submit(re.Request(rid, prompt, max_new=5))
        port_eng.submit(pe.Request(rid, prompt, max_new=5))
    for t in range(16):
        assert port_eng.step() == ref_eng.step(), f"slot {t}"
        assert port_eng.backlog_tokens == ref_eng.backlog_tokens
    assert port_eng.tokens_served == ref_eng.tokens_served == 20


def test_serving_path_matches_reference():
    """Dispatcher, model-backed fleet of three zamba2 replicas, a straggler:
    the reference's routing and tokens (the pattern of
    ``tests/test_torch_serving.py::test_serving_path_matches_reference``)."""
    rcfg, pcfg, params, model = _pair("zamba2_1_2b")
    rates = [4.0, 2.0, 2.0]
    kw = dict(n_frontends=1, replica_hosts=np.array([1, 2, 3]), frontend_hosts=np.array([0]),
              host_costs=(np.ones((4, 4)) - np.eye(4)).astype(np.float32),
              replica_rates=np.array(rates))
    dcfg = dict(V=1.0, gamma=16.0, tokens_per_request=4.0)
    ref_disp = rd.PotusDispatcher(**kw, cfg=rd.DispatcherConfig(**dcfg))
    port_disp = pd.PotusDispatcher(**kw, cfg=pd.DispatcherConfig(**dcfg), device="cpu")
    n_slots = 24
    traces = [mod.flash_straggler(d.topo, start=3, duration=5, factor=0.25,
                                  instance=d.F).compile(d.topo, n_slots)
              for mod, d in ((rev, ref_disp), (pev, port_disp))]
    ref_fleet = rf.ReplicaFleet.from_model(rcfg, params, rates, max_batch=2, max_len=32)
    port_fleet = pf.ReplicaFleet.from_model(pcfg, model, rates, max_batch=2, max_len=32)
    want, routed_ref, _ = _serve(ref_disp, ref_fleet, re.Request, rcfg.vocab_size, traces[0],
                                 n_slots, np.random.default_rng(0))
    got, routed_port, reqs = _serve(port_disp, port_fleet, pe.Request, pcfg.vocab_size,
                                    traces[1], n_slots, np.random.default_rng(0))
    assert np.array_equal(routed_port, routed_ref)
    assert got == want
    assert len(reqs) > 4 and all(r.done and len(r.generated) == 4 for r in reqs)
