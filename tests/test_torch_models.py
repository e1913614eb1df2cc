"""The port's configs and dense decoder against the JAX reference.

* every config of ``ALL_ARCHS``, and its ``reduced()``, equals the
  reference's field by field (``repro_torch.configs`` is a copy);
* the reference's weights survive ``convert.model_params_from_numpy``
  (float32 and bfloat16, bit for bit);
* ``forward``, ``prefill`` and four ``decode_step``s of the port equal the
  reference's ``repro.models.model_zoo`` on the same weights and tokens
  (numpy seed), for the reduced dense configs, with the reference's
  ``use_pallas`` False (dense einsum attention) and True (Pallas in
  interpret mode): float32 logits within rtol = atol = 1e-4 (the
  reference's own two paths differ by ~2e-6), and the KV cache likewise;
* the encoder (hubert-xlarge: frame embeddings in, no token embedding, no
  decode step) and the ``vision_stub`` config (internvl2-1b: patch
  embeddings before the tokens) equal the reference likewise, and every
  family (MoE, encoder, frontend, SSM, hybrid) passes ``check_supported``
  (``tests/test_torch_moe.py`` holds the MoE configs against the
  reference), and the entry points refuse a missing card unless given
  ``device="cpu"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model_zoo as rz
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.models import common as pc
from repro_torch.models import model_zoo as pz

DENSE = ["qwen2_5_32b", "gemma_7b", "stablelm_3b", "deepseek_7b", "internvl2_1b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def test_config_registry_matches_reference():
    assert pconfigs.ALL_ARCHS == rconfigs.ALL_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in pconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}


@pytest.mark.parametrize("name", rconfigs.ALL_ARCHS)
def test_config_matches_reference_field_by_field(name):
    ref, port = rconfigs.get_config(name), pconfigs.get_config(name)
    assert type(port).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert [s.name for s in pconfigs.cells_for(port)] == [s.name for s in rconfigs.cells_for(ref)]


def _pair(name, **kw):
    """(reference cfg, port cfg, reference params, port model on the CPU with
    the reference's weights). ``name`` with ``:frontend`` keeps the config's
    frontend; without it the frontend is dropped (the text decoder), except
    for an encoder, whose frontend stub is its input."""
    name, _, keep = name.partition(":")
    if not keep and not rconfigs.get_config(name).is_encoder:
        kw = dict(frontend=None, **kw)
    rcfg = rconfigs.get_config(name).reduced().with_(**kw)
    pcfg = pconfigs.get_config(name).reduced().with_(**kw)
    params = rz.init(jax.random.PRNGKey(0), rcfg)
    model = pz.init(pcfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(convert.model_params_from_numpy(pcfg, jax.tree.map(np.asarray, params)))
    return rcfg, pcfg, params, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_survive_conversion(dtype):
    rcfg, pcfg, params, model = _pair("qwen2_5_32b", param_dtype=dtype, compute_dtype=dtype)
    sd = model.state_dict()
    flat = jax.tree.map(np.asarray, params)
    torch_dtype = pc.DTYPES[dtype]
    assert all(t.dtype == torch_dtype for t in sd.values())

    def bits(x):  # exact comparison in the stored type
        x = np.asarray(x)
        return x.view(np.uint16) if x.dtype.name == "bfloat16" else x

    def port_bits(t):
        return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    assert np.array_equal(port_bits(sd["embed"]), bits(flat["embed"]))
    assert np.array_equal(port_bits(sd["lm_head.weight"]), bits(flat["lm_head"]).T)
    L = rcfg.n_layers
    assert np.array_equal(port_bits(sd[f"blocks.{L - 1}.attn.wq.weight"]),
                          bits(flat["blocks"]["attn"]["wq"][L - 1]).T)
    assert np.array_equal(port_bits(sd["blocks.1.attn.wk.bias"]),
                          bits(flat["blocks"]["attn"]["bk"][1]))
    assert np.array_equal(port_bits(sd["blocks.0.mlp.w_out.weight"]),
                          bits(flat["blocks"]["mlp"]["w_out"][0]).T)
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_ref


def _tok(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


def _batches(rcfg, rng):
    """The same batch for both sides: (reference's, port's); 16 positions —
    an encoder's frame embeddings, or a ``vision_stub`` config's 8 patches
    before 8 tokens, or 16 tokens."""
    if rcfg.is_encoder:
        x = rng.standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
        return {"embeddings": jnp.asarray(x)}, {"embeddings": torch.from_numpy(x)}
    n_p = rcfg.n_frontend_tokens if rcfg.frontend == "vision_stub" else 0
    toks = rng.integers(0, rcfg.vocab_size, (2, 16 - n_p)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": _tok(toks)}
    if n_p:
        x = rng.standard_normal((2, n_p, rcfg.d_model)).astype(np.float32)
        ref["patches"], port["patches"] = jnp.asarray(x), torch.from_numpy(x)
    return ref, port


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", DENSE + ["internvl2_1b:vision_stub", "hubert_xlarge"])
def test_model_matches_reference(name, use_pallas):
    rcfg, pcfg, params, model = _pair(name, use_pallas=use_pallas)
    rng = np.random.default_rng(0)
    rbatch, pbatch = _batches(rcfg, rng)

    want, _ = rz.forward(params, rcfg, rbatch)
    got, aux = pz.forward(model, pcfg, pbatch)
    assert got.shape == (2, 16, rcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["moe_aux_loss"]) == 0.0

    max_len = 32
    want, rcache = rz.prefill(params, rcfg, rbatch, max_len)
    got, pcache = pz.prefill(model, pcfg, pbatch, max_len)
    assert got.shape == (2, 1, rcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    shape, _ = pz.cache_spec(pcfg, 2, max_len)["k"]
    assert tuple(pcache["k"].shape) == shape == tuple(rcache["k"].shape)
    if rcfg.is_encoder:  # an encoder has no decode step, in either package
        assert model.embed is None and model.lm_head is not None
        with pytest.raises(ValueError, match="encoder"):
            pz.decode_step(model, pcfg, _tok(np.zeros((2, 1), np.int32)),
                           torch.full((2,), 16, dtype=torch.int32), pcache)
        return

    pos = np.array([16, 16], np.int32)
    for _ in range(4):
        tok = rng.integers(0, rcfg.vocab_size, (2, 1)).astype(np.int32)
        want, rcache = rz.decode_step(params, rcfg, jnp.asarray(tok), jnp.asarray(pos), rcache)
        got, pcache = pz.decode_step(model, pcfg, _tok(tok), torch.from_numpy(pos), pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + 1
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(rcache[key]), **TOL)


def test_norm_and_rope_keep_the_reference_rounding_points():
    """bfloat16: rms_norm normalises in float32, casts, then scales;
    apply_rope rotates in float32 and casts back (``common.py:86-106``)."""
    from repro.models import common as rc

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = pc.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    want = rc.rms_norm(xb, wb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    pos = np.array([0, 3, 7, 100, 4095])
    cos, sin = pc.rope(torch.from_numpy(pos), 8, 1e6)
    rcos, rsin = rc.rope(jnp.asarray(pos), 8, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), rtol=1e-5, atol=1e-5)
    got = pc.apply_rope(torch.from_numpy(x).bfloat16(), cos, sin)
    want = rc.apply_rope(xb, rcos, rsin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_init_draws_the_reference_scales():
    """Leaf.materialize's scales: embed 0.02, matrices 1/sqrt(fan_in), biases
    zero, norms one; the same generator seed gives the same weights. The
    Mamba2 leaves: ``conv_w`` 0.5 (``mamba.py:37``), ``A_log``, ``D`` and
    ``gate_norm`` one, ``dt_bias`` and ``conv_b`` zero."""
    cfg = pconfigs.get_config("qwen2_5_32b").reduced()
    a = pz.init(cfg, torch.Generator().manual_seed(1), "cpu")
    b = pz.init(cfg, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not any(p.requires_grad for p in a.parameters())
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    wq = a.blocks[0].attn.wq.weight  # (out, in)
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert float(a.blocks[0].attn.wq.bias.abs().max()) == 0.0
    assert float((a.blocks[0].ln1.weight - 1).abs().max()) == 0.0

    cfg = pconfigs.get_config("zamba2_1_2b").reduced().with_(d_model=256)
    m = pz.init(cfg, torch.Generator().manual_seed(1), "cpu")
    blk = m.blocks[1]
    assert isinstance(m, pz.SSMDecoder) and len(m.shared_attn) == cfg.n_shared_attn
    assert abs(float(blk.conv_w.std()) - 0.5) < 0.02
    assert abs(float(blk.in_proj.weight.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    d_in = cfg.ssm_expand * cfg.d_model
    assert abs(float(blk.out_proj.weight.std()) * np.sqrt(d_in) - 1.0) < 0.05
    for one in (blk.A_log, blk.D, blk.gate_norm.weight, blk.norm.weight):
        assert float((one - 1).abs().max()) == 0.0
    for zero in (blk.dt_bias, blk.conv_b):
        assert float(zero.abs().max()) == 0.0
    wq = m.shared_attn[0].attn.wq.weight
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("name", ["granite_moe_1b", "hubert_xlarge", "internvl2_1b"])
def test_unported_families_raise(name):
    """The families that once raised are ported: the MoE configs
    (``models/moe.py``), the encoder (hubert-xlarge: no token embedding, an
    LM head, no decode step) and the ``vision_stub`` config (internvl2-1b)
    build at their reduced and full sizes and pass ``check_supported``; a
    frontend other than the two stubs raises."""
    cfg = pconfigs.get_config(name)
    pz.check_supported(cfg)
    pz.check_supported(cfg.reduced())
    model = pz.init(cfg.reduced(), torch.Generator().manual_seed(0), "cpu")
    assert pz.cache_spec(cfg.reduced(), 1, 16)["k"][0][0] == cfg.reduced().n_layers
    if cfg.moe:
        assert any(b.moe is not None for b in model.blocks)
        pz.check_supported(pconfigs.get_config("llama4_maverick_400b"))
    with torch.device("meta"):
        full = pz.DenseDecoder(cfg)
    # the config's count (configs/base.py) counts an embedding even for an encoder, and
    # leaves out the final norm and the q/k/v biases
    n = sum(p.numel() for p in full.parameters())
    biases = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim
    assert n == (cfg.param_count() + cfg.d_model + biases * cfg.qkv_bias
                 - cfg.vocab_size * cfg.d_model * cfg.is_encoder)
    assert (full.embed is None) == cfg.is_encoder
    with pytest.raises(ValueError, match="frontend"):
        pz.check_supported(cfg.with_(frontend="video_stub"))


@pytest.mark.parametrize("field,value,item", [("moe", True, 6), ("is_encoder", True, 7),
                                              ("frontend", "vision_stub", 7)])
def test_check_supported_names_the_roadmap_item(field, value, item):
    """Every family the ROADMAP.md section 1 items ported passes
    ``check_supported``: MoE (item 6's single-card part), encoder-only and
    frontend configs (item 7), SSM and hybrid configs; a model of the field
    builds and runs a forward on the CPU."""
    experts = dict(n_experts=4, top_k=2) if field == "moe" else {}
    cfg = pconfigs.get_config("qwen2_5_32b").reduced().with_(**{field: value}, **experts)
    pz.check_supported(cfg)
    model = pz.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = ({"embeddings": torch.zeros(1, 4, cfg.d_model)} if cfg.is_encoder
             else {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    logits, _ = pz.forward(model, cfg, batch)
    assert logits.shape == (1, 4, cfg.vocab_size), f"item {item}: {field}"
    for name in ("mamba2_1_3b", "zamba2_1_2b", "granite_moe_1b", "llama4_maverick_400b",
                 "hubert_xlarge", "internvl2_1b"):
        pz.check_supported(pconfigs.get_config(name))


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for a machine without one")
    cfg = pconfigs.get_config("qwen2_5_32b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pz.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pz.init_cache(cfg, 1, 16)
    assert pz.init_cache(cfg, 1, 16, "cpu")["k"].device.type == "cpu"
