"""The arithmetic of the flash attention backward's tensor-core route
(``repro_torch.kernels.flash_attention``, ``csrc/flash_attention_bwd.cu``),
on the CPU.

The CUDA kernels cannot run here, so what they compute is stated in plain
PyTorch (:func:`flash_attention_bwd_tc_plain`): scores and dP = dO·Vᵀ in
float32, D = Σ P·dP over the recomputed P in float32 (never from the
bf16 output), dS = P (dP - D), P and dS rounded to bf16 where the kernels
round them (the operands of dV, dQ and dK), float32 accumulators, and each
KV head's dK and dV the sum of its query heads' partials in ascending g.
That statement is held against ``jax.grad`` of the JAX package's
``flash_attention_reference`` on the same seeded numpy inputs, at reduced
widths of internvl2-1b (14/2 heads of 64, causal) and hubert-xlarge
(16/16 of 80, bidirectional) with ragged S: within 2e-2 of each gradient's
scale in bf16, and within 2e-5 in float32 without the roundings. On a
hubert-like case, the sum over positions of dK (a key projection's bias
gradient, exactly zero) stays at the plain version's bf16 noise; taking D
from the bf16 output, as the first backward kernel did, doubles it. The
rule that routes a backward call to its tensor-core or SIMT kernel is
checked by type and head_dim. The kernels themselves are held against the
statement on the card (``tests/test_torch_kernel_cuda.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as kf


@pytest.mark.parametrize("dtype,D,want", [
    ("bfloat16", 64, "tc"), ("bfloat16", 80, "tc"), ("bfloat16", 128, "tc"),  # internvl2, hubert, qwen
    ("bfloat16", 32, "simt"), ("bfloat16", 48, "simt"), ("bfloat16", 96, "simt"),
    ("bfloat16", 256, "simt"),
    ("float32", 64, "simt"), ("float32", 80, "simt"), ("float32", 128, "simt"),  # TF32: no
])
def test_bwd_route_rule_by_type_and_head_dim(dtype, D, want):
    assert kf.bwd_route(getattr(torch, dtype), D) == want


def _inputs(B, Hq, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, S, D)).astype(np.float32) for h in (Hq, Hkv, Hkv, Hq)]


def _jax_grads(q, k, v, dout, causal):
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_reference(a, b, c, causal), q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(dout)]


def _scale_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (B, Hq, Hkv, S, D, causal): internvl2-1b's and hubert-xlarge's heads, S no multiple of a tile
CASES = [(1, 14, 2, 96, 64, True), (1, 14, 2, 200, 64, True), (1, 16, 16, 96, 80, False),
         (1, 16, 16, 200, 80, False), (1, 8, 2, 130, 128, True)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", CASES)
def test_tc_statement_matches_jax_grad_in_bf16(B, Hq, Hkv, S, D, causal):
    """The statement on bf16 inputs against jax.grad of the reference in
    bf16: dq, dk, dv within 2e-2 of each gradient's scale."""
    xs = _inputs(B, Hq, Hkv, S, D, S + D)
    got = kf.flash_attention_bwd_tc_plain(*(torch.from_numpy(x).bfloat16() for x in xs), causal)
    want = _jax_grads(*(jnp.asarray(x, jnp.bfloat16) for x in xs), causal)
    for name, g, w, x in zip("qkv", got, want, xs):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        assert _scale_gap(g.float(), w) <= 2e-2, name


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", CASES[::2])
def test_unrounded_statement_matches_jax_grad_in_f32(B, Hq, Hkv, S, D, causal):
    """Without the bf16 roundings, in float32: within 2e-5 of scale."""
    xs = _inputs(B, Hq, Hkv, S, D, S + D)
    got = kf.flash_attention_bwd_tc_plain(*(torch.from_numpy(x) for x in xs), causal,
                                          rounded=False)
    want = _jax_grads(*(jnp.asarray(x) for x in xs), causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        assert _scale_gap(g, w) <= 2e-5, name


def _bias_gap(dk) -> float:
    """max |sum over positions of dK| (a key bias's gradient, exactly zero)
    over max |dK|."""
    return float(dk.float().sum(dim=2).abs().max() / dk.float().abs().max())


def _dk_with_d_from_output(q, k, v, dout):
    """dK as the first backward kernel took it, D = dO·o from the bf16 output
    (bidirectional): what the key-bias check must catch."""
    B, Hq, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    o = kf.flash_attention_plain(q, k, v, causal=False)
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)
    dp = dout.float() @ v.float().transpose(-1, -2)
    d = (dout.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - d)).bfloat16().float()
    return (torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale).bfloat16()


def test_key_bias_gradient_stays_at_the_plain_versions_noise():
    """A hubert-like case (16/16 heads of 80, bidirectional, bf16): the sum
    over positions of the statement's dK (exactly zero: softmax ignores a
    per-query shift) is within 1.5x of the plain version's own bf16 gap,
    where D taken from the bf16 output lands above 1.5x. Both the
    statement and the plain version round dS and dK to bf16, so their gaps
    are two draws of the same noise (0.9-1.2x of each other over seeds);
    1.5x is the chip script's bound for the same witness at full depth."""
    q, k, v, dout = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 16, 16, 200, 80, 0))
    stmt = _bias_gap(kf.flash_attention_bwd_tc_plain(q, k, v, dout, False)[1])
    plain = _bias_gap(kf.flash_attention_bwd_plain(q, k, v, dout, False)[1])
    from_output = _bias_gap(_dk_with_d_from_output(q, k, v, dout))
    assert stmt <= 1.5 * plain
    assert from_output > 1.5 * plain
