"""The split over cache positions of the port's decode attention kernel
(``repro_torch.kernels.decode_attention``), on the CPU.

``decode_split_plan`` is checked at the served models' shapes and at the
edges (S below, at and above a split length; one request), and the rule
that routes a call of either attention kernel to its tensor-core or SIMT
kernel by type and head_dim. The algorithm
the CUDA kernels run — a partial (m, l, acc) per L consecutive positions,
merged over the valid splits in ascending order, each weighted by
exp(m_i - max m) — is stated here in plain PyTorch (for the tests only)
and held within 1e-6 in float32 against the JAX package's
``decode_attention_reference`` and its Pallas ``decode_attention_call`` in
interpret mode, with ``pos`` on and beside every split edge, pos = 0
included. Inputs come from a numpy seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_call
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf

H100_SMS = 132


@pytest.mark.parametrize("dtype,D,want", [
    ("bfloat16", 64, "tc"), ("bfloat16", 128, "tc"),  # zamba2-1.2b and qwen2.5-32b heads
    ("bfloat16", 32, "simt"), ("bfloat16", 48, "simt"), ("bfloat16", 256, "simt"),
    ("float32", 64, "simt"), ("float32", 128, "simt"),  # TF32 would break the 2e-5 limit
])
def test_route_rule_by_type_and_head_dim(dtype, D, want):
    assert kf.route(getattr(torch, dtype), D) == want


def _blocks(B, Hkv, S, L):
    return B * Hkv * -(-S // L)


@pytest.mark.parametrize("B,Hkv,S,want", [
    (4, 8, 1024, (64, 16)),   # qwen2.5-32b decode, the served cache: 512 blocks
    (2, 32, 544, (128, 5)),   # zamba2-1.2b decode: 320 blocks
    (1, 8, 1024, (64, 16)),   # one request: 128 blocks, none reaches 264
    (4, 8, 40, (64, 1)),      # S below every split length
    (16, 8, 64, (64, 1)),     # S equal to the smallest split length: 128 blocks
    (32, 8, 256, (128, 2)),   # S equal to the largest: 256 blocks at L=256, 512 at 128
    (64, 8, 256, (256, 1)),   # 512 blocks at L=256
    (8, 32, 4096, (256, 16)),
])
def test_split_plan_at_served_and_edge_shapes(B, Hkv, S, want):
    L, splits = kd.decode_split_plan(B, Hkv, S, H100_SMS)
    assert (L, splits) == want
    assert L in kd.SPLIT_LENGTHS and splits == max(1, -(-S // L))
    reach = [Lc for Lc in kd.SPLIT_LENGTHS if _blocks(B, Hkv, S, Lc) >= 2 * H100_SMS]
    if reach:  # two blocks an SM wherever a split length can give them, at the largest such L
        assert _blocks(B, Hkv, S, L) >= 2 * H100_SMS and L == max(reach)
    else:
        assert L == min(kd.SPLIT_LENGTHS)


@pytest.mark.parametrize("n_sm", [1, 16, 132, 1000])
def test_split_plan_depends_on_shapes_and_sm_count_only(n_sm):
    """The plan is a pure function of (B, Hkv, S, n_sm), never of pos: the
    block count reaches 2 * n_sm wherever any split length allows it."""
    for B in (1, 2, 4, 8):
        for Hkv in (1, 8, 32):
            for S in (1, 63, 64, 65, 300, 1024):
                L, splits = kd.decode_split_plan(B, Hkv, S, n_sm)
                possible = _blocks(B, Hkv, S, min(kd.SPLIT_LENGTHS)) >= 2 * n_sm
                assert (B * Hkv * splits >= 2 * n_sm) == possible


def split_merge_decode(q, k_cache, v_cache, pos, L):
    """Decode attention as the CUDA kernels compute it, in plain PyTorch:
    q (B, Hq, D); caches (B, S, Hkv, D); pos (B,). Pass 1: each run of L
    positions of a (request, KV head) gives its rows a partial (m, l, acc)
    over its positions t <= pos; pass 2 merges the ceil((pos + 1) / L) valid
    splits in ascending order: M = max m_i, w_i = exp(m_i - M),
    out = (sum_i acc_i w_i) / max(sum_i l_i w_i, 1e-30)."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    splits = max(1, -(-S // L))
    pad = splits * L - S
    qg = q.float().reshape(B, Hkv, G, D)
    kk = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vv = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhgd,bshd->bhgs", qg, kk) / math.sqrt(D)
    valid = torch.arange(splits * L)[None, :] <= pos.long()[:, None]  # (B, splits * L)
    s = s.masked_fill(~valid[:, None, None, :], -math.inf).reshape(B, Hkv, G, splits, L)
    m = s.amax(-1)  # (B, Hkv, G, splits): -inf for a split past pos
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgjt,bjthd->bhgjd", p, vv.reshape(B, splits, L, Hkv, D))
    out = torch.empty((B, Hkv, G, D))
    for b in range(B):
        n = min(-(-(int(pos[b]) + 1) // L), splits)
        M = m[b, :, :, :n].amax(-1)  # (Hkv, G)
        acc_b = torch.zeros((Hkv, G, D))
        l_b = torch.zeros((Hkv, G))
        for i in range(n):  # ascending
            w = torch.exp(m[b, :, :, i] - M)
            acc_b = acc_b + acc[b, :, :, i] * w[..., None]
            l_b = l_b + l[b, :, :, i] * w
        out[b] = acc_b / torch.clamp(l_b, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


def _edge_positions(S, L, B):
    """pos on and beside every split edge (0 included), in batches of B."""
    edges = {0, 1, S - 1}
    for e in range(L, S, L):
        edges |= {e - 1, e, e + 1}
    pos = sorted(p for p in edges if 0 <= p < S)
    pos += [S - 1] * (-len(pos) % B)
    return [np.array(pos[i:i + B], np.int32) for i in range(0, len(pos), B)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,L", [
    (4, 40, 8, 256, 128, 64),   # qwen2.5-32b widths, cut in S
    (2, 32, 32, 256, 64, 128),  # zamba2-1.2b widths, cut in S
    (3, 8, 2, 300, 32, 64),     # a ragged last split
    (2, 4, 1, 512, 64, 256),
])
def test_split_merge_matches_reference_and_pallas(B, Hq, Hkv, S, D, L):
    rng = np.random.default_rng(S + D + L)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    for pos in _edge_positions(S, L, B):
        got = split_merge_decode(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(pos), L)
        args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos))
        want = np.asarray(ref.decode_attention_reference(*args))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        block_s = 128 if S % 128 == 0 else 100  # the Pallas call takes S in whole blocks
        pallas = np.asarray(decode_attention_call(*args, block_s=block_s))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
        plain = kd.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(kc),
                                          torch.from_numpy(vc), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def test_split_merge_at_the_served_plan():
    """The plan's own split at qwen2.5-32b decode widths, B=4, S=1024 (L=64,
    16 splits), against the reference, every edge of the first two splits
    and the last position."""
    B, Hq, Hkv, S, D = 4, 40, 8, 1024, 128
    L, _ = kd.decode_split_plan(B, Hkv, S, H100_SMS)
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    pos = np.array([0, L - 1, L, S - 1], np.int32)
    got = split_merge_decode(*(torch.from_numpy(x) for x in (q, kc, vc, pos)), L)
    want = ref.decode_attention_reference(*(jnp.asarray(x) for x in (q, kc, vc, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
