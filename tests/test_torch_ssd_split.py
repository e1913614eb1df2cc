"""The SSD intra-chunk kernel's decomposition (``csrc/ssd_intra_chunk.cu``),
stated in plain PyTorch on the CPU and held against the JAX package's
Pallas kernel in interpret mode.

The CUDA kernel forms C·Bᵀ once per (batch, chunk) and lets every head read
it; on bf16 inputs it runs y_diag and the states on the tensor cores with
float32 operands split in bf16 terms: W = hi + lo for y_diag (two products),
and for the states x scaled by each key's weight, x·w = t1 + t2 + t3 (three
products against the bf16 B, exact: 24 significant bits).
:func:`split_design` computes the same thing in float32 with PyTorch's
products. The tensor cores multiply bf16 pairs exactly and accumulate in
float32, so only the order of the float32 sums differs between the two.

Limits, of max |ref| (``tests/test_kernels.py:98-108``): y_diag within 1e-2
in bf16 and 1e-5 in float32, the float32 states within 1e-5 in both; on the
dyadic inputs of ``tests/test_torch_kernel_cuda.py`` every product and sum
is exact, so the match is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_scan as rks

torch.set_num_threads(1)

SCALE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _torch(a):
    """A jax or numpy array as a tensor, bfloat16 read bit for bit."""
    n = np.asarray(a)
    if n.dtype.name == "bfloat16":
        return torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(n.copy())


def _bf16(t):
    """float32 ``t`` rounded to the nearest bfloat16, back in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def split_design(xc, dtc, dA_cum, Bc, Cc):
    """y_diag (in xc's type) and the float32 states as the CUDA kernel
    computes them: C·Bᵀ once per (batch, chunk) for all heads; for bf16 x the
    two-term split of the decay-weighted C·Bᵀ and the three-term split of x
    scaled by the keys' weights; for float32 x the float32 products."""
    x, dt = xc.float(), dtc.float()
    Q = xc.shape[2]
    cb = torch.einsum("bnqs,bnks->bnqk", Cc.float(), Bc.float())  # no head axis
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b, n, q, k, h)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    w = torch.where(causal, (cb[..., None] * torch.exp(seg)) * dt[:, :, None, :, :], 0.0)
    wk = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dt  # (b, n, k, h)
    if xc.dtype == torch.bfloat16:
        hi = _bf16(w)
        lo = _bf16(w - hi)
        y = (torch.einsum("bnqkh,bnkhp->bnqhp", hi, x)
             + torch.einsum("bnqkh,bnkhp->bnqhp", lo, x))
        xw = x * wk[..., None]  # (b, n, k, h, p)
        t1 = _bf16(xw)
        t2 = _bf16(xw - t1)
        t3 = _bf16(xw - t1 - t2)
        states = sum(torch.einsum("bnks,bnkhp->bnhps", Bc.float(), t) for t in (t1, t2, t3))
        return y.to(torch.bfloat16), states
    u = Bc.float()[:, :, :, None, :] * wk[..., None]  # (b, n, k, h, s)
    y = torch.einsum("bnqkh,bnkhp->bnqhp", w, x)
    return y, torch.einsum("bnkhp,bnkhs->bnhps", x, u)


def _inputs(seed, b, nc, Q, H, P, S, x_dtype):
    """The model's types: x, B, C in ``x_dtype`` (bf16 rounded once by jax),
    dt in the same type from a softplus, dA_cum the float32 cumsum of dt * A
    with A in Mamba2's range [-16, -1]."""
    rng = np.random.default_rng(seed)
    jt = getattr(jnp, x_dtype)
    x = jnp.asarray(rng.standard_normal((b, nc, Q, H, P)), jt)
    Bm = jnp.asarray(rng.standard_normal((b, nc, Q, S)), jt)
    Cm = jnp.asarray(rng.standard_normal((b, nc, Q, S)), jt)
    dt = jnp.asarray(np.logaddexp(rng.standard_normal((b, nc, Q, H)) - 4.0, 0), jt)
    A = -(1.0 + 15.0 * rng.random(H)).astype(np.float32)
    dA = np.cumsum(np.asarray(dt, np.float32) * A, axis=2).astype(np.float32)
    jargs = (x, dt, jnp.asarray(dA), Bm, Cm)
    return jargs, tuple(_torch(a) for a in jargs)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 40])
@pytest.mark.parametrize("Q", [48, 96])
def test_split_design_matches_reference_kernel(Q, S, x_dtype):
    """Ragged q/k tiles (Q=48, 96 against 64), several heads, a ragged p tile."""
    jargs, targs = _inputs(Q + S, 1, 2, Q, 3, 24, S, x_dtype)
    want_y, want_st = (np.asarray(a, np.float32)
                       for a in rks.ssd_intra_chunk_call(*jargs, interpret=True))
    y, st = split_design(*targs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    for got, want, tol in ((y, want_y, SCALE_TOL[x_dtype]), (st, want_st, SCALE_TOL["float32"])):
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got.float().numpy() - want).max()) / scale <= tol


def test_weight_splits_hold_their_bits():
    """W = hi + lo to 2^-16 of |W| (each bf16 term keeps 8 significant bits);
    x·w = t1 + t2 + t3 exactly, over values spanning many binades."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal(20000) * 2.0 ** rng.integers(-30, 30, 20000))
                         .astype(np.float32))
    hi = _bf16(w)
    lo = _bf16(w - hi)
    assert bool(((w - hi - lo).abs() <= w.abs() * 2.0 ** -16).all())
    t1 = _bf16(w)
    t2 = _bf16(w - t1)
    t3 = _bf16(w - t1 - t2)
    assert torch.equal((t1 + t2) + t3, w)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_design_is_exact_on_dyadic_inputs(x_dtype):
    """dA_cum = 0, dt in {0.5, 1, 2}, small-integer x, B, C: W needs at most
    16 significant bits, so hi + lo is W and every sum is exact; the design
    equals the reference kernel bitwise (the inputs of the card's test)."""
    rng = np.random.default_rng(7)
    b, nc, Q, H, P, S = 2, 3, 96, 3, 80, 40
    jt = getattr(jnp, x_dtype)
    x = jnp.asarray(rng.integers(-2, 3, (b, nc, Q, H, P)), jt)
    Bm = jnp.asarray(rng.integers(-2, 3, (b, nc, Q, S)), jt)
    Cm = jnp.asarray(rng.integers(-2, 3, (b, nc, Q, S)), jt)
    dt = jnp.asarray(rng.choice([0.5, 1.0, 2.0], (b, nc, Q, H)), jnp.float32)
    dA = jnp.zeros((b, nc, Q, H), jnp.float32)
    jargs = (x, dt, dA, Bm, Cm)
    want_y, want_st = rks.ssd_intra_chunk_call(*jargs, interpret=True)
    y, st = split_design(*(_torch(a) for a in jargs))
    assert torch.equal(y, _torch(want_y)) and torch.equal(st, _torch(want_st))
