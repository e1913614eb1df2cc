"""The port's SSD intra-chunk function and chunked scan against the JAX
reference, on the CPU.

* ``ssd_intra_chunk_plain`` (the plain version of the CUDA kernel) equals
  ``repro.kernels.ref.ssd_intra_chunk_reference`` on numpy-seeded inputs, in
  float32 and bfloat16 and with the model's mixed types (bf16 activations,
  float32 ``dA_cum``): max |diff| / max |ref| within 1e-5 in float32 and
  1e-2 in bfloat16 (the rule of ``tests/test_kernels.py:98-108``);
* the port's ``ssd_chunked`` equals the reference's with ``use_pallas``
  False (its einsums) and True (the Pallas kernel in interpret mode), at a
  T that is a multiple of the chunk and one that is not (the dt=0 pad),
  within 1e-4 in float32; ``ssd_chunked_with_state``'s final state too;
* ``kernels.ops.ssd_intra_chunk`` takes the plain version on CPU tensors
  without counting a launch, and the CUDA wrapper refuses CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import mamba as rm
from repro.models import model_zoo as rz
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models import mamba as pm
from repro_torch.models.common import einsum
from repro_torch.models import model_zoo as pz

SCALE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TOL = dict(rtol=1e-4, atol=1e-4)


def _torch(a):
    """A jax or numpy array as a tensor, bfloat16 read bit for bit."""
    n = np.asarray(a)
    if n.dtype.name == "bfloat16":
        return torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(n.copy())


def _pair(a, dtype):
    """numpy float32 ``a`` as a (jax, torch) pair in ``dtype``, the bf16 one
    rounded once by jax."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, _torch(j)


def _intra_inputs(seed, b, nc, Q, H, P, S, x_dtype, dt_dtype):
    """Inputs of the intra-chunk function as the model makes them: dt from a
    softplus, dA_cum the float32 cumsum of dt * A with A negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, Q, H, P)).astype(np.float32)
    Bm = rng.standard_normal((b, nc, Q, S)).astype(np.float32)
    Cm = rng.standard_normal((b, nc, Q, S)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, nc, Q, H)), 0).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    jx, tx = _pair(x, x_dtype)
    jB, tB = _pair(Bm, x_dtype)
    jC, tC = _pair(Cm, x_dtype)
    jdt, tdt = _pair(dt, dt_dtype)
    dA = np.cumsum(np.asarray(jdt, np.float32) * A, axis=2).astype(np.float32)
    return (jx, jdt, jnp.asarray(dA), jB, jC), (tx, tdt, torch.from_numpy(dA), tB, tC)


@pytest.mark.parametrize("x_dtype,dt_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32")])
@pytest.mark.parametrize("b,nc,Q,H,P,S", [(1, 2, 16, 4, 16, 16), (2, 3, 32, 2, 8, 24),
                                          (1, 1, 64, 3, 32, 16)])
def test_plain_version_matches_reference(b, nc, Q, H, P, S, x_dtype, dt_dtype):
    jargs, targs = _intra_inputs(b + nc + Q, b, nc, Q, H, P, S, x_dtype, dt_dtype)
    want = ref.ssd_intra_chunk_reference(*jargs)
    got = ks.ssd_intra_chunk_plain(*targs)
    limit = SCALE_TOL[x_dtype]
    for g, w in zip(got, want):
        assert np.asarray(w).dtype.name == "float32" and g.dtype == torch.float32  # dA promotes
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(np.abs(w).max(), 1e-6)
        assert (np.abs(g.numpy() - w) / scale).max() < limit


def test_plain_version_promotes_as_jnp_einsum():
    """bf16 activations with a float32 dA_cum: jnp.einsum promotes to float32,
    so y_diag and the states come back float32, as here."""
    jargs, targs = _intra_inputs(0, 1, 2, 16, 2, 8, 8, "bfloat16", "bfloat16")
    want = ref.ssd_intra_chunk_reference(*jargs)
    got = ks.ssd_intra_chunk_plain(*targs)
    assert [np.asarray(w).dtype.name for w in want] == ["float32", "float32"]
    assert [g.dtype for g in got] == [torch.float32, torch.float32]
    a = torch.ones((2, 3), dtype=torch.bfloat16)
    assert einsum("ij,ij->i", a, a.float()).dtype == torch.float32


def _scan_inputs(seed, b, T, H, P, S):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, T, H)), 0).astype(np.float32)
    A = -np.abs(rng.standard_normal(H)).astype(np.float32) * 0.5
    Bm = rng.standard_normal((b, T, S)).astype(np.float32)
    Cm = rng.standard_normal((b, T, S)).astype(np.float32)
    return (x, dt, A, Bm, Cm)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("T", [40, 48])
def test_ssd_chunked_matches_reference(T, use_pallas):
    args = _scan_inputs(T, 2, T, 4, 8, 16)
    want = rm.ssd_chunked(*map(jnp.asarray, args), chunk=16, use_pallas=use_pallas)
    got = pm.ssd_chunked(*map(torch.from_numpy, args), 16)
    assert tuple(got.shape) == (2, T, 4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [40, 48])
def test_ssd_chunked_with_state_matches_reference(T):
    args = _scan_inputs(T + 1, 2, T, 4, 8, 16)
    want_y, want_s = rz.ssd_chunked_with_state(*map(jnp.asarray, args), chunk=16)
    got_y, got_s = pz.ssd_chunked_with_state(*map(torch.from_numpy, args), 16)
    assert tuple(got_s.shape) == (2, 4, 8, 16) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_final_state_continues_the_scan():
    """The final state of the first T tokens, carried one token further by
    the decode recurrence, gives the scan's output at token T+1."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _scan_inputs(3, 1, 33, 2, 4, 8))
    y_all = pm.ssd_chunked(x, dt, A, Bm, Cm, 16)
    _, s = pm.ssd_chunked_with_state(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], 16)
    g = torch.exp(dt[:, 32] * A)  # (b, H)
    s = s * g[:, :, None, None] + torch.einsum("bh,bhp,bs->bhps", dt[:, 32], x[:, 32],
                                               Bm[:, 32])
    y_next = torch.einsum("bhps,bs->bhp", s, Cm[:, 32])
    np.testing.assert_allclose(y_next.numpy(), y_all[:, 32].numpy(), **TOL)


def test_ops_route_by_device_and_the_kernel_refuses_the_cpu():
    _, targs = _intra_inputs(1, 1, 2, 16, 2, 8, 8, "float32", "float32")
    ks.launches.reset()
    got = ops.ssd_intra_chunk(*targs)
    want = ops.plain.ssd_intra_chunk(*targs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ks.launches.n == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.ssd_intra_chunk_call(*targs)


def test_reference_tolerance_case_of_the_kernel_test():
    """The inputs of ``tests/test_kernels.py::TestSSDIntraChunk`` (jax.random,
    bf16 x/B/C with float32 dt and dA): the plain version within 1e-2 of
    scale."""
    b, nc, Q, H, P, S = 1, 2, 64, 2, 32, 16
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    xc = jax.random.normal(keys[0], (b, nc, Q, H, P), jnp.bfloat16)
    dtc = jax.nn.softplus(jax.random.normal(keys[1], (b, nc, Q, H))).astype(jnp.float32)
    dA_cum = jnp.cumsum(-jnp.abs(jax.random.normal(keys[2], (b, nc, Q, H))) * 0.1, axis=2)
    Bc = jax.random.normal(keys[3], (b, nc, Q, S), jnp.bfloat16)
    Cc = jax.random.normal(keys[4], (b, nc, Q, S), jnp.bfloat16)
    want = ref.ssd_intra_chunk_reference(xc, dtc, dA_cum, Bc, Cc)
    got = ks.ssd_intra_chunk_plain(*map(_torch, (xc, dtc, dA_cum, Bc, Cc)))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert (np.abs(g.float().numpy() - w) / np.abs(w).max()).max() < 1e-2
