"""The plain versions of the port's attention kernels (flash and decode)
against the JAX reference: ``repro.kernels.ref`` and the Pallas calls in
interpret mode, on the shape grids of ``tests/test_kernels.py`` with inputs
made from a numpy seed. float32 within 2e-5, bfloat16 within 2e-2 (the
tolerances of ``tests/test_kernels.py``: the reference casts the softmax
weights to the value type before the PV product, the Pallas kernels do
not). Also: the model-layout wrappers of ``kernels.ops`` against the
reference's, and the CUDA wrappers refusing CPU tensors.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_call
from repro.kernels.flash_attention import flash_attention_call
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _draw(rng, shape, dtype):
    """A standard-normal array in ``dtype``, rounded once, for both packages."""
    return rng.standard_normal(shape).astype(np.float32).astype(_NP[dtype])


def _t(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


FLASH_SHAPES = [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (1, 4, 1, 512, 64), (2, 6, 2, 128, 48)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", FLASH_SHAPES)
def test_flash_plain_matches_reference_and_pallas(B, Hq, Hkv, S, D, causal, dtype):
    rng = np.random.default_rng(S + D)
    q, k, v = (_draw(rng, (B, h, S, D), dtype) for h in (Hq, Hkv, Hkv))
    got = kf.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == _TORCH[dtype] and got.shape == (B, Hq, S, D)
    want = ref.flash_attention_reference(_j(q), _j(k), _j(v), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    pallas = flash_attention_call(_j(q), _j(k), _j(v), causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])


DECODE_SHAPES = [(2, 4, 4, 256, 32), (3, 8, 2, 512, 64), (1, 4, 1, 1024, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", DECODE_SHAPES)
def test_decode_plain_matches_reference_and_pallas(B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(S + D)
    q = _draw(rng, (B, Hq, D), dtype)
    kc, vc = (_draw(rng, (B, S, Hkv, D), dtype) for _ in range(2))
    pos = rng.integers(0, S, size=B).astype(np.int32)
    pos[0] = S - 1
    got = kd.decode_attention_plain(_t(q), _t(kc), _t(vc), torch.from_numpy(pos))
    assert got.dtype == _TORCH[dtype] and got.shape == (B, Hq, D)
    want = ref.decode_attention_reference(_j(q), _j(kc), _j(vc), _j(pos))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    pallas = decode_attention_call(_j(q), _j(kc), _j(vc), _j(pos), block_s=128)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])


def test_decode_plain_ragged_positions():
    """Per-request masking takes effect, and position 0 attends to one row."""
    rng = np.random.default_rng(3)
    q = _draw(rng, (2, 4, 32), "float32")
    kc, vc = (_draw(rng, (2, 128, 2, 32), "float32") for _ in range(2))
    a = kd.decode_attention_plain(_t(q), _t(kc), _t(vc), torch.tensor([5, 100]))
    b = kd.decode_attention_plain(_t(q), _t(kc), _t(vc), torch.tensor([100, 100]))
    assert (a[0] - b[0]).abs().max() > 1e-4
    torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=0)
    first = kd.decode_attention_plain(_t(q), _t(kc), _t(vc), torch.tensor([0, 0]))
    want = np.repeat(np.asarray(vc)[:, 0], 2, axis=1)  # (B, Hkv, D) -> each head's group
    np.testing.assert_allclose(first.numpy(), want, rtol=1e-6, atol=1e-6)
    ragged = ref.decode_attention_reference(_j(q), _j(kc), _j(vc), jnp.array([5, 100]))
    np.testing.assert_allclose(a.numpy(), np.asarray(ragged), **TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_model_layout_matches_reference_ops(causal):
    """``ops.flash_attention`` takes the model's (B, S, H, D) layout, as the
    reference's ``kernels.ops.flash_attention`` does."""
    rng = np.random.default_rng(7)
    q = _draw(rng, (2, 64, 6, 32), "float32")
    k, v = (_draw(rng, (2, 64, 2, 32), "float32") for _ in range(2))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = rops.flash_attention(_j(q), _j(k), _j(v), causal=causal)
    assert got.shape == (2, 64, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    plain = ops.plain.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(plain, got)


def test_ops_decode_matches_reference_ops():
    rng = np.random.default_rng(8)
    q = _draw(rng, (3, 8, 64), "float32")
    kc, vc = (_draw(rng, (3, 96, 2, 64), "float32") for _ in range(2))
    pos = np.array([0, 95, 40], np.int32)
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(pos).long())
    want = rops.decode_attention(_j(q), _j(kc), _j(vc), _j(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers raise on CPU tensors (``kernels.ops``
    takes the plain version for those)."""
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        kf.flash_attention_call(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        kd.decode_attention_call(torch.zeros(1, 2, 32), torch.zeros(1, 8, 1, 32),
                                 torch.zeros(1, 8, 1, 32), torch.zeros(1, dtype=torch.int32))
    assert kf.launches.n == 0 and kd.launches.n == 0
