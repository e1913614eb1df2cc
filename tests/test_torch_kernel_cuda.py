"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA device and ``nvcc`` and skip without
them (the CPU has no interpret mode for a CUDA kernel). On the dyadic
system every sum is exact in f32, so kernel and plain version must agree
bitwise: the slot kernel for every scheduler, in one-slot and eight-slot
launches, with two kernel runs identical; the schedule and price kernels on
every slot's state of a dyadic scan-engine run. On random integer problems
the schedule kernel matches within ``rtol/atol 1e-5`` (the shapes of
``tests/test_kernels.py:176-181``). The flash and decode attention kernels
match their plain versions within the tolerances of ``tests/test_kernels.py``
(2e-5 in float32, 2e-2 in bfloat16: the plain versions cast the softmax
weights to the value type, the kernels do not) on its shape grids plus the
served model's widths, a ragged tile and head_dim 256, and repeat bitwise.
Run on the machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package.)
"""
import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_kernel_matches_plain_version_bitwise(cuda_device, scheduler):
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    T, W, age_cap = 40, 2, 16
    topo, net, placement, arr = chip_smoke.dyadic_system(pt, T, W)
    consts, state, streams = chip_smoke.step_inputs(cf, topo, net, placement, arr, T, W, 2.0,
                                                    0.5, age_cap, cuda_device)
    s_p, m_p = chip_smoke.run_slots(ps.potus_slot_step_plain, consts, state, streams, 1,
                                    scheduler, age_cap)
    for K in (1, 8):
        ps.launches.reset()
        s_k, m_k = chip_smoke.run_slots(ps.potus_slot_call, consts, state, streams, K,
                                        scheduler, age_cap)
        assert ps.launches.n == -(-T // K)
        s_k2, m_k2 = chip_smoke.run_slots(ps.potus_slot_call, consts, state, streams, K,
                                          scheduler, age_cap)
        torch.cuda.synchronize()
        for x, y, z in zip(s_k + (m_k,), s_p + (m_p,), s_k2 + (m_k2,)):
            assert torch.equal(x, y)  # exact sums on the dyadic tier: bitwise
            assert torch.equal(x, z)  # fixed reduction order: runs repeat bitwise


def test_scan_kernels_match_plain_version_bitwise_on_dyadic_states(cuda_device):
    import repro_torch.core as pt
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks

    ks.launches.reset()
    kp.launches.reset()
    chip_smoke.dyadic_scan_checks(pt, kp, ks, cuda_device)
    assert ks.launches.n == kp.launches.n == 120


@pytest.mark.parametrize("shape", [(60, 8, 6), (128, 16, 10), (96, 4, 3), (250, 32, 24)])
def test_schedule_kernel_matches_plain_version_on_random_problems(cuda_device, shape):
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks

    args, gamma = chip_smoke.random_problem(0, *shape, cuda_device)
    chip_smoke.check_price_and_schedule(kp, ks, args, gamma, 2.0, 1.0, str(shape), False)
    x1 = ks.potus_schedule_call(*args, gamma, 2.0, 1.0)
    x2 = ks.potus_schedule_call(*args, gamma, 2.0, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(x1, x2)  # no atomics: runs repeat bitwise


def test_drain_kernel_matches_plain_version(cuda_device):
    """Kernel 4 on the random and dyadic draws of
    ``tests/test_torch_cohort_drain.py`` (bitwise on exact inputs, else
    rtol/atol 1e-5; two runs bitwise equal) and on every slot's inputs of a
    dyadic run of the dense route."""
    import repro_torch.core as pt
    from repro_torch.kernels import cohort_drain as kd

    kd.launches.reset()
    chip_smoke.drain_checks(pt, cuda_device)
    assert kd.launches.n == 2 * (8 + 40)  # two kernel runs per check


ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _randn(rng, shape, dtype, device):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64),
                                          (1, 4, 1, 512, 64), (2, 6, 2, 128, 48),
                                          (1, 40, 8, 300, 128), (1, 2, 1, 33, 256)])
def test_flash_attention_kernel_matches_plain_version(cuda_device, B, Hq, Hkv, S, D, causal,
                                                      dtype):
    from repro_torch.kernels import flash_attention as kf

    rng = np.random.default_rng(S + D)
    q, k, v = (_randn(rng, (B, h, S, D), dtype, cuda_device) for h in (Hq, Hkv, Hkv))
    kf.launches.reset()
    out = kf.flash_attention_call(q, k, v, causal)
    again = kf.flash_attention_call(q, k, v, causal)
    want = kf.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert kf.launches.n == 2 and out.dtype == q.dtype and out.shape == (B, Hq, S, D)
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)  # no atomics: runs repeat bitwise


def test_flash_attention_kernel_reads_the_model_layout(cuda_device):
    """``kernels.ops.flash_attention`` hands the kernel (B, S, H, D) tensors as
    strided (B, H, S, D) views and gets a contiguous (B, S, H, D) back."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, (2, 100, h, 64), "float32", cuda_device) for h in (6, 2, 2))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.plain.flash_attention(q, k, v, causal=True)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 4, 4, 256, 32), (3, 8, 2, 512, 64),
                                          (1, 4, 1, 1024, 128), (4, 40, 8, 1024, 128),
                                          (2, 2, 1, 100, 256)])
def test_decode_attention_kernel_matches_plain_version(cuda_device, B, Hq, Hkv, S, D, dtype):
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(S + D)
    q = _randn(rng, (B, Hq, D), dtype, cuda_device)
    kc, vc = (_randn(rng, (B, S, Hkv, D), dtype, cuda_device) for _ in range(2))
    pos_np = rng.integers(0, S, size=B).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, S - 1  # one row, and the whole cache
    pos = torch.as_tensor(pos_np, device=cuda_device)
    kd.launches.reset()
    out = kd.decode_attention_call(q, kc, vc, pos)
    again = kd.decode_attention_call(q, kc, vc, pos)
    want = kd.decode_attention_plain(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert kd.launches.n == 2 and out.dtype == q.dtype
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)


def test_attention_kernels_refuse_what_they_do_not_take(cuda_device):
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    q = torch.zeros((1, 4, 8, 32), device=cuda_device)
    k = torch.zeros((1, 2, 8, 32), device=cuda_device)
    with pytest.raises(TypeError):
        kf.flash_attention_call(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        kf.flash_attention_call(q, k, k.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError):
        kd.decode_attention_call(q[:, :, 0], k.transpose(1, 2), k.transpose(1, 2),
                                 torch.zeros(1, dtype=torch.int64, device=cuda_device))
