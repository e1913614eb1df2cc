"""The hand-written CUDA slot kernel against its plain version, on the card.

Marked ``cuda``: it needs a CUDA device and ``nvcc`` and skips without
them (the CPU has no interpret mode for a CUDA kernel). On the dyadic
system every sum is exact in f32, so kernel and plain version must agree
bitwise for every scheduler, in one-slot and eight-slot launches, and two
kernel runs must be identical. Run on the machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package.)
"""
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
