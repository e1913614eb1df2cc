"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA device and ``nvcc`` and skip without
them (the CPU has no interpret mode for a CUDA kernel). On the dyadic
system every sum is exact in f32, so kernel and plain version must agree
bitwise: the slot kernel for every scheduler, in one-slot and eight-slot
launches, with two kernel runs identical; the schedule and price kernels on
every slot's state of a dyadic scan-engine run. On random integer problems
the schedule kernel matches within ``rtol/atol 1e-5`` (the shapes of
``tests/test_kernels.py:176-181``). Run on the machine with the card:

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
