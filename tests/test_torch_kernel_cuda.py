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
weights to the value type and the kernels do not, or round them at another
point) on its shape grids plus the served models' widths, ragged tiles,
head_dim 256 and every split edge of the decode plan, repeat bitwise, and
count which flash route (tensor cores or SIMT) ran.
The SSD intra-chunk kernel matches its plain version within 1e-5 (float32)
and 1e-2 (bfloat16) of the tensor's scale (the states within 1e-5 in both)
at mamba2-1.3b and zamba2-1.2b widths in the model's types and at widths no
16-byte load fits, bitwise on dyadic inputs, and repeats bitwise; bf16
takes its tensor-core route, float32 the CUDA cores. The slot kernel also
runs bitwise on a 603-bucket age axis, and with N scenarios in one call
(the scenario axis of a sweep partition) each scenario equals its own
one-scenario call bitwise, at 69 and 290 buckets. The drain kernel matches its plain
version at ragged I (300, 1025: a cut column strip and chunk, no 16-byte
loads at 1025) and at I=16384 with the dense route's sparsity, gives zeros
for an all-zero ratio and a NaN row for an out-of-range component, and
repeats bitwise. The host-loop oracles (``engine="cohort"`` and
``run_event_sim``) on the card equal their runs on the CPU bitwise on the
dyadic system — mis-predicted, under a k-failure and with every cohort
stream; fluid and aligned, and with tuple service and jitter — and launch
the schedule kernel (``potus``) or the price kernel (``potus-loop``) once a
slot. The MoE layer (``models/moe.py``, no kernel of its own) on the card
equals its run on the CPU in its selections, keep masks, loads, router
states and dropped fractions, y within 1e-5 of max |y|, two runs bitwise.
The flash attention backward kernel matches the autograd gradient of the
plain version within 2e-5 (float32) / 2e-2 (bfloat16) of each gradient's
scale at internvl2-1b's and hubert-xlarge's widths, GQA, head_dim up to 256
and ragged S, repeats bitwise, and counts its route (bf16 at head_dim 64,
80 and 128 on the tensor cores, the rest SIMT); the tensor-core route
matches its arithmetic stated in plain PyTorch within 1e-2 and raises on a
misaligned pointer or stride; the kernel runs under
``kernels.ops.flash_attention``'s autograd, and a reduced train step's gradients on the kernel route match the
plain route within 1e-4, and on a 1x1 model mesh (ZeRO-1 moments,
``grad_specs``) two steps equal the meshless steps bitwise (internvl2-1b,
and stablelm-3b, the dense decoder that trains tensor-parallel); on a
(1, 2) mesh of two gloo ranks sharing the card a reduced stablelm-3b step
(each rank half the heads, kernels 5 and 5b on them) matches the one-rank
step's loss and grad norm within rel 1e-5, as do a reduced internvl2-1b
step on (1, 2) (patch labels masked) and a reduced hubert-xlarge step on
(1, 4) of gloo ranks on the card; a reduced
MoE train step (granite-moe-1b's reduction, drops) on the card equals its
run on the CPU in each layer's selections, keep masks, loads and dropped
fractions and its router state, the loss within rel 1e-5, and gains
granite-moe-1b among the kernel-route against plain-route steps;
``ssd_intra_chunk`` raises when a CUDA input requires grad (no SSD
backward kernel yet). The sharded cohort-fused scan
takes the slot kernel on a one-rank NCCL world, bitwise the dense port on
the card, and on four gloo ranks sharing the card equals the CPU port
bitwise on the dyadic cases of ``chip_smoke.sharded_cases``.
Run on the machine with the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package.)
"""
import sys
from pathlib import Path

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


@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_kernel_matches_plain_version_bitwise_on_a_long_age_axis(cuda_device, scheduler):
    """age_cap 600 (603 buckets): a row's shared memory passes 48 KB and the
    container partials split the components into chunks; still bitwise on the
    dyadic system, in one-slot and eight-slot launches."""
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    T, W, age_cap = 24, 2, 600
    topo, net, placement, arr = chip_smoke.dyadic_system(pt, T, W)
    consts, state, streams = chip_smoke.step_inputs(cf, topo, net, placement, arr, T, W, 2.0,
                                                    0.5, age_cap, cuda_device)
    s_p, m_p = chip_smoke.run_slots(ps.potus_slot_step_plain, consts, state, streams, 1,
                                    scheduler, age_cap)
    for K in (1, 8):
        s_k, m_k = chip_smoke.run_slots(ps.potus_slot_call, consts, state, streams, K,
                                        scheduler, age_cap)
        torch.cuda.synchronize()
        for x, y in zip(s_k + (m_k,), s_p + (m_p,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("age_cap", [66, 287])  # Atot 69 (the fleet's) and 290 (Fig. 6ab's)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("N", [1, 3, 4])
def test_batched_slot_kernel_equals_one_scenario_calls(cuda_device, N, stacked, age_cap):
    """N scenarios in one call (a scenario axis in the grid): each equals its
    own one-scenario call bitwise, the batch equals the batched plain version
    bitwise on the dyadic system, two runs repeat bitwise, and a call of K
    slots is one launch whatever N is; shared and stacked streams, K=1 and 4,
    potus, shuffle and jsq."""
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    T, W = 24, 2
    sys_ = chip_smoke.dyadic_system(pt, T, W)
    Vs, betas = [2.0, 1.0, 4.0, 0.5][:N], [0.5, 1.0, 0.25, 2.0][:N]
    consts, state, streams, one = chip_smoke.batch_inputs(cf, sys_, T, W, Vs, betas, age_cap,
                                                          cuda_device, stacked)
    for scheduler in ("potus", "shuffle", "jsq"):
        s_p, m_p = chip_smoke.run_slots(ps.potus_slot_step_plain, consts, state, streams, 1,
                                        scheduler, age_cap)
        for K in (1, 4):
            ps.launches.reset()
            s_b, m_b = chip_smoke.run_slots(ps.potus_slot_call, consts, state, streams, K,
                                            scheduler, age_cap)
            assert ps.launches.n == -(-T // K)
            s_b2, m_b2 = chip_smoke.run_slots(ps.potus_slot_call, consts, state, streams, K,
                                              scheduler, age_cap)
            torch.cuda.synchronize()
            for x, y, z in zip(s_b + (m_b,), s_p + (m_p,), s_b2 + (m_b2,)):
                assert torch.equal(x, y)
                assert torch.equal(x, z)
            for n, (c_n, st_n, xs_n) in enumerate(one):
                s_1, m_1 = chip_smoke.run_slots(ps.potus_slot_call, c_n, st_n, xs_n, K,
                                                scheduler, age_cap)
                torch.cuda.synchronize()
                for x, y in zip(s_1 + (m_1,), tuple(b[n] for b in s_b) + (m_b[:, n],)):
                    assert torch.equal(x, y)


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


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("I,C,Atot,age_bucket", [(300, 12, 69, 64), (1025, 12, 69, 64),
                                                 (100, 3, 300, 200)])
def test_drain_kernel_at_ragged_sizes(cuda_device, I, C, Atot, age_bucket, dyadic):
    """Kernel 4 at the fleet's widths (C=12, Atot=69) on I that cuts a column
    strip and a chunk (I=1025: no 16-byte loads), and on an age axis longer
    than one landing tile (Atot=300: two bucket slices): against its plain
    version, bitwise on exact inputs, else within 1e-5; two runs bitwise."""
    from repro_torch.kernels import cohort_drain as kd

    args = chip_smoke.drain_problem(1, I, C, Atot, dyadic, cuda_device)
    _, same = chip_smoke.check_drain(kd, args, age_bucket, f"drain I={I} Atot={Atot}")
    assert same or not dyadic


def test_drain_kernel_at_the_fleet_size_and_sparsity(cuda_device):
    """Kernel 4 at I=16384, C=12, Atot=69 with phase C's sparsity: 5616
    nonzero ratios gathered in 300 target columns (X sends each source's
    mass to the cheapest instances), within 1e-5 of its plain version; two
    runs bitwise."""
    from repro_torch.kernels import cohort_drain as kd

    I, C, Atot = 16384, 12, 69
    rng = np.random.default_rng(2)
    src = torch.as_tensor((rng.uniform(0, 4, (I, C, Atot + 1))
                           * (rng.random((I, C, Atot + 1)) < 0.4)).astype(np.float32),
                          device=cuda_device)
    ship = torch.as_tensor(rng.uniform(0, 10, (I, C)).astype(np.float32), device=cuda_device)
    comp = torch.as_tensor(rng.integers(0, C, I).astype(np.int32), device=cuda_device)
    cols = rng.choice(I, 300, replace=False)
    flat = np.unique(rng.integers(0, I, 5616) * I + rng.choice(cols, 5616))
    ratio = torch.zeros(I * I, dtype=torch.float32, device=cuda_device)
    ratio[torch.as_tensor(flat, device=cuda_device)] = torch.as_tensor(
        rng.uniform(0.01, 1, flat.size).astype(np.float32), device=cuda_device)
    args = (src, ship, ratio.reshape(I, I), comp)
    chip_smoke.check_drain(kd, args, 64, "drain I=16384")


def test_drain_kernel_on_an_all_zero_ratio(cuda_device):
    from repro_torch.kernels import cohort_drain as kd

    src, ship, ratio, comp = chip_smoke.drain_problem(3, 1025, 12, 69, False, cuda_device)
    land = kd.cohort_drain_call(src, ship, torch.zeros_like(ratio), comp, 64)
    torch.cuda.synchronize()
    assert land.shape == (1025, 69) and not land.any()


@pytest.mark.parametrize("I", [300, 1024])
def test_drain_kernel_writes_a_nan_row_for_an_out_of_range_component(cuda_device, I):
    from repro_torch.kernels import cohort_drain as kd

    src, ship, ratio, comp = chip_smoke.drain_problem(4, I, 12, 69, True, cuda_device)
    bad = torch.tensor([0, 33, I - 1], device=cuda_device)
    comp_bad = comp.clone()
    comp_bad[bad] = torch.tensor([-1, 12, 40], dtype=torch.int32, device=cuda_device)
    got = kd.cohort_drain_call(src, ship, ratio, comp_bad, 64)
    got2 = kd.cohort_drain_call(src, ship, ratio, comp_bad, 64)
    want = kd.cohort_drain_split_plain(src, ship, ratio, comp, 64)
    torch.cuda.synchronize()
    good = torch.ones(I, dtype=torch.bool, device=cuda_device)
    good[bad] = False
    assert torch.isnan(got[bad]).all()
    assert torch.equal(got[good], want[good])
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(got2))


ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _randn(rng, shape, dtype, device):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64),
                                          (1, 4, 1, 512, 64), (2, 6, 2, 128, 48),
                                          (1, 40, 8, 300, 128), (1, 2, 1, 33, 256),
                                          (1, 32, 32, 512, 64), (1, 32, 32, 544, 64),
                                          (2, 40, 8, 77, 128)])
def test_flash_attention_kernel_matches_plain_version(cuda_device, B, Hq, Hkv, S, D, causal,
                                                      dtype):
    """The shape grid of ``tests/test_kernels.py``, the served models' widths
    (qwen2.5-32b: 40/8 heads of 128; zamba2-1.2b: 32/32 heads of 64) and
    ragged tiles; the route counters show which kernel ran."""
    from repro_torch.kernels import flash_attention as kf

    rng = np.random.default_rng(S + D)
    q, k, v = (_randn(rng, (B, h, S, D), dtype, cuda_device) for h in (Hq, Hkv, Hkv))
    for c in (kf.launches, kf.launches_tc, kf.launches_simt):
        c.reset()
    out = kf.flash_attention_call(q, k, v, causal)
    again = kf.flash_attention_call(q, k, v, causal)
    want = kf.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert kf.launches.n == 2 and out.dtype == q.dtype and out.shape == (B, Hq, S, D)
    tc = dtype == "bfloat16" and D in (64, 128)
    assert (kf.launches_tc.n, kf.launches_simt.n) == ((2, 0) if tc else (0, 2))
    tol = ATT_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, again)  # no atomics: runs repeat bitwise


def test_flash_attention_kernel_reads_the_model_layout(cuda_device):
    """``kernels.ops.flash_attention`` hands the kernel (B, S, H, D) tensors as
    strided (B, H, S, D) views and gets a contiguous (B, S, H, D) back, on
    both routes."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        q, k, v = (_randn(rng, (2, 100, h, 64), dtype, cuda_device) for h in (6, 2, 2))
        kf.launches_tc.reset()
        got = ops.flash_attention(q, k, v, causal=True)
        want = ops.plain.flash_attention(q, k, v, causal=True)
        assert got.is_contiguous()
        assert kf.launches_tc.n == (dtype == "bfloat16")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _split_edge_pos(B, S, L, rng):
    """Batches of ``pos`` that put 0, L-1, L, 2L-1 and S-1 in some request,
    the rest random."""
    edges = [p for p in (0, L - 1, L, 2 * L - 1, S - 1) if p < S]
    edges += list(rng.integers(0, S, -len(edges) % B))
    return [np.array(edges[i:i + B], np.int32) for i in range(0, len(edges), B)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 4, 4, 256, 32), (3, 8, 2, 512, 64),
                                          (1, 4, 1, 1024, 128), (4, 40, 8, 1024, 128),
                                          (2, 2, 1, 100, 256), (2, 32, 32, 544, 64)])
def test_decode_attention_kernel_matches_plain_version(cuda_device, B, Hq, Hkv, S, D, dtype):
    """On random positions and on every split edge of the plan's L (0, L-1,
    L, 2L-1, S-1): the kernels' pair against the plain version, two runs
    bitwise, one counted launch per call, pass 1 on the tensor cores for
    bf16 at head_dim 64 and 128 and on the CUDA cores otherwise."""
    from repro_torch.kernels import decode_attention as kd

    rng = np.random.default_rng(S + D)
    q = _randn(rng, (B, Hq, D), dtype, cuda_device)
    kc, vc = (_randn(rng, (B, S, Hkv, D), dtype, cuda_device) for _ in range(2))
    pos_np = rng.integers(0, S, size=B).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, S - 1  # one row, and the whole cache
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    L, _ = kd.decode_split_plan(B, Hkv, S, n_sm)
    tol = ATT_TOL[dtype]
    for p_np in (pos_np, *_split_edge_pos(B, S, L, rng)):
        pos = torch.as_tensor(p_np, device=cuda_device)
        for c in (kd.launches, kd.launches_tc, kd.launches_simt):
            c.reset()
        out = kd.decode_attention_call(q, kc, vc, pos)
        again = kd.decode_attention_call(q, kc, vc, pos)
        want = kd.decode_attention_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert kd.launches.n == 2 and out.dtype == q.dtype
        tc = dtype == "bfloat16" and D in (64, 128)
        assert (kd.launches_tc.n, kd.launches_simt.n) == ((2, 0) if tc else (0, 2))
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
    # the tensor-core route: a view 2 bytes off a 16-byte boundary
    wide = torch.zeros((1, 4, 8, 72), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        kf.flash_attention_call(wide[..., 1:65], kv, kv)
    cache = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16, device=cuda_device)
    qd = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=cuda_device)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kd.decode_attention_call(qd.half(), cache.half(), cache.half(), pos)
    with pytest.raises(ValueError):  # G = 33 > MAX_GROUP
        kd.decode_attention_call(torch.zeros((1, 66, 64), dtype=torch.bfloat16,
                                             device=cuda_device), cache, cache, pos)
    flat = torch.zeros(cache.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off
        kd.decode_attention_call(qd, flat[1:].view(cache.shape), cache, pos)
    with pytest.raises(ValueError, match="aligned"):  # rows of 60 bf16: not whole 16 bytes
        kd.decode_attention_call(qd[..., :60].contiguous(), cache[..., :60].contiguous(),
                                 cache[..., :60].contiguous(), pos)


SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # of max |ref|: tests/test_kernels.py:98-108


def _ssd_close(got, want, dtype):
    """y_diag within its type's limit, the float32 states within float32's."""
    for g, w, tol in zip(got, want, (SSD_TOL[dtype], SSD_TOL["float32"])):
        scale = max(float(w.float().abs().max()), 1e-6)
        assert float((g.float() - w.float()).abs().max()) / scale < tol


@pytest.mark.parametrize("b,T,dtype", [(1, 2048, "bfloat16"), (1, 2048, "float32"),
                                       (2, 1000, "float32"), (2, 1000, "bfloat16"),
                                       (1, 300, "float32")])
def test_ssd_intra_chunk_kernel_matches_plain_version(cuda_device, b, T, dtype):
    """mamba2-1.3b widths (H=64, P=64, S=128, chunk 256) in the model's types,
    the inputs caught on ``ssd_chunked``'s kernel route (T=1000 pads to
    nc=4); the kernel's y_diag is in x's type, its states float32."""
    from repro_torch.kernels import ssd_scan as kss

    x, dt, A, B, C = chip_smoke.ssd_inputs(T, b, T, getattr(torch, dtype), cuda_device)
    args = chip_smoke.ssd_kernel_inputs(x, dt, A, B, C, 256)
    kss.launches.reset()
    got = kss.ssd_intra_chunk_call(*args)
    again = kss.ssd_intra_chunk_call(*args)
    want = kss.ssd_intra_chunk_plain(*args)
    torch.cuda.synchronize()
    assert kss.launches.n == 2
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    _ssd_close(got, want, dtype)
    assert all(torch.equal(g, a) for g, a in zip(got, again))  # no atomics: runs repeat


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_intra_chunk_kernel_at_zamba2_widths(cuda_device, dtype):
    """zamba2-1.2b's prefill shapes (H=64, P=64, S=64, chunk 256, a 512-token
    prompt: nc=2), the inputs caught on ``ssd_chunked``'s kernel route."""
    from repro_torch.kernels import ssd_scan as kss

    x, dt, A, B, C = chip_smoke.ssd_inputs(5, 1, 512, getattr(torch, dtype), cuda_device, S=64)
    args = chip_smoke.ssd_kernel_inputs(x, dt, A, B, C, 256)
    got = kss.ssd_intra_chunk_call(*args)
    again = kss.ssd_intra_chunk_call(*args)
    _ssd_close(got, kss.ssd_intra_chunk_plain(*args), dtype)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_intra_chunk_kernel_on_unaligned_widths(cuda_device, dtype):
    """Q=90, P=60, S=20: rows of x, B, C and C·Bᵀ that no 16-byte load fits,
    ragged q, k, p and s tiles, two heads; limits as above, runs repeat."""
    from repro_torch.kernels import ssd_scan as kss

    x, dt, A, B, C = chip_smoke.ssd_inputs(9, 2, 180, getattr(torch, dtype), cuda_device, H=2,
                                           P=60, S=20)
    args = chip_smoke.ssd_kernel_inputs(x, dt, A, B, C, 90)
    got = kss.ssd_intra_chunk_call(*args)
    again = kss.ssd_intra_chunk_call(*args)
    _ssd_close(got, kss.ssd_intra_chunk_plain(*args), dtype)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_kernel_is_exact_on_dyadic_inputs(cuda_device, x_dtype):
    """dA_cum = 0 (every decay is exp(0) = 1), dt in {0.5, 1, 2}, x, B, C small
    integers: every product and sum is exact in float32, so kernel and plain
    version agree bitwise whatever their summation orders."""
    from repro_torch.kernels import ssd_scan as kss

    rng = np.random.default_rng(7)
    b, nc, Q, H, P, S = 2, 3, 96, 3, 80, 40  # ragged q, p and s tiles
    dev, xdt = cuda_device, getattr(torch, x_dtype)

    def ints(*shape):
        return torch.as_tensor(rng.integers(-2, 3, shape), dtype=xdt, device=dev)

    xc, Bc, Cc = ints(b, nc, Q, H, P), ints(b, nc, Q, S), ints(b, nc, Q, S)
    dtc = torch.as_tensor(rng.choice([0.5, 1.0, 2.0], (b, nc, Q, H)), dtype=torch.float32,
                          device=dev)
    dA = torch.zeros((b, nc, Q, H), dtype=torch.float32, device=dev)
    got = kss.ssd_intra_chunk_call(xc, dtc, dA, Bc, Cc)
    y, st = kss.ssd_intra_chunk_plain(xc, dtc, dA, Bc, Cc)
    assert torch.equal(got[0], y.to(xdt)) and torch.equal(got[1], st)


def test_ssd_chunked_kernel_route_matches_plain_route(cuda_device):
    """End to end (the pattern of ``tests/test_kernels.py:110``): the chunked
    scan through the kernel against ``kernels.ops.plain``, float32, a T that
    is not a multiple of the chunk."""
    from repro_torch.kernels import ops
    from repro_torch.models import mamba as pm

    x, dt, A, B, C = chip_smoke.ssd_inputs(0, 2, 700, torch.float32, cuda_device)
    got = pm.ssd_chunked(x, dt, A, B, C, 256)
    want = pm.ssd_chunked(x, dt, A, B, C, 256, ops=ops.plain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ssd_intra_chunk_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import ssd_scan as kss

    xc = torch.zeros((1, 1, 16, 2, 8), device=cuda_device)
    dt = torch.zeros((1, 1, 16, 2), device=cuda_device)
    Bc = torch.zeros((1, 1, 16, 4), device=cuda_device)
    with pytest.raises(TypeError):  # dA_cum must be float32
        kss.ssd_intra_chunk_call(xc, dt, dt.bfloat16(), Bc, Bc)
    with pytest.raises(TypeError):  # x, B and C share one type
        kss.ssd_intra_chunk_call(xc, dt, dt, Bc.bfloat16(), Bc)
    with pytest.raises(ValueError):
        kss.ssd_intra_chunk_call(xc.transpose(3, 4).contiguous().transpose(3, 4), dt, dt, Bc,
                                 Bc)
    with pytest.raises(ValueError):
        kss.ssd_intra_chunk_call(xc.cpu(), dt.cpu(), dt.cpu(), Bc.cpu(), Bc.cpu())


@pytest.mark.parametrize("case", ["W=0", "mis-predicted", "k-failure"])
@pytest.mark.parametrize("scheduler", ["potus", "potus-loop", "shuffle", "jsq"])
def test_cohort_event_loop_card_equals_cpu(cuda_device, scheduler, case):
    import dataclasses

    import repro_torch.core as pt
    from repro_torch.obs import ENGINE_STREAMS

    T = chip_smoke.ORACLE_T
    topo, net, placement, arr = chip_smoke.dyadic_system(pt, T + 13, 2)
    pred = (arr * 2.0 ** np.random.default_rng(9).integers(-1, 2, size=arr.shape)).astype(
        np.float32)
    events = pt.k_failures(topo, 2, start=10, duration=12,
                           rng=np.random.default_rng(1)).compile(topo, T)
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=T,
                         engine="cohort", scheduler=scheduler, V=2.0, beta=0.5,
                         window=0 if case == "W=0" else 2,
                         predicted=pred if case == "mis-predicted" else None,
                         events=events if case == "k-failure" else None, warmup=8,
                         drain_margin=12, metrics=tuple(sorted(ENGINE_STREAMS["cohort"])),
                         device="cuda")
    card, n = chip_smoke.counted(lambda: pt.simulate(spec))
    assert n == chip_smoke.oracle_launches(scheduler, T)
    assert chip_smoke.same_oracle(card, pt.simulate(dataclasses.replace(spec, device="cpu")))
    assert card.completed_mass > 0 and card.metrics.n_slots == T


@pytest.mark.parametrize("integral,jitter", [(False, 0.0), (True, 0.5)])
@pytest.mark.parametrize("scheduler", ["potus", "potus-loop", "shuffle", "jsq"])
def test_event_sim_card_equals_cpu(cuda_device, scheduler, integral, jitter):
    import repro_torch.core as pt

    T = chip_smoke.ORACLE_T
    topo, net, placement, arr = chip_smoke.dyadic_system(pt, T + 13, 2)
    arr = 2 * arr  # whole tuples for integral service
    cfg = pt.SimConfig(V=2.0, beta=0.5, window=2, scheduler=scheduler)
    kw = dict(integral=integral, jitter=jitter, seed=7)
    card, n = chip_smoke.counted(lambda: pt.run_event_sim(topo, net, placement, arr, T, cfg,
                                                          device="cuda", **kw))
    assert n == chip_smoke.oracle_launches(scheduler, T)
    assert chip_smoke.same_events(card, pt.run_event_sim(topo, net, placement, arr, T, cfg,
                                                         device="cpu", **kw))
    if not integral:  # fluid and aligned: the scan engine's series, bitwise
        scan = pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                         T=T, engine="jax", scheduler=scheduler, V=2.0,
                                         beta=0.5, window=2, device="cuda"))
        for name in chip_smoke.SERIES:
            np.testing.assert_array_equal(getattr(card, name),
                                          np.asarray(getattr(scan, name), np.float64))


@pytest.mark.parametrize("router,calls", [("topk", 1), ("potus", 4)])
@pytest.mark.parametrize("n_tokens", [4, 64])
def test_moe_ffn_card_equals_cpu(cuda_device, n_tokens, router, calls):
    from repro_torch.configs import get_config

    cfg = get_config("granite_moe_1b").reduced().with_(n_experts=8, top_k=4,
                                                       capacity_factor=1.0)
    worst, *_ = chip_smoke.moe_card_vs_cpu(cfg, n_tokens, router, calls, cuda_device)
    assert worst <= 1e-5


def _scale_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()),
                                                                 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 14, 2, 300, 64), (2, 16, 16, 200, 80),
                                          (1, 8, 2, 129, 128), (1, 4, 1, 33, 256),
                                          (1, 6, 3, 64, 48)])
def test_flash_attention_bwd_kernel_matches_plain_version(cuda_device, B, Hq, Hkv, S, D,
                                                          causal, dtype):
    """The backward kernel's dq, dk, dv against the autograd gradient of the
    plain version, within 2e-5 (float32) / 2e-2 (bfloat16) of each
    gradient's scale, at internvl2-1b's (14/2 heads of 64) and
    hubert-xlarge's (16/16 of 80) widths, GQA, head_dim up to 256 and S no
    multiple of a tile; two runs bitwise (no atomics). bf16 at head_dim 64,
    80 and 128 takes the tensor-core route, float32 and head_dims 48 and 256
    the SIMT route, as the route counters show."""
    from repro_torch.kernels import flash_attention as kf

    rng = np.random.default_rng(S + D)
    q, k, v = (_randn(rng, (B, h, S, D), dtype, cuda_device) for h in (Hq, Hkv, Hkv))
    dout = _randn(rng, (B, Hq, S, D), dtype, cuda_device)
    for c in (kf.launches_bwd, kf.launches_bwd_tc, kf.launches_bwd_simt):
        c.reset()
    got = kf.flash_attention_bwd_call(q, k, v, dout, causal)
    again = kf.flash_attention_bwd_call(q, k, v, dout, causal)
    want = kf.flash_attention_bwd_plain(q, k, v, dout, causal)
    torch.cuda.synchronize()
    tc = dtype == "bfloat16" and D in (64, 80, 128)
    assert kf.bwd_route(q.dtype, D) == ("tc" if tc else "simt")
    assert (kf.launches_bwd.n, kf.launches_bwd_tc.n, kf.launches_bwd_simt.n) == \
        ((2, 2, 0) if tc else (2, 0, 2))
    for name, g, a, w, x in zip("qkv", got, again, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert _scale_gap(g, w) <= ATT_TOL[dtype], name
        assert torch.equal(g, a), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 14, 2, 300, 64), (2, 16, 16, 200, 80),
                                          (1, 8, 2, 129, 128), (1, 7, 1, 65, 64)])
def test_flash_attention_bwd_tc_kernel_matches_its_statement(cuda_device, B, Hq, Hkv, S, D,
                                                             causal):
    """The tensor-core route against ``flash_attention_bwd_tc_plain`` (its
    arithmetic in plain PyTorch, held against the reference's jax.grad on
    the CPU by tests/test_torch_flash_bwd_design.py) on the same card
    inputs, within 1e-2 of each gradient's scale: both round P and dS to
    bf16 as operands and the gradients to bf16 at the end, so they part
    only where float32 sums in another order (and exp2 for exp) flip a
    rounding; one bf16 ulp of the largest element is at most 2^-7 of the
    scale."""
    from repro_torch.kernels import flash_attention as kf

    rng = np.random.default_rng(S + D + 1)
    q, k, v = (_randn(rng, (B, h, S, D), "bfloat16", cuda_device) for h in (Hq, Hkv, Hkv))
    dout = _randn(rng, (B, Hq, S, D), "bfloat16", cuda_device)
    kf.launches_bwd_tc.reset()
    got = kf.flash_attention_bwd_call(q, k, v, dout, causal)
    want = kf.flash_attention_bwd_tc_plain(q, k, v, dout, causal)
    torch.cuda.synchronize()
    assert kf.launches_bwd_tc.n == 1
    for name, g, w in zip("qkv", got, want):
        assert _scale_gap(g, w) <= 1e-2, name


def test_flash_attention_bwd_tc_kernel_raises_on_misaligned_strides(cuda_device):
    """The tensor-core route needs every pointer and row stride 16-byte
    aligned, dout's too: a view 2 bytes off a 16-byte boundary, or a row
    stride of 66 elements, raises before any launch; the SIMT route (f32)
    takes the same views."""
    from repro_torch.kernels import flash_attention as kf

    kv = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    wide = torch.zeros((1, 4, 8, 72), dtype=torch.bfloat16, device=cuda_device)
    rows66 = torch.zeros((1, 4, 8, 66), dtype=torch.bfloat16, device=cuda_device)[..., :64]
    kf.launches_bwd.reset()
    for bad in ({"q": wide[..., 1:65]}, {"dout": wide[..., 1:65]}, {"dout": rows66}):
        args = dict(q=q, k=kv, v=kv, dout=q) | bad
        with pytest.raises(ValueError, match="aligned"):
            kf.flash_attention_bwd_call(args["q"], args["k"], args["v"], args["dout"])
    assert kf.launches_bwd.n == 0
    dq, dk, dv = kf.flash_attention_bwd_call(q.float(), kv.float(), kv.float(),
                                             rows66.float())
    torch.cuda.synchronize()
    assert kf.launches_bwd.n == 1 and dq.shape == q.shape


def test_flash_attention_gradients_flow_through_the_kernels(cuda_device):
    """``kernels.ops.flash_attention`` on CUDA tensors that require grad: the
    output has a ``grad_fn``, the backward launches the backward kernel once
    and no plain version, and q, k, v (strided views of the model's layout)
    get the plain version's gradients."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops

    rng = np.random.default_rng(1)
    for dtype in ("float32", "bfloat16"):
        q, k, v = (_randn(rng, (2, 100, h, 64), dtype, cuda_device).requires_grad_(True)
                   for h in (6, 2, 2))
        dout = _randn(rng, (2, 100, 6, 64), dtype, cuda_device)
        kf.launches.reset()
        kf.launches_bwd.reset()
        out = ops.flash_attention(q, k, v, causal=True)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, (q, k, v), dout)
        assert (kf.launches.n, kf.launches_bwd.n) == (1, 1)
        want = torch.autograd.grad(ops.plain.flash_attention(q, k, v, causal=True), (q, k, v),
                                   dout)
        for g, w in zip(got, want):
            assert _scale_gap(g, w) <= ATT_TOL[dtype]


def test_ssd_intra_chunk_raises_when_a_cuda_input_requires_grad(cuda_device):
    """No SSD backward kernel yet: the wrapper raises rather than return an
    output without a ``grad_fn``; without grad it runs."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    b, nc, Q, H, P, S = 1, 2, 16, 2, 16, 8
    xc = _randn(rng, (b, nc, Q, H, P), "float32", cuda_device).requires_grad_(True)
    dtc = _randn(rng, (b, nc, Q, H), "float32", cuda_device).abs()
    dA = -torch.cumsum(dtc, dim=2)
    Bc, Cc = (_randn(rng, (b, nc, Q, S), "float32", cuda_device) for _ in range(2))
    with pytest.raises(NotImplementedError, match="item 7"):
        ops.ssd_intra_chunk(xc, dtc, dA, Bc, Cc)
    with torch.no_grad():
        y, states = ops.ssd_intra_chunk(xc, dtc, dA, Bc, Cc)
    assert y.shape == xc.shape and states.shape == (b, nc, H, P, S)


@pytest.mark.parametrize("arch", ["internvl2_1b", "hubert_xlarge", "granite_moe_1b"])
def test_train_step_kernel_route_matches_plain_route(cuda_device, arch):
    """One reduced float32 train step's loss and gradients on the card, the
    kernel route (flash attention and its backward kernel) against the
    plain route, within 1e-4 of each gradient's scale; both kernels launch
    once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.data.specs import make_batch
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.training import train_loop as ptl

    cfg = get_config(arch).reduced()
    gen = torch.Generator(cuda_device).manual_seed(0)
    state = ptl.init_train_state(cfg, ptl.TrainConfig(), gen, cuda_device)
    model = state["params"]
    batch = make_batch(np.random.default_rng(0), cfg, 2, 40, device=cuda_device)
    grads = {}
    for route in (ops, ops.plain):
        kf.launches.reset()
        kf.launches_bwd.reset()
        loss, _ = ptl.make_loss_fn(cfg, ptl.TrainConfig(), ops=route)(model, batch,
                                                                      state["router_state"])
        grads[route is ops] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
        counts = (kf.launches.n, kf.launches_bwd.n)
        assert counts == ((cfg.n_layers, cfg.n_layers) if route is ops else (0, 0))
    (lk, gk), (lp, gp) = grads[True], grads[False]
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk, gp):
        assert _scale_gap(a, b) <= 1e-4


@pytest.mark.parametrize("router", ["topk", "potus"])
def test_moe_train_step_card_equals_cpu(cuda_device, router):
    """A reduced float32 MoE train step (granite-moe-1b's reduction with 8
    experts, capacity factor 0.5: drops) on the card against the same step on
    the CPU from the same weights and router state: each MoE layer's
    selections, keep mask, load and ``dropped_frac`` equal in the forward,
    the loss and grad norm within rel 1e-5 and the router state equal after
    the step."""
    from repro_torch.configs import get_config
    from repro_torch.data.specs import make_batch
    from repro_torch.models import model_zoo as pz
    from repro_torch.training import train_loop as ptl
    from repro_torch.training.optimizer import OptConfig

    cfg = get_config("granite_moe_1b").reduced().with_(n_experts=8, capacity_factor=0.5,
                                                       router=router)
    tcfg = ptl.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    cpu = torch.device("cpu")
    weights = ptl.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), cpu)
    weights = {n: p.detach() for n, p in weights["params"].named_parameters()}
    batch = make_batch(np.random.default_rng(0), cfg, 4, 64, device=cpu)
    runs = {}
    for device in (cpu, cuda_device):
        gen = torch.Generator(device).manual_seed(1)
        state = ptl.init_train_state(cfg, tcfg, gen, device)
        state["params"].load_state_dict(weights)
        state["router_state"] = torch.arange(8, dtype=torch.float32, device=device) * 0.5
        on = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            _, aux = pz.forward(state["params"], cfg, on, state["router_state"])
        layers = [{k: a[k].cpu() for k in ("top_i", "keep", "load", "dropped_frac")}
                  for a in aux["moe_layers"]]
        state, met = ptl.make_train_step(cfg, tcfg)(state, on)
        runs[device.type] = (layers, {k: float(v) for k, v in met.items()},
                             state["router_state"].cpu())
    (lc, mc, rc), (lg, mg, rg) = runs["cpu"], runs["cuda"]
    assert any(float(layer["dropped_frac"]) > 0 for layer in lc)
    for a, b in zip(lg, lc):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for key in ("loss", "grad_norm", "moe_aux"):
        assert abs(mg[key] - mc[key]) <= 1e-5 * abs(mc[key]), key
    assert torch.equal(rg, rc)


def _one_by_one_and_meshless(cfg, batch, device):
    """Two train steps of ``cfg`` on the card under a 1x1 model mesh, the
    moments cut by ``train_state_shardings`` (ZeRO-1) and the gradients by
    ``grad_specs``, and without a mesh: each run's state (flattened) and
    last metrics."""
    from repro_torch.distributed import set_mesh
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as pz
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl
    from repro_torch.training.optimizer import OptConfig

    tcfg = ptl.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))

    def run(mesh):
        set_mesh(mesh)
        try:
            gen = torch.Generator(device).manual_seed(0)
            state = ptl.init_train_state(cfg, tcfg, gen, device)
            specs = None
            if mesh is not None:
                ptl.shard_train_state(state, shd.train_state_shardings(cfg, mesh, tcfg))
                specs = shd.specs_for_template(pz.template(cfg), shd.zero_rules(mesh), mesh)
            step = ptl.make_train_step(cfg, tcfg, specs)
            for _ in range(2):
                state, met = step(state, batch)
        finally:
            set_mesh(None)
        return ck.flatten_state(state), met

    return run(None), run(make_host_mesh(1, 1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_on_a_one_by_one_mesh_is_the_meshless_step_bitwise(cuda_device, dtype):
    """Two reduced internvl2-1b train steps on the card under a 1x1 model
    mesh, the moments cut by ``train_state_shardings`` (ZeRO-1) and the
    gradients by ``grad_specs``, equal the steps without a mesh bitwise:
    parameters, moments and metrics."""
    from repro_torch.configs import get_config
    from repro_torch.data.specs import make_batch

    cfg = get_config("internvl2_1b").reduced().with_(param_dtype=dtype, compute_dtype=dtype)
    batch = make_batch(np.random.default_rng(0), cfg, 4, 64, device=cuda_device)
    (a, ma), (b, mb) = _one_by_one_and_meshless(cfg, batch, cuda_device)
    assert list(a) == list(b)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_dense_decoder_step_on_a_one_by_one_mesh_is_the_meshless_step_bitwise(cuda_device):
    """The tensor-parallel train step's route with a "model" axis of one
    rank: two reduced stablelm-3b (float32) steps on the card under a 1x1
    mesh equal the meshless steps bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.data.specs import make_batch

    cfg = get_config("stablelm_3b").reduced()
    batch = make_batch(np.random.default_rng(0), cfg, 4, 64, device=cuda_device)
    (a, ma), (b, mb) = _one_by_one_and_meshless(cfg, batch, cuda_device)
    assert list(a) == list(b)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def _tp_step_against_one_rank(arch, mesh):
    """One reduced (float32) step of ``arch`` on a ``mesh`` of gloo ranks
    sharing the card (kernels 5 and 5b on each rank's heads) against the
    one-rank step on the card, on a batch whose patch positions' labels are
    -1: loss and grad norm within rel 1e-5, the token count the one rank's,
    every rank's metrics the same."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import spawn_world
    from repro_torch.training import train_loop as ptl
    from repro_torch.training.optimizer import OptConfig

    sys.path.insert(0, str(Path(chip_smoke.__file__).parent / "examples"))
    import torch_train_dp as ex

    cfg = get_config(arch).reduced()
    tcfg = ptl.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    batch = TokenPipeline(cfg, batch=4, seq=64, seed=0).next_batch()
    if "patches" in batch:
        batch["labels"][:, :batch["patches"].shape[1]] = -1
    one = ex.train_rank(cfg, tcfg, None, None, [batch], device="cuda", keep_state=False)
    outs = spawn_world(ex.train_rank, mesh[0] * mesh[1], "gloo", 240,
                       (cfg, tcfg, mesh, None, [batch]))
    want = one["metrics"][0]
    for out in outs:
        assert out["metrics"] == outs[0]["metrics"]
        assert out["tags"][0]["tp"] > 0
        assert out["metrics"][0]["ntok"] == want["ntok"]
        for key in ("loss", "grad_norm"):
            got = out["metrics"][0][key]
            assert abs(got - want[key]) <= 1e-5 * abs(want[key]), (key, got, want[key])


def test_tensor_parallel_step_on_two_gloo_ranks_on_the_card(cuda_device):
    """A reduced stablelm-3b step on a (1, 2) mesh (each rank 2 of the 4
    heads, half of d_ff and of the vocabulary) against the one-rank step
    (:func:`_tp_step_against_one_rank`)."""
    _tp_step_against_one_rank("stablelm_3b", (1, 2))


@pytest.mark.parametrize("arch,mesh", [("internvl2_1b", (1, 2)), ("hubert_xlarge", (1, 4))])
def test_frontend_tensor_parallel_step_on_gloo_ranks_on_the_card(cuda_device, arch, mesh):
    """A reduced ``vision_stub`` config's step (internvl2-1b on (1, 2): 2 of
    the 4 heads and 1 of the 2 kv heads a rank, the patches whole on both,
    their labels -1) and an encoder's (hubert-xlarge on (1, 4): 1 head a
    rank, bidirectional, the gelu MLP and the head cut) against the
    one-rank step (:func:`_tp_step_against_one_rank`)."""
    _tp_step_against_one_rank(arch, mesh)


def test_sharded_one_nccl_rank_takes_the_kernel_route(cuda_device):
    """``sharded=True`` with ``use_pallas`` on a one-rank NCCL world: the slot
    kernel once a slot (the kernel route), bitwise the dense port on the
    card, on the I=16 dyadic system."""
    import dataclasses

    import repro_torch.core as pt
    from repro_torch.distributed import spawn_world

    spec = dict(chip_smoke.sharded_cases(pt, "cuda"))["use_pallas"]
    (out,) = spawn_world(chip_smoke.n2_rank, 1, "nccl", 120, ([], spec))
    dense = pt.simulate(dataclasses.replace(spec, sharded=False))
    assert out["stats"]["routes"] == {"kernel": 1}
    assert out["stats"]["launches"]["potus_slot"] == chip_smoke.SHARD_T
    assert chip_smoke.same_result(out["fleet"], dense)


def test_sharded_four_gloo_ranks_on_the_card_equal_the_cpu_port(cuda_device):
    """Four gloo ranks sharing the card: every dyadic case of
    ``chip_smoke.sharded_cases`` equals the dense port on the CPU bitwise on
    every rank, on the compact route (no slot-kernel launch)."""
    import dataclasses

    import repro_torch.core as pt
    from repro_torch.distributed import spawn_world

    cases = chip_smoke.sharded_cases(pt, "cuda")
    outs = spawn_world(chip_smoke.n2_rank, 4, "gloo", 240, (cases, cases[0][1]))
    for name, spec in cases:
        want = pt.simulate(dataclasses.replace(chip_smoke.dense_twin(spec), device="cpu"))
        for out in outs:
            for f in ("backlog", "comm_cost"):
                assert np.array_equal(getattr(out[name], f), getattr(want, f)), (name, f)
    assert all(out["stats"]["routes"] == {"compact": 1} for out in outs)
    assert all(out["stats"]["launches"]["potus_slot"] == 0 for out in outs)
