"""The drain kernel's decomposition (``csrc/cohort_drain.cu``), stated in plain
PyTorch on the CPU and held against the reference's Pallas kernel in
interpret mode (``repro.kernels.cohort_drain.cohort_drain_call``) and the
port's plain version (``cohort_drain_split_plain``).

:func:`design_drain` computes the landing buckets the way the CUDA kernel
does, with its fixed orders written out:

* phase A: each (source, component) row drained oldest-first through
  inclusive Kogge-Stone scans across the buckets, 32 at a time, plus the
  carry of the rounds before (the slot kernel's scan, ``lane_scan``); the
  clip in the plain version's order; the admission slot added to bucket
  ``age_bucket``;
* phase B: the sources cut into chunks by ``drain_plan``; in each chunk,
  each target column adds the products of its nonzero ratios in ascending
  source order (the kernel's queue of nonzeros, in ascending row and then
  column order), the zero ratios skipped;
* the merge: the chunks' partial sums added in ascending chunk order; NaN
  where a target's component is out of range.

On dyadic inputs (integer masses, ratios in {0, 1/4, 1/2, 1}) every product
and partial sum is exact, so the design, the reference kernel and the plain
version agree bitwise; on uniform random inputs they sum in other orders
and agree within rtol/atol 1e-5. Each is held with the draw's own ratio
(30% dense for the uniform draw), an all-zero ratio and a ratio whose only
nonzeros are in the last source row, on the shapes of
``tests/test_torch_cohort_drain.py`` plus I = 130, which is no multiple of
a column strip (32) or of a chunk (64 rows, three chunks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cohort_drain import cohort_drain_call as ref_drain_call
from repro_torch.kernels import cohort_drain as kd
from test_torch_cohort_drain import SHAPES, _dyadic, _random
from test_torch_slot_design import lane_scan

torch.set_num_threads(1)

DESIGN_SHAPES = SHAPES + [(130, 6, 69, 64)]


def design_drain(src, ship, ratio, comp, age_bucket, plan=None):
    """The landing buckets (I, Atot) in the CUDA kernel's orders; ``plan``
    ``(rows_per_chunk, n_chunks)`` defaults to the wrapper's ``drain_plan``."""
    I, C, Aext = src.shape
    Atot = Aext - 1
    cum = lane_scan(src)
    drained = torch.minimum(torch.clamp_min(ship[..., None] - (cum - src), 0.0), src)
    land_src = drained[:, :, :Atot].clone()
    land_src[:, :, age_bucket] = drained[:, :, age_bucket] + drained[:, :, Atot]
    rows, n_chunks = kd.drain_plan(I) if plan is None else plan
    valid = (comp >= 0) & (comp < C)
    own = comp.long().clamp(0, C - 1)
    land = None
    for c in range(n_chunks):
        part = torch.zeros((I, Atot), dtype=src.dtype)
        for i in range(c * rows, min(I, (c + 1) * rows)):
            # the row's nonzeros go to distinct columns: one step of each column's sum
            js = torch.nonzero((ratio[i] != 0) & valid).flatten()
            part[js] = part[js] + ratio[i, js, None] * land_src[i, own[js]]
        land = part if land is None else land + part
    return torch.where(valid[:, None], land, torch.full_like(land, float("nan")))


def _inputs(kind, ratio_kind, shape, seed=0):
    I, C, Atot, _ = shape
    src, ship, ratio, comp = (_dyadic if kind == "dyadic" else _random)(seed, I, C, Atot)
    if ratio_kind == "zero":
        ratio = np.zeros_like(ratio)
    elif ratio_kind == "last_row":
        ratio[:-1] = 0.0
        ratio[-1] = np.where(ratio[-1] == 0, 0.5, ratio[-1])
    return src, ship, ratio, comp


def _reference(inputs, age_bucket):
    return np.asarray(ref_drain_call(*(jnp.asarray(x) for x in inputs), age_bucket,
                                     interpret=True))


@pytest.mark.parametrize("ratio_kind", ["draw", "zero", "last_row"])
@pytest.mark.parametrize("kind", ["dyadic", "uniform"])
@pytest.mark.parametrize("shape", DESIGN_SHAPES)
def test_design_matches_reference_kernel_and_plain_version(shape, kind, ratio_kind):
    I, C, Atot, age_bucket = shape
    inputs = _inputs(kind, ratio_kind, shape)
    tensors = tuple(torch.as_tensor(x) for x in inputs)
    got = design_drain(*tensors, age_bucket).numpy()
    want = _reference(inputs, age_bucket)
    plain = kd.cohort_drain_split_plain(*tensors, age_bucket).numpy()
    assert got.shape == (I, Atot) and got.dtype == np.float32
    if ratio_kind == "zero":
        assert not got.any()
    else:
        assert np.count_nonzero(got) > 0  # something landed: the check is not vacuous
    if kind == "dyadic" or ratio_kind == "zero":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan", [(32, 5), (64, 3), (96, 2), (160, 1)])
@pytest.mark.parametrize("kind", ["dyadic", "uniform"])
def test_chunk_merge_in_any_plan(plan, kind):
    """The chunk merge: any cut of the sources into chunks of whole load
    groups gives the reference's landing buckets, bitwise on dyadic inputs."""
    shape = (130, 6, 69, 64)
    inputs = _inputs(kind, "draw", shape, seed=3)
    got = design_drain(*(torch.as_tensor(x) for x in inputs), shape[3], plan=plan).numpy()
    want = _reference(inputs, shape[3])
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_buckets", [2, 14, 32, 33, 70, 130])
def test_rounds_of_32_scan_with_carry(n_buckets):
    """Phase A's scan against a running sum: bitwise on integers, within
    f32 rounding (1e-6 of the total) on uniform values."""
    rng = np.random.default_rng(n_buckets)
    ints = torch.as_tensor(rng.integers(0, 9, (40, n_buckets)).astype(np.float32))
    torch.testing.assert_close(lane_scan(ints), torch.cumsum(ints.double(), -1).float(),
                               rtol=0, atol=0)
    u = torch.as_tensor(rng.uniform(0, 4, (40, n_buckets)).astype(np.float32))
    want = torch.cumsum(u.double(), -1)
    assert float((lane_scan(u).double() - want).abs().max()) <= 1e-6 * float(want.max())


@pytest.mark.parametrize("I,want", [(1, (32, 1)), (24, (32, 1)), (64, (64, 1)), (130, (64, 3)),
                                    (300, (64, 5)), (1024, (64, 16)), (1025, (64, 17)),
                                    (16384, (4096, 4))])
def test_drain_plan(I, want):
    """Chunks of whole load groups, at least two groups each, that cover the
    sources once; about ``TARGET_WARPS`` warps of 32 columns where I allows."""
    rows, n = kd.drain_plan(I)
    assert (rows, n) == want
    assert rows % kd.GROUP_ROWS == 0 and (n - 1) * rows < I <= n * rows
    assert n == 1 or rows >= kd.MIN_CHUNK_ROWS
    assert -(-I // 32) * n <= 2 * kd.TARGET_WARPS


def test_out_of_range_component_gives_a_nan_row():
    shape = (130, 6, 69, 64)
    src, ship, ratio, comp = _inputs("dyadic", "draw", shape, seed=5)
    bad = np.array([0, 31, 32, 77, 129])
    comp_bad = comp.copy()
    comp_bad[bad] = np.array([-1, 6, 7, -5, 100], np.int32)
    tensors = tuple(torch.as_tensor(x) for x in (src, ship, ratio))
    got = design_drain(*tensors, torch.as_tensor(comp_bad), shape[3]).numpy()
    want = kd.cohort_drain_split_plain(*tensors, torch.as_tensor(comp), shape[3]).numpy()
    good = np.setdiff1d(np.arange(shape[0]), bad)
    assert np.isnan(got[bad]).all()
    np.testing.assert_array_equal(got[good], want[good])
