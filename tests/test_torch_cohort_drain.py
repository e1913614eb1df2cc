"""The plain version of the port's drain-and-split kernel
(``repro_torch.kernels.cohort_drain.cohort_drain_split_plain``) against the
reference's Pallas kernel in interpret mode
(``repro.kernels.ops.cohort_drain_split``) and against the formula of
``tests/test_cohort_fused.py::TestPallasDrain::test_kernel_matches_xla_reference``.

* Random uniform inputs, components assigned at random (not contiguous), on
  the reference test's shapes (I=24, C=5, Atot=13, age_bucket=8) and three
  more: ``rtol/atol 1e-5``. The two sum the products over the sources in
  another order (the Pallas kernel over all C planes, in tiles of eight
  sources; the plain version in one f32 matrix product), so they agree to
  rounding, not bitwise.
* A dyadic draw — integer ``src`` and ``ship``, ``ratio`` in {0, 1/4, 1/2,
  1} — makes every product and every partial sum exact in f32, so the two
  must agree bitwise.
* Routing: the CUDA wrapper raises on CPU tensors; ``kernels.ops`` sends CPU
  tensors to the plain version, and ``ops.plain`` names it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import cohort_drain_split as ref_drain_split
from repro_torch.kernels import cohort_drain as pdrain
from repro_torch.kernels import ops as pkops

# the tensors here are tiny: intra-op threads would only contend with the
# other pytest-xdist workers
torch.set_num_threads(1)

SHAPES = [(24, 5, 13, 8), (40, 3, 21, 16), (64, 7, 9, 0), (17, 1, 6, 5)]


def _random(seed, I, C, Atot):
    """The draw of tests/test_cohort_fused.py:407-411."""
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    src = (rng.uniform(0, 4, (I, C, Atot + 1))
           * (rng.random((I, C, Atot + 1)) < 0.4)).astype(np.float32)
    ship = rng.uniform(0, 10, (I, C)).astype(np.float32)
    ratio = (rng.uniform(0, 1, (I, I)) * (rng.random((I, I)) < 0.3)).astype(np.float32)
    return src, ship, ratio, comp


def _dyadic(seed, I, C, Atot):
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    src = (rng.integers(0, 5, (I, C, Atot + 1))
           * (rng.random((I, C, Atot + 1)) < 0.5)).astype(np.float32)
    ship = rng.integers(0, 12, (I, C)).astype(np.float32)
    ratio = rng.choice(np.array([0.0, 0.25, 0.5, 1.0], np.float32), (I, I))
    return src, ship, ratio, comp


def _formula(src, ship, ratio, comp, age_bucket):
    I, C, Aext = src.shape
    cum = np.cumsum(src, -1)
    drained = np.clip(ship[:, :, None] - (cum - src), 0.0, src)
    dl = drained[:, :, :Aext - 1].copy()
    dl[:, :, age_bucket] += drained[:, :, Aext - 1]
    return np.einsum("ij,icb->jcb", ratio, dl)[np.arange(I), comp, :]


def _both(inputs, age_bucket):
    src, ship, ratio, comp = inputs
    want = np.asarray(ref_drain_split(jnp.asarray(src), jnp.asarray(ship), jnp.asarray(ratio),
                                      jnp.asarray(comp), age_bucket))
    got = pdrain.cohort_drain_split_plain(*(torch.as_tensor(x) for x in inputs), age_bucket)
    return got.numpy(), want


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference_kernel_on_random_inputs(shape):
    I, C, Atot, age_bucket = shape
    inputs = _random(0, I, C, Atot)
    got, want = _both(inputs, age_bucket)
    assert got.shape == (I, Atot) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _formula(*inputs, age_bucket), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference_kernel_bitwise_on_dyadic_inputs(shape):
    I, C, Atot, age_bucket = shape
    inputs = _dyadic(1, I, C, Atot)
    got, want = _both(inputs, age_bucket)
    assert np.count_nonzero(got) > 0  # something landed: the check is not vacuous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _formula(*inputs, age_bucket).astype(np.float32))


def test_routing_on_the_cpu():
    inputs = tuple(torch.as_tensor(x) for x in _random(0, 24, 5, 13))
    with pytest.raises(ValueError, match="CUDA kernel"):
        pdrain.cohort_drain_call(*inputs, 8)
    pdrain.launches.reset()
    got = pkops.cohort_drain_split(*inputs, 8)
    assert pdrain.launches.n == 0
    torch.testing.assert_close(got, pdrain.cohort_drain_split_plain(*inputs, 8), rtol=0, atol=0)
    assert pkops.plain.cohort_drain_split is pdrain.cohort_drain_split_plain
