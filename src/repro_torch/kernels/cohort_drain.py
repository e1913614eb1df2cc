"""The fused cohort engine's drain and split as a hand-written CUDA kernel for
Hopper (``csrc/cohort_drain.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/cohort_drain.py:38``
(``cohort_drain_kernel``): the oldest-first drain ``clip(ship - (cum - src),
0, src)`` of each (source, component) age buffer, the fold of the trailing
admission slot into bucket ``age_bucket``, and the landing buckets

    land[j, b] = sum_i ratio[i, j] * drained[i, comp(j), b].

The Pallas kernel contracts each source stripe against all C component
planes on the MXU and keeps one plane per target with a one-hot product; the
CUDA version reads only the plane ``comp(j)`` of each target column, in two
phases (the source's header describes them). It is bound by the one read of
the (I, I) ``ratio`` matrix and by the own-plane products of its nonzero
entries. No float is accumulated with an atomic: each landing bucket sums
its sources in ascending order, so two runs are bitwise identical and, on
exact (dyadic) inputs, equal the plain version.

:func:`cohort_drain_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. :func:`cohort_drain_split_plain` is the
plain PyTorch version; ``kernels.ops.cohort_drain_split`` takes it for CPU
tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import LaunchCounter

__all__ = ["cohort_drain_call", "cohort_drain_split_plain", "launches"]

#: launches of the CUDA drain kernel (one per :func:`cohort_drain_call`)
launches = LaunchCounter()

_P = ctypes.c_void_p


def _library():
    from ._build import load

    lib = load("cohort_drain")
    lib.cohort_drain_run.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _P]
    lib.cohort_drain_run.restype = ctypes.c_int
    return lib


def _check(src_ext, shipped, ratio, inst_comp, age_bucket: int) -> tuple[int, int, int]:
    """Device, type, shape and contiguity checks; returns ``(I, C, Atot)``."""
    if src_ext.dim() != 3 or src_ext.shape[2] < 2:
        raise ValueError(f"cohort_drain_call: src_ext must be (I, C, Atot + 1), got "
                         f"{tuple(src_ext.shape)}")
    I, C, Aext = src_ext.shape
    Atot = Aext - 1
    want = {"src_ext": (src_ext, (I, C, Aext), torch.float32),
            "shipped": (shipped, (I, C), torch.float32),
            "ratio": (ratio, (I, I), torch.float32),
            "inst_comp": (inst_comp, (I,), torch.int32)}
    for arg, (x, shape, dtype) in want.items():
        if x.device.type != "cuda" or x.device != src_ext.device:
            raise ValueError(f"cohort_drain_call launches a CUDA kernel; {arg} is on {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"cohort_drain_call: {arg} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"cohort_drain_call: {arg} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"cohort_drain_call: {arg} is not contiguous")
    if not 0 <= age_bucket < Atot:
        raise ValueError(f"cohort_drain_call: age_bucket {age_bucket} outside [0, {Atot})")
    return I, C, Atot


def cohort_drain_call(src_ext, shipped, ratio, inst_comp, age_bucket: int):
    """Landing buckets ``land`` (I, Atot) of one slot, computed by the CUDA
    kernel on CUDA tensors: ``src_ext`` (I, C, Atot + 1) the component-dense
    drain buffers, ``shipped`` (I, C) the amounts to drain, ``ratio`` (I, I)
    the split fractions, ``inst_comp`` (I,) int32 the component of each
    target column. Raises on CPU tensors, on a type, shape or layout the
    kernel does not take, and on a failed build or launch."""
    age_bucket = int(age_bucket)
    I, C, Atot = _check(src_ext, shipped, ratio, inst_comp, age_bucket)
    lib = _library()
    dev = src_ext.device
    land_src = torch.empty((I, C, Atot), dtype=torch.float32, device=dev)
    land = torch.empty((I, Atot), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cohort_drain_run(src_ext.data_ptr(), shipped.data_ptr(), ratio.data_ptr(),
                               inst_comp.data_ptr(), land_src.data_ptr(), land.data_ptr(),
                               I, C, Atot, age_bucket, stream)
    if err != 0:
        raise RuntimeError(f"cohort drain kernel failed: CUDA error {err}")
    launches.n += 1
    return land


def cohort_drain_split_plain(src_ext, shipped, ratio, inst_comp, age_bucket: int):
    """The plain PyTorch version, on any device: the drain, the fold, then
    one product over all component planes, of which each target keeps its
    own. The (I, I, Atot) gather of each target's plane is never formed."""
    from ..core.compact import drain_ages

    I, C, Aext = src_ext.shape
    Atot = Aext - 1
    drained = drain_ages(src_ext, shipped)
    land_src = drained[:, :, :Atot].clone()
    land_src[:, :, age_bucket] += drained[:, :, Atot]
    full = (ratio.T @ land_src.reshape(I, C * Atot)).reshape(I, C, Atot)
    return full[torch.arange(I, device=src_ext.device), inst_comp.long()]
