"""The fused cohort engine's drain and split as a hand-written CUDA kernel for
Hopper (``csrc/cohort_drain.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/cohort_drain.py:38``
(``cohort_drain_kernel``): the oldest-first drain ``clip(ship - (cum - src),
0, src)`` of each (source, component) age buffer, the fold of the trailing
admission slot into bucket ``age_bucket``, and the landing buckets

    land[j, b] = sum_i ratio[i, j] * drained[i, comp(j), b].

The Pallas kernel contracts each source stripe against all C component
planes on the MXU and keeps one plane per target with a one-hot product; the
CUDA version reads only the plane ``comp(j)`` of each target column (the
source's header describes its phases). It is bound by the one read of the
(I, I) ``ratio`` matrix: a warp streams a strip of 32 target columns over a
chunk of the sources, finds the few nonzero ratios by a warp vote and adds
their products into a landing tile in shared memory; a second pass adds the
chunks' tiles. :func:`drain_plan` cuts the sources into chunks. No float is
accumulated with an atomic: each landing bucket sums its chunk's nonzero
terms in ascending source order and then the chunks in ascending order, so
two runs are bitwise identical and, on exact (dyadic) inputs, equal the
plain version.

:func:`cohort_drain_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. :func:`cohort_drain_split_plain` is the
plain PyTorch version; ``kernels.ops.cohort_drain_split`` takes it for CPU
tensors only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import LaunchCounter

__all__ = ["cohort_drain_call", "cohort_drain_split_plain", "drain_plan", "launches"]

#: launches of the CUDA drain kernel (one per :func:`cohort_drain_call`)
launches = LaunchCounter()

_P = ctypes.c_void_p

#: source rows a warp reads per step (``DRAIN_GROUP`` in the source); a chunk is a multiple
GROUP_ROWS = 32
#: warps of the streaming pass the plan aims for: about 16 an SM of the H100's 132
TARGET_WARPS = 2048
#: source rows of a chunk, at least (two load groups)
MIN_CHUNK_ROWS = 64

#: the last call's plan: (device, stream, I, C, Atot) -> (rows_per_chunk, n_chunks, scratch)
_PLAN: dict = {}


def drain_plan(I: int) -> tuple[int, int]:
    """``(rows_per_chunk, n_chunks)``: the source rows cut into chunks, so
    that ``ceil(I / 32)`` column strips times the chunks give about
    ``TARGET_WARPS`` warps, each chunk at least ``MIN_CHUNK_ROWS`` rows and a
    multiple of ``GROUP_ROWS``. The landing buckets add the chunks' partial
    sums in ascending chunk order, so the plan fixes the order of the sums."""
    def cdiv(a, b):
        return -(-a // b)

    n = max(1, min(cdiv(TARGET_WARPS, cdiv(I, 32)), cdiv(I, MIN_CHUNK_ROWS)))
    rows = cdiv(cdiv(I, n), GROUP_ROWS) * GROUP_ROWS
    return rows, cdiv(I, rows)


def _plan(dev, stream: int, I: int, C: int, Atot: int):
    """``(rows_per_chunk, n_chunks, scratch)`` for these shapes: the scratch
    holds ``land_src`` (I, C, Atot), then the chunks' partial tiles
    (n_chunks, I, Atot). The last call's plan is kept, so a run of calls of
    one shape on one stream (the dense route's slots) allocates nothing but
    its outputs; work on one stream runs in order, so it may reuse the
    scratch."""
    key = (dev, stream, I, C, Atot)
    if key not in _PLAN:
        rows, n_chunks = drain_plan(I)
        n = I * C * Atot + (n_chunks * I * Atot if n_chunks > 1 else 0)
        _PLAN.clear()
        _PLAN[key] = (rows, n_chunks, torch.empty(n, dtype=torch.float32, device=dev))
    return _PLAN[key]


@functools.cache
def _library():
    from ._build import load

    lib = load("cohort_drain")
    lib.cohort_drain_run.argtypes = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, n_chunks, scratch = _plan(dev, stream, I, C, Atot)
    land = torch.empty((I, Atot), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    err = lib.cohort_drain_run(src_ext.data_ptr(), shipped.data_ptr(), ratio.data_ptr(),
                               inst_comp.data_ptr(), base, base + 4 * I * C * Atot,
                               land.data_ptr(), I, C, Atot, age_bucket, rows, n_chunks, stream)
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
