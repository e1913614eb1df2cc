"""The POTUS price matrix (eq. 16) as a hand-written CUDA kernel for Hopper
(``csrc/potus_price.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/potus_price.py:26``
(``potus_price_kernel``), which builds the two gathers ``U[k(i), k(j)]`` and
``q_out[i, comp(j)]`` as one-hot matmuls for the MXU (DESIGN.md §4). The
CUDA version reads both directly: one thread per output element,
neighbouring threads on neighbouring columns. It is bound by bytes — the
(I, I) bool mask in and the (I, I) f32 prices out — at five operations per
element. It computes ``(V*u + q_in) - beta*q_out`` in the plain version's
order and is built with ``--fmad=false``, so the two agree bitwise.

:func:`potus_price_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. :func:`potus_price_plain` is the plain
PyTorch version; ``kernels.ops.potus_price`` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import LaunchCounter

__all__ = ["potus_price_call", "potus_price_plain", "launches", "check_problem"]

#: launches of the CUDA price kernel (one per :func:`potus_price_call`)
launches = LaunchCounter()

_P = ctypes.c_void_p


def _library():
    from ._build import load

    lib = load("potus_price")
    lib.potus_price_run.argtypes = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_float, ctypes.c_float, _P]
    lib.potus_price_run.restype = ctypes.c_int
    return lib


def check_problem(name: str, U, q_in, q_out, inst_container, inst_comp, edge_mask,
                  gamma=None) -> tuple[int, int, int]:
    """Device, type, shape and contiguity checks shared by the price and the
    schedule kernel; returns ``(I, K, C)``."""
    I, K, C = q_in.shape[0], U.shape[0], q_out.shape[1]
    want = {"U": (U, (K, K), torch.float32), "q_in": (q_in, (I,), torch.float32),
            "q_out": (q_out, (I, C), torch.float32),
            "inst_container": (inst_container, (I,), torch.int32),
            "inst_comp": (inst_comp, (I,), torch.int32),
            "edge_mask": (edge_mask, (I, I), torch.bool)}
    if gamma is not None:
        want["gamma"] = (gamma, (I,), torch.float32)
    for arg, (x, shape, dtype) in want.items():
        if x.device.type != "cuda" or x.device != q_in.device:
            raise ValueError(f"{name} launches a CUDA kernel; {arg} is on {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return I, K, C


def potus_price_call(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta):
    """(I, I) price matrix of eq. 16, +inf off the DAG edges, computed by the
    CUDA kernel on CUDA tensors. Raises on CPU tensors, on a type, shape or
    layout the kernel does not take, and on a failed build or launch."""
    I, K, C = check_problem("potus_price_call", U, q_in, q_out, inst_container, inst_comp,
                            edge_mask)
    lib = _library()
    out = torch.empty((I, I), dtype=torch.float32, device=q_in.device)
    stream = torch.cuda.current_stream(q_in.device).cuda_stream
    err = lib.potus_price_run(U.data_ptr(), q_in.data_ptr(), q_out.data_ptr(),
                              inst_container.data_ptr(), inst_comp.data_ptr(),
                              edge_mask.data_ptr(), out.data_ptr(), I, K, C, float(V),
                              float(beta), stream)
    if err != 0:
        raise RuntimeError(f"potus price kernel failed: CUDA error {err}")
    launches.n += 1
    return out


def potus_price_plain(U, q_in, q_out, inst_container, inst_comp, edge_mask, V, beta):
    """The plain PyTorch version, on any device."""
    from ..core.potus import _price_rows, _u_pair

    return _price_rows(_u_pair(U, inst_container), q_in, q_out, inst_comp, edge_mask, V, beta)
