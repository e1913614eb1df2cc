"""The fused POTUS schedule — prices and the per-row water-fill in one kernel —
as hand-written CUDA for Hopper (``csrc/potus_schedule.cu``), and its plain
version.

Replaces the TPU kernel ``src/repro/kernels/potus_schedule.py:35``
(``potus_schedule_kernel``): the greedy allocation X (I, I) of Algorithm 1
lines 9-14 without the mandatory dispatch, with the (I, I) price matrix kept
out of device memory (DESIGN.md §7). One warp per source row streams the
row's columns, folds a (min price, lowest column) pair per component, one
lane water-fills ``gamma_i`` in ascending ``(price, column)`` order with
sequential prefix sums, and the warp writes the row. It is bound by bytes:
the (I, I) bool mask in and X out.

The plain version is ``potus_prices`` followed by the sort water-fill
(``core.potus._allocate_rows(method="sort")``). The kernel computes each
price in the same operation order and folds with exact comparisons, so the
two pick the same targets; the fills agree bitwise wherever the budget
prefix sums are exact (the dyadic and integral tiers) and to rounding
elsewhere (the plain ``cumsum`` may add in another order).

:func:`potus_schedule_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. ``kernels.ops.potus_schedule_alloc``
takes :func:`potus_schedule_alloc_plain` for CPU tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from .potus_price import check_problem
from ._build import LaunchCounter

__all__ = ["potus_schedule_call", "potus_schedule_alloc_plain", "launches", "MAXC"]

#: launches of the CUDA schedule kernel (one per :func:`potus_schedule_call`)
launches = LaunchCounter()

MAXC = 64  # SCHED_MAXC in the source

_P = ctypes.c_void_p


def _library():
    from ._build import load

    lib = load("potus_schedule")
    lib.potus_schedule_run.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                       ctypes.c_float, _P]
    lib.potus_schedule_run.restype = ctypes.c_int
    return lib


def potus_schedule_call(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma, V, beta):
    """Greedy allocation X (I, I) before the mandatory dispatch, computed by
    the CUDA kernel on CUDA tensors. Raises on CPU tensors, on a type, shape
    or layout the kernel does not take, above ``MAXC`` components, and on a
    failed build or launch."""
    I, K, C = check_problem("potus_schedule_call", U, q_in, q_out, inst_container, inst_comp,
                            edge_mask, gamma)
    if C > MAXC:
        raise ValueError(f"potus_schedule_call: at most {MAXC} components, got {C}")
    lib = _library()
    out = torch.empty((I, I), dtype=torch.float32, device=q_in.device)
    stream = torch.cuda.current_stream(q_in.device).cuda_stream
    err = lib.potus_schedule_run(U.data_ptr(), q_in.data_ptr(), q_out.data_ptr(),
                                 inst_container.data_ptr(), inst_comp.data_ptr(),
                                 edge_mask.data_ptr(), gamma.data_ptr(), out.data_ptr(), I, K,
                                 C, float(V), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"potus schedule kernel failed: CUDA error {err}")
    launches.n += 1
    return out


def potus_schedule_alloc_plain(U, q_in, q_out, inst_container, inst_comp, edge_mask, gamma,
                               V, beta):
    """The plain PyTorch version, on any device."""
    from ..core.potus import _allocate_rows, _price_rows, _u_pair

    l = _price_rows(_u_pair(U, inst_container), q_in, q_out, inst_comp, edge_mask, V, beta)
    return _allocate_rows(l, q_out, gamma, inst_comp, q_out.shape[1], 0, "sort")
