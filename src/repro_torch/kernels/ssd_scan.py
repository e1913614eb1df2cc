"""The Mamba2 SSD intra-chunk block — the diagonal (within-chunk) output and
each chunk's input state — as hand-written CUDA for Hopper
(``csrc/ssd_intra_chunk.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:23``
(``ssd_intra_chunk_kernel``). For every (batch, chunk, head), in float32:

  y_diag[q] = sum_{k <= q} (C_q . B_k) exp(dA_q - dA_k) dt_k x_k
  state     = sum_k x_k^T (B_k exp(dA_end - dA_k) dt_k)          (P, S)

C·Bᵀ is formed once per (batch, chunk) into a float32 scratch that the
heads read from L2. For bf16 inputs y_diag and the states run on the tensor
cores (``mma.sync``), with float32 operands split into bf16 terms: two for
y_diag's decay-weighted C·Bᵀ, three for x scaled by each key's weight in
the states (their limit is 1e-5 of scale); float32 inputs take the CUDA
cores. The decay is selected
before the exp (for k > q the exponent is positive and may overflow). Every
block owns its outputs and sums in one fixed order, with no atomics: two
runs are bitwise equal.

The plain version is ``src/repro/kernels/ref.py:49``
(``ssd_intra_chunk_reference``). Its einsums (``models.common.einsum``)
promote mixed operands to one type first, as ``jnp.einsum`` does
(``torch.einsum`` does not), so with the
model's bf16 activations and float32 ``dA_cum`` it returns y_diag in
float32, while the kernel returns it in ``xc``'s type, as the TPU kernel
does. The two agree within 1e-5 of the tensor's scale in float32 and 1e-2
in bfloat16 (``tests/test_kernels.py:98-108``); the states within 1e-5 in
both.

:func:`ssd_intra_chunk_call` launches the kernel on CUDA tensors and raises
on anything else; there is no fallback. ``kernels.ops.ssd_intra_chunk``
takes :func:`ssd_intra_chunk_plain` for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import torch

from ._build import LaunchCounter

__all__ = ["ssd_intra_chunk_call", "ssd_intra_chunk_plain", "launches"]

#: launches of the CUDA kernels (one per :func:`ssd_intra_chunk_call`)
launches = LaunchCounter()

_P = ctypes.c_void_p
_DTYPES = (torch.float32, torch.bfloat16)


def _library():
    from ._build import load

    lib = load("ssd_intra_chunk")
    lib.ssd_intra_chunk_run.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, *[ctypes.c_int] * 7,
                                        _P]
    lib.ssd_intra_chunk_run.restype = ctypes.c_int
    return lib


def ssd_intra_chunk_call(xc, dtc, dA_cum, Bc, Cc):
    """xc (b, nc, Q, H, P); dtc, dA_cum (b, nc, Q, H); Bc, Cc (b, nc, Q, S),
    all contiguous on one CUDA device: xc, Bc and Cc float32 or bfloat16 (one
    type), dtc float32 or bfloat16, dA_cum float32. Returns y_diag
    (b, nc, Q, H, P) in xc's type and states (b, nc, H, P, S) in float32,
    computed by the CUDA kernels. Raises on CPU tensors, on a type, shape or
    layout the kernel does not take, and on a failed build or launch."""
    name = "ssd_intra_chunk_call"
    dev = xc.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {dev} "
                         "(kernels.ops takes the plain version on the CPU)")
    if any(t.device != dev for t in (dtc, dA_cum, Bc, Cc)):
        raise ValueError(f"{name}: every tensor must be on {dev}")
    if (xc.dtype not in _DTYPES or dtc.dtype not in _DTYPES or dA_cum.dtype != torch.float32
            or Bc.dtype != xc.dtype or Cc.dtype != xc.dtype):
        raise TypeError(f"{name}: xc, Bc, Cc float32 or bfloat16 (one type), dtc float32 or "
                        f"bfloat16, dA_cum float32; got {xc.dtype}, {Bc.dtype}, {Cc.dtype}, "
                        f"{dtc.dtype}, {dA_cum.dtype}")
    if xc.dim() != 5:
        raise ValueError(f"{name}: xc (b, nc, Q, H, P), got {tuple(xc.shape)}")
    b, nc, Q, H, P = xc.shape
    S = Bc.shape[-1]
    if (dtc.shape != (b, nc, Q, H) or dA_cum.shape != (b, nc, Q, H)
            or Bc.shape != (b, nc, Q, S) or Cc.shape != Bc.shape):
        raise ValueError(f"{name}: shapes {tuple(xc.shape)}, {tuple(dtc.shape)}, "
                         f"{tuple(dA_cum.shape)}, {tuple(Bc.shape)}, {tuple(Cc.shape)} do not "
                         "match")
    if not all(t.is_contiguous() for t in (xc, dtc, dA_cum, Bc, Cc)):
        raise ValueError(f"{name}: every tensor must be contiguous")
    y = torch.empty_like(xc)
    states = torch.empty((b, nc, H, P, S), dtype=torch.float32, device=dev)
    if y.numel() == 0 or S == 0:
        return y, states.zero_()
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cb = torch.empty((b * nc, Q, Q), dtype=torch.float32, device=dev)  # C·Bᵀ per chunk
    err = lib.ssd_intra_chunk_run(xc.data_ptr(), dtc.data_ptr(), dA_cum.data_ptr(),
                                  Bc.data_ptr(), Cc.data_ptr(), y.data_ptr(), states.data_ptr(),
                                  cb.data_ptr(), b * nc, Q, H, P, S,
                                  int(xc.dtype == torch.bfloat16),
                                  int(dtc.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"SSD intra-chunk kernel failed: CUDA error {err}")
    launches.n += 1
    return y, states


def ssd_intra_chunk_plain(xc, dtc, dA_cum, Bc, Cc):
    """The plain PyTorch version, on any device: the same arguments; returns
    y_diag (b, nc, Q, H, P) and states (b, nc, H, P, S) in the promoted type
    of the inputs (float32 for the model's)."""
    from ..models.common import einsum

    Q = xc.shape[2]
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = einsum("bnqs,bnks->bnqk", Cc, Bc)
    y_diag = einsum("bnqk,bnqkh,bnkh,bnkhp->bnqhp", cb, decay, dtc, xc)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = einsum("bnks,bnkh,bnkhp->bnhps", Bc, decay_to_end * dtc, xc)
    return y_diag, states
