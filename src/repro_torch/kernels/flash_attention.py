"""Flash attention — blockwise online-softmax GQA attention over a full
sequence, causal or bidirectional — as hand-written CUDA for Hopper
(``csrc/flash_attention.cu``, with ``csrc/attention.cuh``), and its plain
version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:24``
(``flash_attention_kernel``). One block per (query-row tile, KV head,
request) holds the G query heads of its KV head, so each K/V tile staged in
shared memory serves all of them; the running (m, l, acc) stay in float32,
the causal loop stops at the block's diagonal, and nothing is summed with
atomics (two runs are bitwise equal). Two kernels, chosen by an explicit
rule before the launch (:func:`route`), never by a failure:

* ``"tc"`` — bfloat16 at head_dim 64 or 128 (every bf16 launch of the
  served models): both products on the tensor cores (``mma.sync`` m16n8k16,
  float32 accumulators), K and V staged in bf16 by ``cp.async`` in a
  two-stage ring, the softmax in registers and P rounded to bf16 as the
  A operand of P·V. Every pointer and row stride must be 16-byte aligned;
  the wrapper raises otherwise.
* ``"simt"`` — float32 (TF32 tensor cores would break its 2e-5 limit), and
  bfloat16 at any other head_dim up to 256: warp-level float32 FMAs, q
  scaled by 1/sqrt(D) before Q Kᵀ, the softmax weights kept in float32.

The plain version is ``src/repro/kernels/ref.py:15``
(``flash_attention_reference``): the full score matrix, masked to -inf, a
float32 softmax whose weights are cast to ``v``'s type before the PV
product. The tensor-core kernel rounds the unnormalised weights to bf16,
the SIMT kernel keeps them in float32 (as the TPU kernel does), so in
bfloat16 kernel and plain version agree within 2e-2; in float32 within
2e-5.

:func:`flash_attention_call` launches a kernel on CUDA tensors and raises
on anything else; there is no fallback. ``kernels.ops.flash_attention``
takes :func:`flash_attention_plain` for CPU tensors only.

The backward pass (``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd_call`)
replaces no TPU kernel: the reference differentiates its plain attention
with XLA. From q, k, v and the output's gradient it computes dQ, dK and dV
in two passes on the CUDA cores in float32 (pass A a block per query-row
tile: the row statistics, D = rowsum(P·dP) over the recomputed P and dP,
and dQ; pass B a block per key tile: dK and dV over the G query heads of
its KV head),
both types and any head_dim up to ``MAX_HEAD_DIM``, no atomics (two runs
are bitwise equal). Its plain version is the autograd gradient of
:func:`flash_attention_plain` (:func:`flash_attention_bwd_plain`), which
the tests and ``chip_smoke.py`` compare it with; ``kernels.ops`` never
takes it on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import LaunchCounter

__all__ = ["flash_attention_call", "flash_attention_plain", "flash_attention_bwd_call",
           "flash_attention_bwd_plain", "route", "launches", "launches_tc", "launches_simt",
           "launches_bwd", "check_dtype", "MAX_HEAD_DIM", "TC_HEAD_DIMS"]

#: launches of either CUDA kernel (one per :func:`flash_attention_call`)
launches = LaunchCounter()
#: launches of the tensor-core kernel, and of the SIMT kernel
launches_tc = LaunchCounter()
launches_simt = LaunchCounter()
#: launches of the backward kernels (one per :func:`flash_attention_bwd_call`, both passes)
launches_bwd = LaunchCounter()

MAX_HEAD_DIM = 256  # the largest NS*32 instantiated in the SIMT kernel
TC_HEAD_DIMS = (64, 128)  # the head dims instantiated in the tensor-core kernel

_P = ctypes.c_void_p
_DTYPES = (torch.float32, torch.bfloat16)


def _library():
    from ._build import load

    lib = load("flash_attention")
    shape = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P, ctypes.c_int, ctypes.c_float]
    lib.flash_attention_tc_run.argtypes = [*shape, _P]
    lib.flash_attention_simt_run.argtypes = [*shape, ctypes.c_int, _P]
    lib.flash_attention_tc_run.restype = lib.flash_attention_simt_run.restype = ctypes.c_int
    return lib


def _bwd_library():
    from ._build import load

    lib = load("flash_attention_bwd")
    lib.flash_attention_bwd_run.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]
    lib.flash_attention_bwd_run.restype = ctypes.c_int
    return lib


def check_dtype(name: str, *tensors) -> torch.dtype:
    """The one floating type of ``tensors`` (float32 or bfloat16), all on one
    CUDA device; raises otherwise."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {dev} "
                         "(kernels.ops takes the plain version on the CPU)")
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name}: every tensor must be {dtype} on {dev}, got {t.dtype} "
                            f"on {t.device}")
    return dtype


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call of this type and head_dim takes: ``"tc"`` (tensor
    cores) for bfloat16 at head_dim 64 or 128, ``"simt"`` otherwise."""
    return "tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS else "simt"


def _check_shapes(name, q, k, v):
    """(B, Hq, Hkv, S, D) of kernel-native q (B, Hq, S, D) and k, v
    (B, Hkv, S, D); raises on shapes or a layout the kernels do not take."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q (B, Hq, S, D), k/v (B, Hkv, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} and {tuple(k.shape)} "
                         "do not match (Hq must be a multiple of Hkv)")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim at most {MAX_HEAD_DIM}, got {D}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride() != k.stride():
        raise ValueError(f"{name}: the head dimension must be contiguous and v must have k's "
                         "strides")
    return B, Hq, Hkv, S, D


def _model_layout(B, H, S, D, like):
    """An empty (B, H, S, D) tensor laid out (B, S, H, D) in memory, so that
    swapping axes 1 and 2 back gives a contiguous tensor."""
    return torch.empty((B, S, H, D), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_attention_call(q, k, v, causal: bool = True):
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) -> (B, Hq, S, D) in q's type,
    computed by the CUDA kernel. Any strides with a contiguous last dimension
    (``k`` and ``v`` with the same strides); the output is laid out
    (B, S, Hq, D) in memory, so that swapping its axes 1 and 2 back gives a
    contiguous tensor. Raises on CPU tensors, on a type, shape or layout the
    kernel does not take, and on a failed build or launch."""
    dtype = check_dtype("flash_attention_call", q, k, v)
    B, Hq, Hkv, S, D = _check_shapes("flash_attention_call", q, k, v)
    kernel = route(dtype, D)
    if kernel == "tc":
        elem = q.element_size()
        misaligned = [name for name, t in (("q", q), ("k", k), ("v", v))
                      if t.data_ptr() % 16 or any(st * elem % 16 for st in t.stride()[:3])]
        if misaligned:
            raise ValueError(f"flash_attention_call: the tensor-core kernel needs 16-byte aligned "
                             f"pointers and strides; {', '.join(misaligned)} is not")
    out = _model_layout(B, Hq, S, D, q)
    if q.numel() == 0:
        return out
    strides = torch.tensor([*q.stride()[:3], *k.stride()[:3], *out.stride()[:3]],
                           dtype=torch.int64)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            strides.data_ptr(), int(bool(causal)), 1.0 / math.sqrt(D))
    if kernel == "tc":
        err = lib.flash_attention_tc_run(*args, stream)
    else:
        err = lib.flash_attention_simt_run(*args, int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({kernel}) failed: CUDA error {err}")
    launches.n += 1
    (launches_tc if kernel == "tc" else launches_simt).n += 1
    return out


def flash_attention_plain(q, k, v, causal: bool = True):
    """The plain PyTorch version, on any device: q (B, Hq, S, D), k/v
    (B, Hkv, S, D) -> (B, Hq, S, D)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bhkd->bhgqd", w, v).reshape(B, Hq, S, D)


def flash_attention_bwd_call(q, k, v, dout, causal: bool = True):
    """The gradients (dq, dk, dv) of :func:`flash_attention_call`'s output
    attention(q, k, v) for the output gradient ``dout``, computed by the
    CUDA backward kernel, which recomputes the attention weights (the
    forward's output is not needed): q, dout (B, Hq, S, D), k, v
    (B, Hkv, S, D), one type (float32 or bfloat16) on one card, the head
    dimension contiguous (``dout`` is made so if it is not), ``k`` and ``v``
    with the same strides. The gradients come in the inputs' types, laid out
    (B, S, H, D) in memory like the forward's output. Raises on CPU tensors,
    on what the kernel does not take, and on a failed build or launch."""
    dtype = check_dtype("flash_attention_bwd_call", q, k, v, dout)
    B, Hq, Hkv, S, D = _check_shapes("flash_attention_bwd_call", q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_call: dout must be shaped as q "
                         f"{tuple(q.shape)}; got {tuple(dout.shape)}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq, dk, dv = _model_layout(B, Hq, S, D, q), _model_layout(B, Hkv, S, D, k), \
        _model_layout(B, Hkv, S, D, k)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # the row statistics (lse) and D = rowsum(P * dP) that pass A hands to pass B
    scratch = torch.empty((2, B, Hq, S), dtype=torch.float32, device=q.device)
    strides = torch.tensor([*q.stride()[:3], *k.stride()[:3], *dout.stride()[:3],
                            *dq.stride()[:3], *dk.stride()[:3]], dtype=torch.int64)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_run(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), B, Hq, Hkv,
        S, D, strides.data_ptr(), int(bool(causal)), 1.0 / math.sqrt(D),
        int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel failed: CUDA error {err}")
    launches_bwd.n += 1
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, dout, causal: bool = True):
    """The plain version of the backward: the autograd gradient of
    :func:`flash_attention_plain` at (q, k, v) for ``dout``, on any device.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)
