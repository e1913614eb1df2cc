"""Decode attention — one query token per request against its KV cache, up
to a per-request position — as hand-written CUDA for Hopper
(``csrc/decode_attention.cu``, with ``csrc/attention.cuh``), and its plain
version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:23``
(``decode_attention_kernel``). One block per (KV head, request), one warp
per grouped query head: the loop reads the cache only up to ``pos[b]``, in
tiles of 32 positions staged in shared memory for all G heads, with the
online softmax in float32 and no atomics (two runs are bitwise equal).

The plain version is ``src/repro/kernels/ref.py:31``
(``decode_attention_reference``); as for flash attention, it casts the
softmax weights to the cache's type before the PV product and the kernel
does not, so bfloat16 agrees within 2e-2 and float32 within 2e-5.

:func:`decode_attention_call` launches the kernel on CUDA tensors and raises
on anything else; there is no fallback. ``kernels.ops.decode_attention``
takes :func:`decode_attention_plain` for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import LaunchCounter
from .flash_attention import MAX_HEAD_DIM, check_dtype

__all__ = ["decode_attention_call", "decode_attention_plain", "launches", "MAX_GROUP"]

#: launches of the CUDA kernel (one per :func:`decode_attention_call`)
launches = LaunchCounter()

MAX_GROUP = 32  # ATT_WARPS * ATT_RPW in the source: query heads per KV head

_P = ctypes.c_void_p


def _library():
    from ._build import load

    lib = load("decode_attention")
    lib.decode_attention_run.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int, _P]
    lib.decode_attention_run.restype = ctypes.c_int
    return lib


def decode_attention_call(q, k_cache, v_cache, pos):
    """q (B, Hq, D); caches (B, S, Hkv, D); pos (B,) int32, the last valid
    position of each request -> (B, Hq, D) in q's type, computed by the CUDA
    kernel. All contiguous. Raises on CPU tensors, on a type, shape or
    layout the kernel does not take, and on a failed build or launch."""
    dtype = check_dtype("decode_attention_call", q, k_cache, v_cache)
    if pos.device != q.device or pos.dtype != torch.int32:
        raise TypeError(f"decode_attention_call: pos must be int32 on {q.device}, got "
                        f"{pos.dtype} on {pos.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention_call: q (B, Hq, D), caches (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != D or pos.shape != (B,) or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"decode_attention_call: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(pos.shape)} do not match")
    if D > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention_call: head_dim at most {MAX_HEAD_DIM} and at most "
                         f"{MAX_GROUP} query heads per KV head, got D={D}, G={Hq // Hkv}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, pos)):
        raise ValueError("decode_attention_call: q, the caches and pos must be contiguous")
    out = torch.empty((B, Hq, D), dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_run(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                   pos.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
                                   1.0 / math.sqrt(D), int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernel failed: CUDA error {err}")
    launches.n += 1
    return out


def decode_attention_plain(q, k_cache, v_cache, pos):
    """The plain PyTorch version, on any device: q (B, Hq, D); caches
    (B, S, Hkv, D); pos (B,) -> (B, Hq, D)."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache).float() / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] <= pos.long()[:, None]  # (B, S)
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhgs,bshd->bhgd", w, v_cache).reshape(B, Hq, D)
