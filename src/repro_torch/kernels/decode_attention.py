"""Decode attention — one query token per request against its KV cache, up
to a per-request position — as hand-written CUDA for Hopper
(``csrc/decode_attention.cu``, with ``csrc/attention.cuh``), and its plain
version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:23``
(``decode_attention_kernel``). The cache positions are split over blocks
("flash-decoding"): pass 1 gives each block L consecutive positions of one
(request, KV head) for its grouped query heads, staged in their own type by
16-byte ``cp.async``, and writes a float32 partial (m, l, acc) to a
workspace; pass 2 merges each row's valid splits in ascending order. No
position past ``pos[b]`` is read, and nothing is summed with atomics (two
runs are bitwise equal). :func:`decode_split_plan` picks L and the number
of splits from the shapes and the SM count alone, never from ``pos``
(reading it would make the host wait for the card). Pass 1 comes in two
kernels, chosen by the same explicit rule as flash attention
(:func:`repro_torch.kernels.flash_attention.route`), never by a failure:

* ``"tc"`` — bfloat16 at head_dim 64 or 128: the products on the tensor
  cores (``mma.sync`` m16n8k16, float32 accumulators, P rounded to bf16);
* ``"simt"`` — float32 (which keeps its 2e-5 limit) and bfloat16 at any
  other head_dim: float32 dot products on the CUDA cores.

The plain version is ``src/repro/kernels/ref.py:31``
(``decode_attention_reference``); as for flash attention, it casts the
softmax weights to the cache's type before the PV product and the kernels
round them at another point or not at all, so bfloat16 agrees within 2e-2
and float32 within 2e-5.

:func:`decode_attention_call` launches the kernels on CUDA tensors and
raises on anything else; there is no fallback. It counts one launch per
call (two CUDA launches). ``kernels.ops.decode_attention`` takes
:func:`decode_attention_plain` for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import LaunchCounter
from .flash_attention import MAX_HEAD_DIM, check_dtype, route

__all__ = ["decode_attention_call", "decode_attention_plain", "decode_split_plan", "launches",
           "launches_tc", "launches_simt", "MAX_GROUP", "SPLIT_LENGTHS"]

#: calls of the CUDA kernels (one per :func:`decode_attention_call`, which launches two)
launches = LaunchCounter()
#: those calls whose pass 1 ran on the tensor cores, and on the CUDA cores
launches_tc = LaunchCounter()
launches_simt = LaunchCounter()

MAX_GROUP = 32  # DEC_MAX_G in the source: query heads per KV head
SPLIT_LENGTHS = (256, 128, 64)  # the positions per split the plan chooses from, largest first

_P = ctypes.c_void_p


def _library():
    from ._build import load

    lib = load("decode_attention")
    shape = [_P, _P, _P, _P, _P, _P, *[ctypes.c_int] * 7, ctypes.c_float]
    lib.decode_attention_tc_run.argtypes = [*shape, _P]
    lib.decode_attention_simt_run.argtypes = [*shape, ctypes.c_int, _P]
    lib.decode_attention_tc_run.restype = lib.decode_attention_simt_run.restype = ctypes.c_int
    return lib


def decode_split_plan(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """(L, splits): positions per block of pass 1 and the number of blocks
    per (request, KV head), ``splits = ceil(S / L)``. L is the largest of
    :data:`SPLIT_LENGTHS` whose grid of ``B * Hkv * splits`` blocks still
    reaches two per SM, or the smallest where none does."""
    for L in SPLIT_LENGTHS:
        splits = max(1, -(-S // L))
        if B * Hkv * splits >= 2 * n_sm:
            return L, splits
    L = SPLIT_LENGTHS[-1]
    return L, max(1, -(-S // L))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    kernel = route(dtype, D)
    aligned = (q, k_cache, v_cache) if kernel == "tc" else (k_cache, v_cache)
    if D * q.element_size() % 16 or any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("decode_attention_call: the kernel reads 16-byte rows; the caches (and q "
                         "on the tensor cores) must be 16-byte aligned with head_dim a multiple "
                         f"of {16 // q.element_size()}, got D={D}")
    out = torch.empty((B, Hq, D), dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    L, splits = decode_split_plan(B, Hkv, S, _sm_count(q.device))
    ws = torch.empty((B, Hkv, splits, Hq // Hkv, D + 2), dtype=torch.float32, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), ws.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, S, D, L, splits, 1.0 / math.sqrt(D))
    if kernel == "tc":
        err = lib.decode_attention_tc_run(*args, stream)
    else:
        err = lib.decode_attention_simt_run(*args, int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode attention kernels ({kernel}) failed: CUDA error {err}")
    launches.n += 1
    (launches_tc if kernel == "tc" else launches_simt).n += 1
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
