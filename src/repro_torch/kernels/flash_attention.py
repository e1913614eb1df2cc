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
(the forward's output is not read), with D = rowsum(P·dP) over the
recomputed P and dP in float32, no atomics (two runs are bitwise equal).
Two routes, chosen by :func:`bwd_route` before the launch:

* ``"tc"`` — bfloat16 at head_dim 64, 80 or 128: every product on the
  tensor cores (``mma.sync`` m16n8k16, float32 accumulators). Pass A, a
  block per (64 query rows, query head, request), writes the rows' lse and
  D, then dQ, with dS rounded to bf16 as an operand; pass B, a block per
  (64 keys, query head, request), takes Sᵀ and dPᵀ and accumulates dV and
  dK with Pᵀ and dSᵀ rounded to bf16, each query head's float32 partials
  summed over the G heads of a KV head in ascending order by a third
  kernel (skipped when G = 1). Every pointer and row stride must be 16-byte
  aligned; the wrapper raises otherwise.
  :func:`flash_attention_bwd_tc_plain` states its arithmetic in plain
  PyTorch.
* ``"simt"`` — float32, and bfloat16 at any other head_dim up to
  ``MAX_HEAD_DIM``: two passes on the CUDA cores in float32 (pass A a block
  per query-row tile of a KV head: the row statistics, D and dQ; pass B a
  block per key tile: dK and dV over the G query heads of its KV head).

Its plain version is the autograd gradient of :func:`flash_attention_plain`
(:func:`flash_attention_bwd_plain`), which the tests and ``chip_smoke.py``
compare it with; ``kernels.ops`` never takes it on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import LaunchCounter

__all__ = ["flash_attention_call", "flash_attention_plain", "flash_attention_bwd_call",
           "flash_attention_bwd_plain", "flash_attention_bwd_tc_plain", "route", "bwd_route",
           "launches", "launches_tc", "launches_simt", "launches_bwd", "launches_bwd_tc",
           "launches_bwd_simt", "check_dtype", "MAX_HEAD_DIM", "TC_HEAD_DIMS",
           "BWD_TC_HEAD_DIMS"]

#: launches of either CUDA kernel (one per :func:`flash_attention_call`)
launches = LaunchCounter()
#: launches of the tensor-core kernel, and of the SIMT kernel
launches_tc = LaunchCounter()
launches_simt = LaunchCounter()
#: launches of the backward kernels (one per :func:`flash_attention_bwd_call`, every pass)
launches_bwd = LaunchCounter()
#: launches of the backward's tensor-core route, and of its SIMT route
launches_bwd_tc = LaunchCounter()
launches_bwd_simt = LaunchCounter()

MAX_HEAD_DIM = 256  # the largest NS*32 instantiated in the SIMT kernel
TC_HEAD_DIMS = (64, 128)  # the head dims instantiated in the tensor-core kernel
BWD_TC_HEAD_DIMS = (64, 80, 128)  # those of the backward's tensor-core route
BWD_TC_ROWS = 64  # rows of a tile of the backward's tensor-core passes (BT_ROWS in the source)

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
    lib.flash_attention_bwd_tc_run.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_float, _P]
    lib.flash_attention_bwd_run.restype = lib.flash_attention_bwd_tc_run.restype = ctypes.c_int
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


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a call of this type and head_dim takes: ``"tc"``
    (tensor cores) for bfloat16 at head_dim 64, 80 or 128, ``"simt"``
    otherwise (float32: TF32 would break its 2e-5 limit)."""
    return "tc" if dtype == torch.bfloat16 and head_dim in BWD_TC_HEAD_DIMS else "simt"


def _check_aligned(name, **tensors):
    """Raises unless every pointer and every stride but the last (in bytes)
    of ``tensors`` is a multiple of 16, as the tensor-core kernels' 16-byte
    loads and stores need."""
    misaligned = [key for key, t in tensors.items()
                  if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3])]
    if misaligned:
        raise ValueError(f"{name}: the tensor-core kernel needs 16-byte aligned pointers and "
                         f"strides; {', '.join(misaligned)} is not")


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
        _check_aligned("flash_attention_call", q=q, k=k, v=v)
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
    CUDA backward kernels of the route :func:`bwd_route` names, which
    recompute the attention weights (the forward's output is not needed):
    q, dout (B, Hq, S, D), k, v (B, Hkv, S, D), one type (float32 or
    bfloat16) on one card, the head dimension contiguous (``dout`` is made
    so if it is not), ``k`` and ``v`` with the same strides. The gradients
    come in the inputs' types, laid out (B, S, H, D) in memory like the
    forward's output. Raises on CPU tensors, on what the kernel does not take
    (on the tensor-core route, a pointer or stride that is not 16-byte
    aligned), and on a failed build or launch."""
    dtype = check_dtype("flash_attention_bwd_call", q, k, v, dout)
    B, Hq, Hkv, S, D = _check_shapes("flash_attention_bwd_call", q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_call: dout must be shaped as q "
                         f"{tuple(q.shape)}; got {tuple(dout.shape)}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    kernel = bwd_route(dtype, D)
    dq, dk, dv = _model_layout(B, Hq, S, D, q), _model_layout(B, Hkv, S, D, k), \
        _model_layout(B, Hkv, S, D, k)
    if kernel == "tc":
        _check_aligned("flash_attention_bwd_call", q=q, k=k, v=v, dout=dout, dq=dq, dk=dk, dv=dv)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    strides = torch.tensor([*q.stride()[:3], *k.stride()[:3], *dout.stride()[:3],
                            *dq.stride()[:3], *dk.stride()[:3]], dtype=torch.int64)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the row statistics (lse) and D = rowsum(P * dP) that pass A hands to pass B; the
    # tensor-core passes read them in whole tiles of BWD_TC_ROWS rows
    rows = -(-S // BWD_TC_ROWS) * BWD_TC_ROWS if kernel == "tc" else S
    stats = torch.empty((2, B, Hq, rows), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr())
    shape = (B, Hq, Hkv, S, D, strides.data_ptr(), int(bool(causal)), 1.0 / math.sqrt(D))
    if kernel == "tc":
        # each query head's float32 partial dK and dV, summed over the G heads of a KV head
        part = (torch.empty((2, B, Hq, S, D), dtype=torch.float32, device=q.device)
                if Hq > Hkv else None)
        err = lib.flash_attention_bwd_tc_run(*args, None if part is None else part.data_ptr(),
                                             *shape, stream)
    else:
        err = lib.flash_attention_bwd_run(*args, *shape, int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel ({kernel}) failed: CUDA error {err}")
    launches_bwd.n += 1
    (launches_bwd_tc if kernel == "tc" else launches_bwd_simt).n += 1
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, dout, causal: bool = True):
    """The plain version of the backward: the autograd gradient of
    :func:`flash_attention_plain` at (q, k, v) for ``dout``, on any device.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(out, leaves, dout)


def flash_attention_bwd_tc_plain(q, k, v, dout, causal: bool = True, rounded: bool = True):
    """The arithmetic of the backward's tensor-core route in plain PyTorch,
    on any device: S = q·kᵀ/sqrt(D) masked, lse and P = exp(S - lse),
    dP = dO·vᵀ and D = Σ P·dP in float32, dS = P (dP - D); dQ = dS·k/sqrt(D)
    and, per query head, dK = dSᵀ·q/sqrt(D) and dV = Pᵀ·dO in float32,
    with P and dS rounded to bfloat16 where the kernels round them (as the
    operands of dV, dQ and dK) when ``rounded``; each KV head's dK and dV the
    sum of its G query heads' in ascending g. Returns (dq, dk, dv) in the
    inputs' type, shaped as q, k, v."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, S, D)
    gg = dout.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gg, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if rounded:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk_heads = torch.einsum("bhgqk,bhgqd->bhgkd", ds, qg) * scale
    dv_heads = torch.einsum("bhgqk,bhgqd->bhgkd", p, gg)
    dk, dv = dk_heads[:, :, 0], dv_heads[:, :, 0]
    for g in range(1, G):
        dk, dv = dk + dk_heads[:, :, g], dv + dv_heads[:, :, g]
    return dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
