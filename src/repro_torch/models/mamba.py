"""Mamba2 / SSD (state-space duality) blocks in PyTorch [arXiv:2405.21060] —
the port's counterpart of ``repro.models.mamba``.

:class:`Mamba2Block` holds the parameters of the reference's
``mamba_template`` (state_dict names ``norm.weight``, ``in_proj.weight``,
``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``gate_norm.weight``,
``out_proj.weight``); the functions take it as the reference takes its
parameter dict:

  ssd_chunked(x, dt, A, B, C, chunk)            -> y            (chunked SSD)
  ssd_chunked_with_state(x, dt, A, B, C, chunk) -> (y, final state)
  mamba_block(p, x, cfg)                        -> (B, T, D)    (+ states for prefill)
  mamba_decode_step(p, x, cfg, conv_state, ssm_state) -> (y, conv_state, ssm_state)
  mamba_cache_spec(cfg, batch)                  -> the per-layer decode cache

Within a chunk the output is a masked, decay-weighted quadratic form: the
intra-chunk block and each chunk's input state come from
``kernels.ops.ssd_intra_chunk`` (or the namespace passed as ``ops``), which
launches the hand-written CUDA kernel on CUDA tensors and takes its plain
version on CPU tensors. Across chunks a Python loop carries the (H, P, S)
state. The route is chosen by the device, not by ``cfg.use_pallas``: on the
card every ``ssd_chunked`` takes the kernel, the prefill's
``ssd_chunked_with_state`` included (the reference's prefill takes its plain
route there, the same function), so a served SSM model launches the kernel
once per Mamba block per prefill. The plain route is ``kernels.ops.plain``;
its intra-chunk function is the reference's ``use_pallas=False`` einsums
(``mamba.py:91-101``).

The reference's type promotions are kept: ``jnp.einsum`` promotes mixed
operands (``common.einsum`` here), ``dA = dt * A`` is float32 because
``A`` is, the decode caches are float32 and promote the bfloat16
activations they meet, and ``out_proj`` multiplies a float32 ``y`` by the
weight promoted to float32. Softplus is ``logaddexp(x, 0)``, as
``jax.nn.softplus``; the causal conv is the reference's sum of K shifted
products, in its order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import RMSNorm, _ops, einsum, rms_norm

__all__ = ["Mamba2Block", "ssd_chunked", "ssd_chunked_with_state", "mamba_block",
           "mamba_decode_step", "mamba_cache_spec"]


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_headdim, cfg.ssm_state


class Mamba2Block(nn.Module):
    """The parameters of one Mamba2 block (``mamba_template``): the input
    norm, ``in_proj`` to (z, x, B, C, dt), the depthwise conv (``conv_w``
    (K, channels), ``conv_b``), ``A_log``, ``D``, ``dt_bias`` per head, the
    gated norm and ``out_proj``. ``nn.Linear`` weights are (out, in)."""

    def __init__(self, cfg, dtype=None, device=None):
        super().__init__()
        D = cfg.d_model
        d_in, H, P, S = _dims(cfg)
        conv_ch = d_in + 2 * S
        kw = dict(dtype=dtype, device=device)
        self.norm = RMSNorm(D, cfg.norm_eps, **kw)
        self.in_proj = nn.Linear(D, 2 * d_in + 2 * S + H, bias=False, **kw)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, conv_ch, **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, **kw))
        self.A_log = nn.Parameter(torch.ones(H, **kw))
        self.D = nn.Parameter(torch.ones(H, **kw))
        self.dt_bias = nn.Parameter(torch.zeros(H, **kw))
        self.gate_norm = RMSNorm(d_in, cfg.norm_eps, **kw)
        self.out_proj = nn.Linear(d_in, D, bias=False, **kw)


def _split_proj(cfg, zxbcdt):
    d_in, H, P, S = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * S, H], dim=-1)  # z, x_conv, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv1d. x: (B, T, C); w: (K, C)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, A, B, C, chunk: int, *, ops=None):
    """SSD forward. x: (b, T, H, P); dt: (b, T, H); A: (H,) negative;
    B, C: (b, T, S). Returns y: (b, T, H, P).

    Single B/C group shared across heads (ngroups=1, Mamba2 default). A T
    that is not a multiple of ``chunk`` is padded with dt=0 tokens (no state
    contribution), and y is sliced back."""
    b, T, H, P = x.shape
    S = B.shape[-1]
    T0 = T
    if T % chunk:
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        T = T + pad
    nc = T // chunk
    # the kernel takes contiguous tensors: x, B and C are slices of the conv output
    xc = x.reshape(b, nc, chunk, H, P).contiguous()
    dtc = dt.reshape(b, nc, chunk, H).contiguous()
    Bc = B.reshape(b, nc, chunk, S).contiguous()
    Cc = C.reshape(b, nc, chunk, S).contiguous()

    dA = dtc * A  # (b, nc, Q, H) negative increments, float32 as A is
    dA_cum = torch.cumsum(dA, dim=2)
    y_diag, states = _ops(ops).ssd_intra_chunk(xc, dtc, dA_cum, Bc, Cc)

    # cross-chunk recurrence over nc chunks (float32 carry: decay/dt are float32)
    states = states.float()
    chunk_decay = torch.exp(dA_cum[:, :, -1, :]).float()  # (b, nc, H)
    s = torch.zeros((b, H, P, S), dtype=torch.float32, device=x.device)
    s_prevs = []
    for n in range(nc):
        s_prevs.append(s)  # the state entering chunk n
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    s_prevs = torch.stack(s_prevs, dim=1)  # (b, nc, H, P, S)

    in_decay = torch.exp(dA_cum)  # (b, nc, Q, H) decay from chunk start
    y_inter = einsum("bnqs,bnqh,bnhps->bnqhp", Cc, in_decay, s_prevs)
    y = (y_diag + y_inter).reshape(b, T, H, P)
    return y[:, :T0]


def ssd_chunked_with_state(x, dt, A, B, C, chunk: int, *, ops=None):
    """:func:`ssd_chunked` that also returns the final recurrent state
    (b, H, P, S), recomputed in one pass over the sequence as the reference
    does (``model_zoo.py:392``)."""
    y = ssd_chunked(x, dt, A, B, C, chunk, ops=ops)
    # final state = sum_k exp(cumsum_from_k_to_T) dt_k B_k x_k
    dA = dt * A  # (b, T, H)
    dA_total = dA.sum(dim=1, keepdim=True)
    decay_to_end = torch.exp(dA_total - torch.cumsum(dA, dim=1))  # (b, T, H)
    final = einsum("bts,bth,bthp->bhps", B, decay_to_end * dt, x)
    return y, final


def mamba_block(p, x, cfg, *, ops=None, with_state: bool = False):
    """Full Mamba2 block. x: (B, T, D) -> (B, T, D), without the residual.

    ``with_state=True`` (the prefill's ``block_with_state``,
    ``model_zoo.py:345``) also returns the decode cache the block leaves:
    the last ``ssm_conv - 1`` conv inputs and the final SSM state, float32."""
    d_in, H, P, S = _dims(cfg)
    h = p.norm(x)
    zxbcdt = p.in_proj(h)
    z, x_conv, dt = _split_proj(cfg, zxbcdt)
    conv_tail = x_conv[:, -(cfg.ssm_conv - 1):, :]
    x_conv = F.silu(_causal_conv(x_conv, p.conv_w, p.conv_b))
    xs, B_ssm, C_ssm = torch.split(x_conv, [d_in, S, S], dim=-1)
    b, T, _ = xs.shape
    xs = xs.reshape(b, T, H, P)
    dt = _softplus(dt + p.dt_bias)  # (b, T, H)
    A = -torch.exp(p.A_log.float())  # (H,) negative
    if with_state:
        y, final_state = ssd_chunked_with_state(xs, dt, A, B_ssm, C_ssm, cfg.ssm_chunk, ops=ops)
    else:
        y = ssd_chunked(xs, dt, A, B_ssm, C_ssm, cfg.ssm_chunk, ops=ops)
    y = y + xs * p.D[None, None, :, None]
    y = y.reshape(b, T, d_in)
    y = rms_norm(y * F.silu(z), p.gate_norm.weight, cfg.norm_eps)
    out = F.linear(y, p.out_proj.weight.to(y.dtype)).to(x.dtype)
    if with_state:
        return out, conv_tail.float(), final_state
    return out


def mamba_cache_spec(cfg, batch: int):
    """Decode cache per layer, ``(shape, dtype)`` each: the conv window
    (batch, ssm_conv - 1, channels) and the SSM state (batch, H, P, S), both
    float32."""
    d_in, H, P, S = _dims(cfg)
    conv_ch = d_in + 2 * S
    return ((batch, cfg.ssm_conv - 1, conv_ch), torch.float32), ((batch, H, P, S), torch.float32)


def mamba_decode_step(p, x, cfg, conv_state, ssm_state):
    """Single-token step. x: (B, 1, D); returns (y (B, 1, D), new conv state,
    new SSM state), new tensors as in the reference."""
    d_in, H, P, S = _dims(cfg)
    h = p.norm(x)
    zxbcdt = p.in_proj(h)[:, 0]  # (B, proj)
    z, x_conv, dt = _split_proj(cfg, zxbcdt)
    # conv over the cached window + current token (the float32 cache promotes)
    wdt = torch.promote_types(conv_state.dtype, x_conv.dtype)
    win = torch.cat([conv_state.to(wdt), x_conv[:, None, :].to(wdt)], dim=1)  # (B, K, C)
    conv_out = F.silu((win * p.conv_w[None]).sum(dim=1) + p.conv_b)
    new_conv_state = win[:, 1:]
    xs, B_ssm, C_ssm = torch.split(conv_out, [d_in, S, S], dim=-1)
    xs = xs.reshape(-1, H, P)
    dt = _softplus(dt + p.dt_bias)  # (B, H)
    A = -torch.exp(p.A_log.float())
    g = torch.exp(dt * A)  # (B, H)
    # state <- state * g + dt * B x
    upd = einsum("bh,bhp,bs->bhps", dt, xs, B_ssm)
    new_ssm = ssm_state * g[:, :, None, None] + upd
    y = einsum("bhps,bs->bhp", new_ssm, C_ssm) + xs * p.D[None, :, None]
    y = y.reshape(-1, d_in)
    y = rms_norm(y * F.silu(z), p.gate_norm.weight, cfg.norm_eps)
    y = F.linear(y, p.out_proj.weight.to(y.dtype)).to(x.dtype)
    return y[:, None, :], new_conv_state, new_ssm
