"""AdamW and its learning-rate schedule — the port's counterpart of
``repro.training.optimizer``, each formula as the reference writes it.

Trees are dicts ``{parameter name: tensor}`` (``dict(model.named_parameters())``).
:func:`adamw_update` updates the parameters and the moments in place (the
reference returns new trees), so the card holds one copy of the weights.
The moments are kept in ``cfg.state_dtype`` (float32 by default) and every
update is computed in float32 and cast back to the parameter's type.

With ``zero_sharding`` (ZeRO-1, the default as in the reference) the
training state's moments are cut over the mesh's ``"data"`` axis by
``distributed.sharding.zero_rules`` (``train_state_shardings`` reads the
field; without it they take the parameters' layout), and over ``"model"``
as their parameters are under tensor-parallel training. Given the moments'
shardings and the parameters' as held, :func:`adamw_update` updates this
rank's moment block of each parameter, the block of the held parameter
that the moments' layout cuts out of it (``Sharding.within``), from its
block of the gradient, by the same per-element arithmetic, then
all-gathers the held parameter back from the blocks; a parameter held as
its moment block (the expert-parallel route's experts, a model-cut leaf
without ZeRO) is updated in place, with no gather. :func:`global_norm`
sums the squares of each leaf's blocks over the axes that cut it and adds
each replicated leaf once. On a mesh of one rank (or without shardings)
both are the one-rank update, bitwise.

Weight decay is decoupled and falls on the tensors the reference decays:
its leaves of two or more axes. The reference stacks each block's leaves
along a leading layer axis, so every parameter under ``blocks.`` or
``shared_attn.`` (norm weights and biases included) is one of them, and of
the others only the matrices (the embedding, the LM head); the final norm
is not.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.context import psum
from ..models.common import DTYPES

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_at", "global_norm", "decays"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    zero_sharding: bool = True


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """``{m, v}``: zeros shaped as each parameter in ``cfg.state_dtype``,
    keyed by name; ``step``: an int32 zero on the parameters' device."""
    dt = DTYPES[cfg.state_dtype]
    device = next(iter(params.values())).device
    return dict(m={n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
                v={n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
                step=torch.zeros((), dtype=torch.int32, device=device))


def _cut(shardings: dict | None, name: str):
    """The sharding of ``name`` when it cuts the tensor over some ranks, else None."""
    sh = None if shardings is None else shardings.get(name)
    return None if sh is None or sh.replicated else sh


def _axes(sh) -> tuple:
    """The mesh axes ``sh`` cuts its tensor over, in the mesh's order."""
    cut = {a for _, names in sh.cuts() for a in names}
    return tuple(a for a in sh.mesh.axis_names if a in cut)


def global_norm(tree: dict, shardings: dict | None = None) -> torch.Tensor:
    """The l2 norm over every tensor of ``tree``, in float32. With
    ``shardings`` (``{name: Sharding}``), a leaf they cut is this rank's
    block: the squares of the blocks are summed over the axes that cut
    them (``"data"``, ``"model"`` or both) and each replicated leaf is
    added once."""
    cut = [n for n in tree if _cut(shardings, n) is not None]
    if not cut:
        return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))
    rest = sum(torch.sum(torch.square(t.float())) for n, t in tree.items() if n not in cut)
    mesh = shardings[cut[0]].mesh
    zero = torch.zeros((), dtype=torch.float32, device=tree[cut[0]].device)
    part: dict[tuple, torch.Tensor] = {}
    for n in cut:
        axes = _axes(shardings[n])
        part[axes] = part.get(axes, zero) + torch.sum(torch.square(tree[n].float()))
    if set(part) - {("data",), ("model",), ("data", "model")}:
        raise ValueError(f"optimizer state cut over the mesh axes {sorted(part)}")
    # the blocks cut over "model" summed over it, then those cut over "data" over that
    both, model = psum(torch.stack([part.get(("data", "model"), zero),
                                    part.get(("model",), zero)]), mesh.axis("model"), "tp")
    data = psum(both + part.get(("data",), zero), mesh.axis("data"), "dp")
    return torch.sqrt(data + model + rest)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay falls on parameter ``name``: its reference leaf
    (with the layer axis of the stacked blocks) has two or more axes."""
    stacked = name.startswith(("blocks.", "shared_attn."))
    return p.dim() + stacked >= 2


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: OptConfig,
                 shardings: dict | None = None, param_shardings: dict | None = None):
    """One AdamW step with global-norm clipping and bias corrections,
    in place. Returns (params, opt_state, metrics) with ``metrics`` the
    gradients' ``grad_norm`` (before clipping) and the step's ``lr``.
    ``shardings``: the moments' (``{name: Sharding}``); a gradient and the
    moments of a parameter they cut are this rank's blocks, and the
    parameter as held (``param_shardings``, None: whole) is all-gathered
    from the blocks after its block's update, unless it is held as that
    block: then it is updated in place."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, shardings)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for name, p in params.items():
        sh = _cut(shardings, name)
        if sh is not None and param_shardings is not None:  # the block within the held one
            sh = sh.within(param_shardings[name])
            sh = None if sh.replicated else sh
        blk = p if sh is None else sh.local(p)
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if decays(name, p):  # decoupled weight decay
            update = update + cfg.weight_decay * blk.float()
        if sh is None:
            p.copy_(p.float() - lr * update)
        else:  # this rank's block, then the held parameter from every rank's
            p.copy_(sh.gather((blk.float() - lr * update).to(p.dtype)))
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return params, opt_state, dict(grad_norm=gnorm, lr=lr)
