"""Carry the reference's numbers across to the port.

The tests build a problem once with the JAX package, take its
``StepConsts`` fields and its 7-tuple cohort state, or its ``SchedProblem``
and its scan-engine ``SimState``, or a model's parameter tree, as numpy
arrays, and hand them to both sides with these helpers, so that the
reference and the port compute from the same numbers (a mid-run state
included). Nothing here imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.compact import StepConsts, kernel_layout
from .core.potus import SchedProblem
from .core.queues import SimState

__all__ = ["step_consts_from_numpy", "state_from_numpy", "sched_problem_from_numpy",
           "sim_state_from_numpy", "model_params_from_numpy", "moe_params_from_numpy",
           "opt_state_from_numpy"]

_INT_FIELDS = ("succ_map", "inst_comp", "inst_cont")


def step_consts_from_numpy(fields, *, device="cpu", dtype=torch.float32) -> StepConsts:
    """A port :class:`StepConsts` from the reference's seventeen fields (a
    mapping or a NamedTuple of array-likes), on ``device`` in ``dtype``; the
    index fields become int32, and the kernel's instance layout is derived
    from ``inst_comp``/``inst_cont``."""
    f = fields._asdict() if hasattr(fields, "_asdict") else dict(fields)
    out = {}
    for name in StepConsts._fields[:17]:
        x = np.array(f[name])
        out[name] = torch.as_tensor(
            x, dtype=torch.int32 if name in _INT_FIELDS else dtype, device=device)
    C = np.asarray(f["adj_rows"]).shape[1]
    K = np.asarray(f["U"]).shape[0]
    layout = kernel_layout(np.asarray(f["inst_comp"]), np.asarray(f["inst_cont"]), C, K)
    for name, x in zip(StepConsts._fields[17:], layout):
        out[name] = torch.as_tensor(x, dtype=torch.int32, device=device)
    return StepConsts(**out)


def state_from_numpy(state, *, device="cpu", dtype=torch.float32) -> tuple:
    """The cohort state ``(q_rem, admit, q_in, q_out, transit, resp_mass,
    resp_time)`` as tensors on ``device`` in ``dtype``."""
    return tuple(torch.as_tensor(np.array(x), dtype=dtype, device=device).contiguous()
                 for x in state)


_PROBLEM_DTYPES = {"edge_mask": torch.bool, "inst_comp": torch.int32,
                   "inst_container": torch.int32, "gamma": torch.float32,
                   "comp_count": torch.float32, "is_spout": torch.bool}


def sched_problem_from_numpy(prob, *, device="cpu") -> SchedProblem:
    """A port :class:`SchedProblem` from the reference's (any object with its
    fields as array-likes, plus ``max_succ`` and ``n_components``)."""
    return SchedProblem(
        **{name: torch.as_tensor(np.array(getattr(prob, name)), dtype=dtype, device=device)
           for name, dtype in _PROBLEM_DTYPES.items()},
        max_succ=int(prob.max_succ), n_components=int(prob.n_components))


def sim_state_from_numpy(state, *, device="cpu", dtype=torch.float32) -> SimState:
    """A port :class:`SimState` from the reference's (``q_in``, ``q_rem``,
    ``q_out_bolt``, ``transit`` as array-likes)."""
    return SimState(*(torch.as_tensor(np.array(getattr(state, name)), dtype=dtype,
                                      device=device).contiguous()
                      for name in ("q_in", "q_rem", "q_out_bolt", "transit")))


def _tensor(x, device, dtype) -> torch.Tensor:
    """An array-like as a tensor; numpy's bfloat16 (``ml_dtypes``, what a JAX
    bfloat16 array becomes) is read bit for bit through uint16."""
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device=device, dtype=dtype)


# (reference leaf under "attn"/"mlp", port module, port parameter)
_ATTN_LEAVES = {"wq": ("wq", "weight"), "wk": ("wk", "weight"), "wv": ("wv", "weight"),
                "wo": ("wo", "weight"), "bq": ("wq", "bias"), "bk": ("wk", "bias"),
                "bv": ("wv", "bias")}
# reference Mamba2 leaf -> (port parameter, transposed: an (in, out) matrix to nn.Linear's)
_MAMBA_LEAVES = {"norm": ("norm.weight", False), "in_proj": ("in_proj.weight", True),
                 "conv_w": ("conv_w", False), "conv_b": ("conv_b", False),
                 "A_log": ("A_log", False), "D": ("D", False), "dt_bias": ("dt_bias", False),
                 "gate_norm": ("gate_norm.weight", False), "out_proj": ("out_proj.weight", True)}


def _tf_block(sd, pre, stack, i, t) -> None:
    """Layer ``i`` of a stacked transformer block (``ln1``, ``attn``, ``ln2``,
    and ``mlp`` or ``moe``) into ``sd`` under ``pre``. The MoE leaves
    (``router``, ``w_gate``, ``w_up``, ``w_down``) keep the reference's
    layout; its ``shared`` expert is an MLP and is transposed like one."""
    sd[pre + "ln1.weight"] = t(stack["ln1"][i])
    sd[pre + "ln2.weight"] = t(stack["ln2"][i])
    for leaf, (mod, kind) in _ATTN_LEAVES.items():
        if leaf in stack["attn"]:
            x = t(stack["attn"][leaf][i])
            sd[f"{pre}attn.{mod}.{kind}"] = x.T.contiguous() if kind == "weight" else x
    for leaf, x in stack.get("mlp", {}).items():
        sd[f"{pre}mlp.{leaf}.weight"] = t(x[i]).T.contiguous()
    if "moe" in stack:
        moe = _moe_leaves(stack["moe"], lambda x: t(x[i]))
        sd.update({f"{pre}moe.{name}": x for name, x in moe.items()})


def _moe_leaves(p, t) -> dict:
    """MoE leaves (the reference's ``moe_template`` tree, each leaf taken
    through ``t``) as the port's :class:`MoE` state_dict: router and experts
    as they are, the shared expert's matrices transposed to ``nn.Linear``'s
    (out, in)."""
    sd = {leaf: t(p[leaf]) for leaf in ("router", "w_gate", "w_up", "w_down")}
    for name, w in p.get("shared", {}).items():
        sd[f"shared.{name}.weight"] = t(w).T.contiguous()
    return sd


def moe_params_from_numpy(params, *, device="cpu", dtype=torch.float32) -> dict:
    """The port's :class:`~repro_torch.models.moe.MoE` state_dict from one
    reference MoE layer's parameter dict (array-likes, as
    ``init_params(key, moe_template(cfg), dtype)`` gives them), on
    ``device`` in ``dtype``."""
    return _moe_leaves(params, lambda x: _tensor(x, device, dtype))


def model_params_from_numpy(cfg, params, *, device="cpu", dtype=None) -> dict:
    """The port's ``DenseDecoder`` or ``SSMDecoder`` state_dict from the
    reference's nested parameter dict (array-likes, as
    ``jax.tree.map(np.asarray, params)`` gives them), on ``device`` in
    ``dtype`` (default ``cfg.param_dtype``).

    The stacked ``blocks`` (and a hybrid's ``shared_attn``) leaves (leading
    layer axis, e.g. ``wq`` (L, D, Hq)) are split per layer, and every
    matrix is transposed from the reference's (in, out) to ``nn.Linear``'s
    (out, in); the Mamba2 conv weight (K, channels) is not a linear map and
    keeps its layout, and so do the MoE router and expert tensors. An MoE
    config with ``moe_interleave > 1`` stacks scan units of ``sub{j}``
    blocks: unit ``u``'s ``sub{j}`` becomes layer ``u * moe_interleave + j``.
    An encoder's tree has no ``embed``.

    Any tree of the parameters' structure maps the same way: the
    reference's gradients (``dtype=torch.float32``) onto the port's
    parameter names, or AdamW's moments (:func:`opt_state_from_numpy`)."""
    from .models.common import DTYPES

    dtype = DTYPES[cfg.param_dtype] if dtype is None else dtype
    t = lambda x: _tensor(x, device, dtype)  # noqa: E731
    sd = {"final_norm.weight": t(params["final_norm"])}
    if "embed" in params:
        sd["embed"] = t(params["embed"])
    if "lm_head" in params:
        sd["lm_head.weight"] = t(params["lm_head"]).T.contiguous()
    blocks = params["blocks"]
    per_unit = cfg.moe_interleave if cfg.moe and cfg.moe_interleave > 1 else 1
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        if not cfg.ssm:
            u, j = divmod(i, per_unit)
            _tf_block(sd, pre, blocks[f"sub{j}"] if per_unit > 1 else blocks, u, t)
            continue
        for leaf, (name, transpose) in _MAMBA_LEAVES.items():
            x = t(blocks[leaf][i])
            sd[pre + name] = x.T.contiguous() if transpose else x
    for j in range(cfg.n_shared_attn if cfg.attn_every else 0):
        _tf_block(sd, f"shared_attn.{j}.", params["shared_attn"], j, t)
    return sd


def opt_state_from_numpy(cfg, opt, *, device="cpu", dtype=torch.float32) -> dict:
    """The port's AdamW state (``training.optimizer.init_opt_state``'s
    layout: ``m`` and ``v`` keyed by parameter name, ``step`` an int32
    scalar) from the reference's ``{m, v, step}`` (array-likes), the moments
    in ``dtype`` (the optimizer's ``state_dtype``), so that both sides can
    start from one mid-run state."""
    return dict(m=model_params_from_numpy(cfg, opt["m"], device=device, dtype=dtype),
                v=model_params_from_numpy(cfg, opt["v"], device=device, dtype=dtype),
                step=torch.as_tensor(np.array(opt["step"]), dtype=torch.int32, device=device))
