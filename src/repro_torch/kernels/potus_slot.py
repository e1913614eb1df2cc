"""The POTUS slot kernel: K slots of the compact cohort step per call, as
hand-written CUDA for Hopper (``csrc/potus_slot.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/potus_slot.py:57``
(``potus_slot_kernel``), which runs ``compact_slot_step(kernel_safe=True)``
for K slots inside one Pallas program with all queue state in VMEM. On the
H100 the state does not fit one SM (``q_out`` alone is 4.5 MB at I=16384,
Atot=69) and the slot needs grid-wide folds in the middle, so the CUDA
version is five kernels per slot on one stream, one warp per instance row
with the lanes across the age axis; the source's header describes them. The
state in is read where it lies and the state out is written by the kernels.

:func:`potus_slot_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. It checks the constants and allocates
the scratch once per (constants, shapes, stream) and keeps them with the
filled argument struct, so a call costs the host little beyond its own
tensors' checks. :func:`potus_slot_step_plain` is the plain PyTorch version
(the port's ``compact_slot_step`` looped over the K slots);
``kernels.ops.potus_slot_step`` takes it for CPU tensors only.

A call takes one scenario or N scenarios of a sweep partition (the
reference runs its kernel under ``jax.vmap``). For N, every state tensor
carries a leading scenario axis, ``consts.V`` and ``consts.beta`` are (N,),
and the arrivals are one (K, I, C) stream that the scenarios share or an
(N, K, I, C) stack; the kernel takes the scenario from its grid, so a call
is 1 + 5K launches whatever N is, and scenario n equals a one-scenario call
bitwise. The metrics come back as (N, K) each. A one-scenario state (no
leading axis, as the tests and ``chip_smoke.py`` give it) runs as a batch of
one and comes back without the axis. Every float reduction of the kernel has
a fixed order, so its runs are bitwise
reproducible; the plain version sums in PyTorch's order, so the two agree
bitwise wherever the sums are exact (the dyadic tier) and to rounding
elsewhere.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from ._build import LaunchCounter

if TYPE_CHECKING:
    from ..core.compact import StepConsts

__all__ = ["potus_slot_call", "potus_slot_step_plain", "launches"]

_SCHED_CODE = {"potus": 0, "shuffle": 1, "jsq": 2}
_MAXC = 64  # POTUS_MAXC in the source


#: launches of the CUDA slot kernel (one per :func:`potus_slot_call`)
launches = LaunchCounter()

_PTR_FIELDS = (
    # constants
    "U", "mu", "inv_service", "sel", "stream", "valid", "succ", "term", "inst_comp",
    "inst_cont", "gamma", "comp_count", "spout", "adj", "V", "beta", "comp_start", "cont_rows",
    "cont_start",
    # arrivals
    "act", "pred", "nxt",
    # state in, state out, metrics
    "q_rem_in", "admit_in", "q_in_in", "q_out_in", "transit_in", "rmass_in", "rtime_in",
    "q_rem", "admit", "q_in", "q_out", "transit", "rmass", "rtime", "met",
    # scratch
    "q_in_arr", "q_out_arr", "must", "M", "J", "usum", "winner", "win_ok", "wpt", "wev",
    "d_land", "served_term", "P_pt", "P_ev", "CM", "land", "land_stamp", "ev_cb", "cmass",
    "part",
    "stream_handle",
)
_INT_FIELDS = ("I", "S", "W1", "C", "NK", "Atot", "L", "age_cap", "n_slots", "t0", "sched",
               "stamp0", "N")
_STATE = ("q_rem", "admit", "q_in", "q_out", "transit", "rmass", "rtime")
_INT_TENSORS = ("succ", "inst_comp", "inst_cont", "comp_start", "cont_rows", "cont_start",
                "J", "winner", "win_ok", "land_stamp")
_PLANS_KEPT = 4


class _Args(ctypes.Structure):
    """ctypes mirror of ``struct PotusSlotArgs`` in ``csrc/potus_slot.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS] + [("xs_stride", ctypes.c_longlong)])


class _Plan:
    """What a call needs besides its state and arrivals, made once per
    (constants, shapes, stream): the checked constants, the scratch tensors
    and the argument struct with their pointers filled in. ``keep`` holds the
    constants and the scratch alive, so the plan's key (the constants' id
    among them) names only this set. ``stamp`` is the last landing stamp used
    (``land_stamp`` starts at 0, stamps at 1)."""

    def __init__(self, args: _Args, keep: dict, dims: tuple, state_shapes: tuple):
        self.args, self.keep, self.dims, self.stamp = args, keep, dims, 0
        self.state_shapes = state_shapes


#: plans by (id of the constants, shapes with N, stream), the newest last
_PLANS: dict = {}


def _library():
    from ._build import load

    lib = load("potus_slot")
    lib.potus_slot_run.argtypes = [ctypes.POINTER(_Args)]
    lib.potus_slot_run.restype = ctypes.c_int
    lib.potus_slot_args_size.argtypes = []
    lib.potus_slot_args_size.restype = ctypes.c_int
    if lib.potus_slot_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("PotusSlotArgs layout differs between potus_slot.cu and its "
                           "ctypes mirror")
    return lib


def _shapes(consts: StepConsts, state, act):
    """The call's dims ``(N, I, S, W1, C, NK, Atot, L)`` from a batched state
    (every tensor with its leading scenario axis); raises on a shape that
    does not fit, naming the tensor."""
    q_rem, admit, q_in, q_out, transit, rmass, rtime = state
    if q_rem.dim() != 4:
        raise ValueError(f"potus slot kernel: q_rem has shape {tuple(q_rem.shape)}, expected "
                         "(N, I, S, W+1)")
    N, I, S, W1 = q_rem.shape
    A = q_in.shape[-1]
    C = consts.adj_rows.shape[1]
    NK = consts.U.shape[0]
    xs = act.shape[-3:] if act.dim() == 4 else act.shape
    want = {
        "q_rem": (q_rem, (N, I, S, W1)), "admit": (admit, (N, I, S)), "q_in": (q_in, (N, I, A)),
        "q_out": (q_out, (N, I, S, A)), "transit": (transit, (N, I, A)),
        "resp_time": (rtime, tuple(rmass.shape)), "act": (act, (*act.shape[:-2], I, C)),
        "V": (consts.V.reshape(-1), (N,)), "beta": (consts.beta.reshape(-1), (N,)),
        "U": (consts.U, (NK, NK)), "mu": (consts.mu, (I,)),
        "inv_service": (consts.inv_service, (I,)), "sel_cmp": (consts.sel_cmp, (I, S)),
        "stream_cmp": (consts.stream_cmp, (I, S)), "valid_cmp": (consts.valid_cmp, (I, S)),
        "succ_map": (consts.succ_map, (I, S)), "term_f": (consts.term_f, (I,)),
        "inst_comp": (consts.inst_comp, (I,)), "inst_cont": (consts.inst_cont, (I,)),
        "gamma": (consts.gamma, (I,)), "comp_count": (consts.comp_count, (C,)),
        "spout_f": (consts.spout_f, (I,)), "adj_rows": (consts.adj_rows, (I, C)),
        "comp_start": (consts.comp_start, (C + 1,)), "cont_rows": (consts.cont_rows, (I,)),
        "cont_start": (consts.cont_start, (NK + 1,)),
    }
    for name, (x, shape) in want.items():
        if x is None:
            raise ValueError(f"potus slot kernel: {name} is missing (build StepConsts with "
                             "the instance layout, see core.compact.kernel_layout)")
        if tuple(x.shape) != shape:
            raise ValueError(f"potus slot kernel: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    if rmass.dim() != 3 or rmass.shape[:2] != (N, C):
        raise ValueError(f"potus slot kernel: resp_mass has shape {tuple(rmass.shape)}, "
                         f"expected ({N}, {C}, L)")
    if act.dim() == 4 and act.shape[0] != N or len(xs) != 3:
        raise ValueError(f"potus slot kernel: act has shape {tuple(act.shape)}, expected "
                         f"(K, I, C) or ({N}, K, I, C)")
    return N, I, S, W1, C, NK, A, rmass.shape[-1]


def _check_tensors(tensors: dict, dev) -> None:
    """Type, layout and device of every tensor the kernel reads or writes."""
    for name, x in tensors.items():
        want = torch.int32 if name in _INT_TENSORS else torch.float32
        if x.dtype != want:
            raise TypeError(f"potus slot kernel: {name} is {x.dtype}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"potus slot kernel: {name} is not contiguous")
        if x.device != dev:
            raise ValueError(f"potus slot kernel: {name} is on {x.device}, expected {dev}")


def _const_tensors(consts: StepConsts) -> dict:
    return {
        "U": consts.U, "mu": consts.mu, "inv_service": consts.inv_service,
        "sel": consts.sel_cmp, "stream": consts.stream_cmp, "valid": consts.valid_cmp,
        "succ": consts.succ_map, "term": consts.term_f, "inst_comp": consts.inst_comp,
        "inst_cont": consts.inst_cont, "gamma": consts.gamma,
        "comp_count": consts.comp_count, "spout": consts.spout_f, "adj": consts.adj_rows,
        "V": consts.V.reshape(-1).to(torch.float32),
        "beta": consts.beta.reshape(-1).to(torch.float32),
        "comp_start": consts.comp_start, "cont_rows": consts.cont_rows,
        "cont_start": consts.cont_start,
    }


def _one_scenario(fn, consts, state, act, pred, nxt, t0, **kw):
    """``fn`` on a one-scenario state, run as a batch of one; the state and
    metrics come back without the scenario axis."""
    s, m = fn(consts, tuple(x.unsqueeze(0) for x in state), act, pred, nxt, t0, **kw)
    return tuple(x[0] for x in s), tuple(x[0] for x in m)


def _plan(consts: StepConsts, state, act, stream_handle, dev) -> _Plan:
    """The cached plan of these constants, shapes and stream; made, with every
    check of the constants, on first use."""
    key = (id(consts), tuple(state[0].shape), state[2].shape[-1], tuple(state[5].shape),
           stream_handle, dev)
    plan = _PLANS.pop(key, None)
    if plan is None:
        dims = _shapes(consts, state, act)
        N, I, S, W1, C, NK, A, L = dims
        if N > 65535:  # the kernels' grid z
            raise ValueError(f"potus slot kernel: at most 65535 scenarios a call, got {N}")
        const = _const_tensors(consts)
        _check_tensors(const, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        scratch = {  # one copy per scenario
            "q_in_arr": torch.empty((N, I), **f32), "q_out_arr": torch.empty((N, I, C), **f32),
            "must": torch.empty((N, I, C), **f32), "M": torch.empty((N, NK, C), **f32),
            "J": torch.empty((N, NK, C), **i32), "usum": torch.empty((N, NK, C), **f32),
            "winner": torch.zeros((N, C), **i32), "win_ok": torch.zeros((N, C), **i32),
            "wpt": torch.empty((N, I, S), **f32), "wev": torch.empty((N, I, S), **f32),
            "d_land": torch.empty((N, I, S, A), **f32),
            "served_term": torch.empty((N, I, A), **f32),
            "P_pt": torch.empty((N, NK, C, A), **f32), "P_ev": torch.empty((N, NK, C, A), **f32),
            "CM": torch.empty((N, NK, C, A), **f32), "land": torch.empty((N, I, A), **f32),
            "land_stamp": torch.zeros((N, I), **i32), "ev_cb": torch.empty((N, C, A), **f32),
            "cmass": torch.empty((N, C, A), **f32), "part": torch.empty((N, 2, I, 4), **f32),
        }
        args = _Args(**{name: x.data_ptr() for name, x in {**const, **scratch}.items()},
                     stream_handle=stream_handle, I=I, S=S, W1=W1, C=C, NK=NK, Atot=A, L=L,
                     N=N)
        plan = _Plan(args, {"consts": consts, **const, **scratch}, dims,
                     tuple(tuple(x.shape) for x in state))
        while len(_PLANS) >= _PLANS_KEPT:
            _PLANS.pop(next(iter(_PLANS)))
    _PLANS[key] = plan  # the newest last
    return plan


def _launch(lib, consts: StepConsts, state, act, pred, nxt, t0: int, scheduler: str,
            age_cap: int, stream_handle):
    """Check the call's own tensors, fill the plan's struct and run the kernel
    on the batch."""
    dev = act.device
    plan = _plan(consts, state, act, stream_handle, dev)
    N, I, S, W1, C, NK, A, L = plan.dims
    stacked = act.dim() == 4
    n = act.shape[-3]
    if (tuple(tuple(x.shape) for x in state) != plan.state_shapes
            or tuple(act.shape[-2:]) != (I, C) or (stacked and act.shape[0] != N)):
        _shapes(consts, state, act)  # raises, naming the tensor
        raise ValueError("potus slot kernel: the state's shapes do not match")
    xs_stride = act.stride(0) if stacked else 0
    if stacked and (pred.stride(0) != xs_stride or nxt.stride(0) != xs_stride):
        raise ValueError("potus slot kernel: act, pred and nxt must share their scenario stride")
    out = tuple(torch.empty_like(x) for x in state)
    met = torch.empty((N, 4, n), dtype=torch.float32, device=dev)
    # a stack is read at its scenario stride: each scenario's (K, I, C) block must be contiguous
    tensors = {"act": act[0] if stacked else act, "pred": pred[0] if stacked else pred,
               "nxt": nxt[0] if stacked else nxt, "met": met}
    for name, x, o in zip(_STATE, state, out):
        tensors[name + "_in"] = x
        tensors[name] = o
    _check_tensors(tensors, dev)
    if plan.stamp + n >= 2 ** 30:  # stamps stay far from the int32 limit
        plan.keep["land_stamp"].zero_()
        plan.stamp = 0
    args = plan.args
    for name, x in tensors.items():
        setattr(args, name, x.data_ptr())
    args.age_cap, args.n_slots, args.t0 = age_cap, n, t0
    args.sched, args.stamp0 = _SCHED_CODE[scheduler], plan.stamp + 1
    args.xs_stride = xs_stride
    err = lib.potus_slot_run(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"potus slot kernel failed: CUDA error {err}")
    plan.stamp += n
    return out, (met[:, 0], met[:, 1], met[:, 2], met[:, 3])


def _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots):
    """The call's arguments (``state`` with its leading scenario axis)."""
    if scheduler not in _SCHED_CODE:
        raise ValueError(f"potus slot kernel: scheduler must be one of {tuple(_SCHED_CODE)}, "
                         f"got {scheduler!r}")
    if age_cap < 2:
        raise ValueError(f"age_cap must be >= 2, got {age_cap}")
    if (act.dim() not in (3, 4) or act.shape[-3] != n_slots or pred.shape != act.shape
            or nxt.shape != act.shape):
        raise ValueError(f"potus slot kernel: act/pred/nxt must be ({n_slots}, I, C) or "
                         f"(N, {n_slots}, I, C), got {tuple(act.shape)}, {tuple(pred.shape)}, "
                         f"{tuple(nxt.shape)}")
    A = state[2].shape[-1]
    if A != age_cap + state[0].shape[-1]:
        raise ValueError(f"potus slot kernel: the age axis has {A} buckets, expected "
                         f"age_cap + W + 1 = {age_cap + state[0].shape[-1]}")
    if t0 < 0 or t0 + n_slots - 1 + A > state[5].shape[-1]:
        raise ValueError(f"potus slot kernel: accumulator columns up to "
                         f"{t0 + n_slots - 1 + A} exceed L={state[5].shape[-1]}")
    if consts.adj_rows.shape[1] > _MAXC:
        raise ValueError(f"potus slot kernel: at most {_MAXC} components, got "
                         f"{consts.adj_rows.shape[1]}")


def potus_slot_call(consts: StepConsts, state, act, pred, nxt, t0: int, *,
                    scheduler: str = "potus", age_cap: int = 64, n_slots: int = 1):
    """Run ``n_slots`` slots of the hand-written CUDA kernel on CUDA tensors,
    for one scenario or a batch of N (see the module's docstring). Returns
    ``(state, (backlog, cost, capped, served))``, each metric ``(n_slots,)``,
    or ``(N, n_slots)`` for a batch; the input state is left untouched.
    Raises on CPU tensors, on a type, shape or layout the kernel does not
    take, and on a failed build or launch."""
    t0 = int(t0)
    if act.device.type != "cuda":
        raise ValueError(f"potus_slot_call launches a CUDA kernel; got tensors on {act.device}")
    if state[0].dim() == 3:
        return _one_scenario(potus_slot_call, consts, state, act, pred, nxt, t0,
                             scheduler=scheduler, age_cap=age_cap, n_slots=n_slots)
    _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots)
    lib = _library()
    stream = torch.cuda.current_stream(act.device).cuda_stream
    result = _launch(lib, consts, state, act, pred, nxt, t0, scheduler, age_cap, stream)
    launches.n += 1
    return result


def _plain_one(consts: StepConsts, state, act, pred, nxt, t0: int, scheduler: str,
               age_cap: int, n_slots: int):
    from ..core.compact import compact_slot_step

    mets = []
    for k in range(n_slots):
        state, met = compact_slot_step(consts, state, (act[k], pred[k], nxt[k], t0 + k),
                                       scheduler=scheduler, age_cap=age_cap,
                                       kernel_safe=True)
        mets.append(met)
    return state, tuple(torch.stack([m[q] for m in mets]) for q in range(4))


def potus_slot_step_plain(consts: StepConsts, state, act, pred, nxt, t0: int, *,
                          scheduler: str = "potus", age_cap: int = 64, n_slots: int = 1):
    """The plain PyTorch version: ``compact_slot_step(kernel_safe=True)`` over
    ``n_slots`` slots, on any device and dtype; a batch runs its scenarios
    one after another and stacks their results."""
    t0 = int(t0)
    if state[0].dim() == 3:
        return _one_scenario(potus_slot_step_plain, consts, state, act, pred, nxt, t0,
                             scheduler=scheduler, age_cap=age_cap, n_slots=n_slots)
    _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots)
    V, beta = consts.V.reshape(-1), consts.beta.reshape(-1)
    outs = []
    for n in range(state[0].shape[0]):
        xs = (act, pred, nxt) if act.dim() == 3 else (act[n], pred[n], nxt[n])
        outs.append(_plain_one(consts._replace(V=V[n], beta=beta[n]),
                               tuple(x[n] for x in state), *xs, t0, scheduler, age_cap,
                               n_slots))
    return (tuple(torch.stack([o[0][q] for o in outs]) for q in range(7)),
            tuple(torch.stack([o[1][q] for o in outs]) for q in range(4)))
