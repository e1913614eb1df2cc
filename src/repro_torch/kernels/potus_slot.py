"""The POTUS slot kernel: K slots of the compact cohort step per call, as
hand-written CUDA for Hopper (``csrc/potus_slot.cu``), and its plain version.

Replaces the TPU kernel ``src/repro/kernels/potus_slot.py:57``
(``potus_slot_kernel``), which runs ``compact_slot_step(kernel_safe=True)``
for K slots inside one Pallas program with all queue state in VMEM. On the
H100 the state does not fit one SM (``q_out`` alone is 4.5 MB at I=16384,
Atot=69) and the slot needs grid-wide folds in the middle, so the CUDA
version is a sequence of eight phase kernels per slot on one stream; the
source's header describes the phases. It is bound by bytes: each phase
streams the (I, ., Atot) queue state once, at a few hundred operations per
row. The state is updated in place in the output buffers after one copy in.

:func:`potus_slot_call` launches the kernel on CUDA tensors and raises on
anything else; there is no fallback. :func:`potus_slot_step_plain` is the
plain PyTorch version (the port's ``compact_slot_step`` looped over the K
slots); ``kernels.ops.potus_slot_step`` takes it for CPU tensors only.
Every float reduction of the kernel has a fixed order, so its runs are
bitwise reproducible; the plain version sums in PyTorch's order, so the two
agree bitwise wherever the sums are exact (the dyadic tier) and to rounding
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
    "inst_cont", "gamma", "comp_count", "spout", "adj", "vb", "comp_start", "cont_rows",
    "cont_start",
    # arrivals
    "act", "pred", "nxt",
    # state in, state out, metrics
    "q_rem_in", "admit_in", "q_in_in", "q_out_in", "transit_in", "rmass_in", "rtime_in",
    "q_rem", "admit", "q_in", "q_out", "transit", "rmass", "rtime", "met",
    # scratch
    "q_in_arr", "q_out_arr", "must", "row_bl", "row_cost", "M", "J", "usum", "winner",
    "win_ok", "shipped", "w_pt", "w_ev", "d_land", "served_term", "P_pt", "P_ev", "CM",
    "land", "ev_cb", "cmass",
    "stream_handle",
)
_INT_FIELDS = ("I", "S", "W1", "C", "NK", "Atot", "L", "age_cap", "n_slots", "t0", "sched")


class _Args(ctypes.Structure):
    """ctypes mirror of ``struct PotusSlotArgs`` in ``csrc/potus_slot.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS])


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
    q_rem, admit, q_in, q_out, transit, rmass, rtime = state
    I, S, W1 = q_rem.shape
    A = q_in.shape[-1]
    C = consts.adj_rows.shape[1]
    NK = consts.U.shape[0]
    want = {
        "q_rem": (q_rem, (I, S, W1)), "admit": (admit, (I, S)), "q_in": (q_in, (I, A)),
        "q_out": (q_out, (I, S, A)), "transit": (transit, (I, A)),
        "resp_time": (rtime, tuple(rmass.shape)), "act": (act, (act.shape[0], I, C)),
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
    if rmass.dim() != 2 or rmass.shape[0] != C:
        raise ValueError(f"potus slot kernel: resp_mass has shape {tuple(rmass.shape)}, "
                         f"expected ({C}, L)")
    return I, S, W1, C, NK, A, rmass.shape[1]


def _launch(lib, consts: StepConsts, state, act, pred, nxt, t0: int, scheduler: str,
            age_cap: int, stream_handle):
    """Fill the argument struct and run the kernel; no device checks here."""
    I, S, W1, C, NK, A, L = _shapes(consts, state, act)
    n = act.shape[0]
    dev = act.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = tuple(torch.empty_like(x) for x in state)
    met = torch.empty((4, n), **f32)
    vb = torch.stack([consts.V.reshape(()), consts.beta.reshape(())]).to(torch.float32)
    scratch = {
        "q_in_arr": torch.empty((I,), **f32), "q_out_arr": torch.empty((I, C), **f32),
        "must": torch.empty((I, C), **f32), "row_bl": torch.empty((2, I), **f32),
        "row_cost": torch.empty((2, I), **f32), "M": torch.empty((NK, C), **f32),
        "J": torch.empty((NK, C), **i32), "usum": torch.empty((NK, C), **f32),
        "winner": torch.zeros((C,), **i32), "win_ok": torch.zeros((C,), **i32),
        "shipped": torch.empty((I, C), **f32), "w_pt": torch.empty((I, C), **f32),
        "w_ev": torch.empty((I, C), **f32), "d_land": torch.empty((I, S, A), **f32),
        "served_term": torch.empty((I, A), **f32), "P_pt": torch.empty((NK, C, A), **f32),
        "P_ev": torch.empty((NK, C, A), **f32), "CM": torch.empty((NK, C, A), **f32),
        "land": torch.empty((I, A), **f32), "ev_cb": torch.empty((C, A), **f32),
        "cmass": torch.empty((C, A), **f32),
    }
    tensors = {
        "U": consts.U, "mu": consts.mu, "inv_service": consts.inv_service,
        "sel": consts.sel_cmp, "stream": consts.stream_cmp, "valid": consts.valid_cmp,
        "succ": consts.succ_map, "term": consts.term_f, "inst_comp": consts.inst_comp,
        "inst_cont": consts.inst_cont, "gamma": consts.gamma,
        "comp_count": consts.comp_count, "spout": consts.spout_f, "adj": consts.adj_rows,
        "vb": vb, "comp_start": consts.comp_start, "cont_rows": consts.cont_rows,
        "cont_start": consts.cont_start, "act": act, "pred": pred, "nxt": nxt,
        "met": met, **scratch,
    }
    for name, x, o in zip(("q_rem", "admit", "q_in", "q_out", "transit", "rmass", "rtime"),
                          state, out):
        tensors[name + "_in"] = x
        tensors[name] = o
    for name, x in tensors.items():
        want = torch.int32 if name in ("succ", "inst_comp", "inst_cont", "comp_start",
                                       "cont_rows", "cont_start", "J", "winner",
                                       "win_ok") else torch.float32
        if x.dtype != want:
            raise TypeError(f"potus slot kernel: {name} is {x.dtype}, expected {want}")
        if not x.is_contiguous():
            raise ValueError(f"potus slot kernel: {name} is not contiguous")
        if x.device != dev:
            raise ValueError(f"potus slot kernel: {name} is on {x.device}, expected {dev}")
    args = _Args(**{name: x.data_ptr() for name, x in tensors.items()},
                 stream_handle=stream_handle, I=I, S=S, W1=W1, C=C, NK=NK, Atot=A, L=L,
                 age_cap=age_cap, n_slots=n, t0=t0, sched=_SCHED_CODE[scheduler])
    err = lib.potus_slot_run(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"potus slot kernel failed: CUDA error {err}")
    return out, (met[0], met[1], met[2], met[3])


def _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots):
    if scheduler not in _SCHED_CODE:
        raise ValueError(f"potus slot kernel: scheduler must be one of {tuple(_SCHED_CODE)}, "
                         f"got {scheduler!r}")
    if age_cap < 2:
        raise ValueError(f"age_cap must be >= 2, got {age_cap}")
    if act.shape[0] != n_slots or pred.shape != act.shape or nxt.shape != act.shape:
        raise ValueError(f"potus slot kernel: act/pred/nxt must be ({n_slots}, I, C), got "
                         f"{tuple(act.shape)}, {tuple(pred.shape)}, {tuple(nxt.shape)}")
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
    """Run ``n_slots`` slots of the hand-written CUDA kernel on CUDA tensors.
    Returns ``(state, (backlog, cost, capped, served))``, each metric
    ``(n_slots,)``; the input state is left untouched. Raises on CPU
    tensors, on a type, shape or layout the kernel does not take, and on a
    failed build or launch."""
    t0 = int(t0)
    if act.device.type != "cuda":
        raise ValueError(f"potus_slot_call launches a CUDA kernel; got tensors on {act.device}")
    _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots)
    lib = _library()
    stream = torch.cuda.current_stream(act.device).cuda_stream
    result = _launch(lib, consts, state, act, pred, nxt, t0, scheduler, age_cap, stream)
    launches.n += 1
    return result


def potus_slot_step_plain(consts: StepConsts, state, act, pred, nxt, t0: int, *,
                          scheduler: str = "potus", age_cap: int = 64, n_slots: int = 1):
    """The plain PyTorch version: ``compact_slot_step(kernel_safe=True)`` over
    ``n_slots`` slots, on any device and dtype."""
    from ..core.compact import compact_slot_step

    t0 = int(t0)
    _check_call(consts, state, act, pred, nxt, t0, scheduler, age_cap, n_slots)
    mets = []
    for k in range(n_slots):
        state, met = compact_slot_step(consts, state, (act[k], pred[k], nxt[k], t0 + k),
                                       scheduler=scheduler, age_cap=age_cap,
                                       kernel_safe=True)
        mets.append(met)
    return state, tuple(torch.stack([m[q] for m in mets]) for q in range(4))
